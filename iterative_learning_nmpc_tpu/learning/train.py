"""Behavior-cloning trainer: JAX MLP + optax Adam + L1 loss.

Replaces the torch loop of `Behavior_Cloning/examples/test_train_policy.py:83-264`
and `DAgger/utils/train_locosafedagger.py:34-200`:
- L1 loss, Adam (2e-3 BC / 1e-3 DAgger), batch 1024/256,
- WeightedRandomSampler x5 on OOD samples (`test_train_policy.py:127-134`)
  via an explicit per-sample probability vector,
- 90/10 random split, OOD validation set, checkpoints every `ckpt_every`
  epochs + a final payload carrying the normalization stats,
- warm start from a previous policy (`train_locosafedagger.py:163-167`).

The epoch inner loop is one jitted `lax.scan` over pre-gathered device
batches — the whole epoch runs on-device with a single dispatch.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .database import Database
from .network import init_network, load_policy, save_policy


@dataclass
class TrainConfig:
    input_size: int = 47
    output_size: int = 12
    num_hidden_layer: int = 3
    hidden_dim: int = 512
    batch_norm: bool = True
    dropout_rate: float = 0.0
    learning_rate: float = 2.0e-3
    batch_size: int = 1024
    n_epochs: int = 500
    ckpt_every: int = 10
    val_fraction: float = 0.1
    ood_weight: float = 5.0
    seed: int = 0
    save_dir: str = "./policies"
    run_name: str = "bc"


class BehavioralCloning:
    """Supervised trainer over a Database (reference class name kept)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.metrics = []

    # ------------------------------------------------------------------
    def _make_step(self, net, tx):
        has_dropout = getattr(net, "dropout_rate", 0.0) > 0.0

        def loss_fn(params, batch_stats, x, y, train, rng):
            variables = {"params": params}
            if batch_stats is not None:
                variables["batch_stats"] = batch_stats
            rngs = {"dropout": rng} if (has_dropout and train) else None
            if train and (batch_stats is not None or has_dropout):
                mutable = ["batch_stats"] if batch_stats is not None else []
                out, updates = net.apply(
                    variables, x, train=True, mutable=mutable, rngs=rngs
                )
                new_stats = updates.get("batch_stats", batch_stats)
            else:
                out = net.apply(variables, x, train=False)
                new_stats = batch_stats
            loss = jnp.mean(jnp.abs(out - y))  # L1 (test_train_policy.py:109)
            return loss, new_stats

        def train_epoch(params, batch_stats, opt_state, xb, yb, rng):
            """xb, yb: (n_batches, B, d) pre-gathered batches; one scan."""

            def step(carry, batch):
                params, batch_stats, opt_state, rng = carry
                x, y = batch
                rng, sub = jax.random.split(rng)
                (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, batch_stats, x, y, True, sub
                )
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, new_stats, opt_state, rng), loss

            (params, batch_stats, opt_state, _), losses = jax.lax.scan(
                step, (params, batch_stats, opt_state, rng), (xb, yb)
            )
            return params, batch_stats, opt_state, jnp.mean(losses)

        def eval_loss(params, batch_stats, x, y):
            loss, _ = loss_fn(params, batch_stats, x, y, False,
                              jax.random.PRNGKey(0))
            return loss

        return jax.jit(train_epoch), jax.jit(eval_loss)

    # ------------------------------------------------------------------
    def run(
        self,
        database: Database,
        ood_mask: Optional[np.ndarray] = None,
        val_database: Optional[Database] = None,
        warm_start_path: Optional[str] = None,
        sample_weights: Optional[np.ndarray] = None,
    ) -> str:
        """Train; returns the path of the final policy payload.

        `sample_weights`: explicit per-row sampling weights (length =
        len(database)); overrides the OOD x5 rule. Used e.g. for per-goal
        balanced sampling over a multi-goal aggregate (the measured
        single-policy interference mitigation, docs/TRANSFER.md)."""
        cfg = self.cfg
        X, Y = database.training_arrays()
        n = len(X)
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(n)
        n_val = max(int(n * cfg.val_fraction), 1)
        val_idx, train_idx = perm[:n_val], perm[n_val:]

        # sampling weights: OOD samples x ood_weight (test_train_policy.py:127-134)
        if sample_weights is not None:
            w_train = np.asarray(sample_weights, np.float64)[train_idx]
        else:
            w_train = make_sample_weights(n, ood_mask, cfg.ood_weight)[train_idx]
        p_train = w_train / w_train.sum()

        key = jax.random.PRNGKey(cfg.seed)
        if warm_start_path is not None:
            net, variables, _ = load_policy(warm_start_path)
            # checkpoint net_config must describe the WARM-STARTED net, not
            # this TrainConfig's (possibly different) architecture — else
            # the saved payload reloads with mismatched shapes
            net_config = dict(
                input_size=net.input_size, output_size=net.output_size,
                num_hidden_layer=net.num_hidden_layer,
                hidden_dim=net.hidden_dim, batch_norm=net.batch_norm,
                dropout_rate=net.dropout_rate,
            )
        else:
            net, variables = init_network(
                key, cfg.input_size, cfg.output_size, cfg.num_hidden_layer,
                cfg.hidden_dim, cfg.batch_norm, cfg.dropout_rate,
            )
            net_config = dict(
                input_size=cfg.input_size, output_size=cfg.output_size,
                num_hidden_layer=cfg.num_hidden_layer,
                hidden_dim=cfg.hidden_dim, batch_norm=cfg.batch_norm,
                dropout_rate=cfg.dropout_rate,
            )
        params = variables["params"]
        batch_stats = variables.get("batch_stats")

        tx = optax.adam(cfg.learning_rate)
        opt_state = tx.init(params)
        train_epoch, eval_loss = self._make_step(net, tx)

        Xd, Yd = jnp.asarray(X), jnp.asarray(Y)
        Xval = jnp.asarray(X[val_idx])
        Yval = jnp.asarray(Y[val_idx])
        Xood = Yood = None
        if val_database is not None and len(val_database):
            xo, yo = val_database.training_arrays()
            Xood, Yood = jnp.asarray(xo), jnp.asarray(yo)

        n_batches = max(len(train_idx) // cfg.batch_size, 1)
        norm = database.get_database_mean_std()

        os.makedirs(cfg.save_dir, exist_ok=True)
        final_path = os.path.join(cfg.save_dir, f"policy_{cfg.run_name}_final.pkl")
        t0 = time.time()
        for epoch in range(cfg.n_epochs):
            idx = rng.choice(train_idx, size=(n_batches, cfg.batch_size), p=p_train)
            xb = Xd[jnp.asarray(idx)]
            yb = Yd[jnp.asarray(idx)]
            key, epoch_key = jax.random.split(key)
            params, batch_stats, opt_state, train_loss = train_epoch(
                params, batch_stats, opt_state, xb, yb, epoch_key
            )
            val_loss = eval_loss(params, batch_stats, Xval, Yval)
            rec = dict(
                epoch=epoch,
                train_loss=float(train_loss),
                val_loss=float(val_loss),
                wall=time.time() - t0,
            )
            if Xood is not None:
                rec["ood_val_loss"] = float(eval_loss(params, batch_stats, Xood, Yood))
            self.metrics.append(rec)
            if (epoch + 1) % cfg.ckpt_every == 0 or epoch == cfg.n_epochs - 1:
                variables = {"params": params}
                if batch_stats is not None:
                    variables["batch_stats"] = batch_stats
                ckpt = os.path.join(cfg.save_dir, f"policy_{cfg.run_name}_ep{epoch + 1}.pkl")
                save_policy(ckpt, variables, norm, net_config)

        variables = {"params": params}
        if batch_stats is not None:
            variables["batch_stats"] = batch_stats
        save_policy(final_path, variables, norm, net_config)
        with open(os.path.join(cfg.save_dir, f"metrics_{cfg.run_name}.jsonl"), "w") as f:
            for rec in self.metrics:
                f.write(json.dumps(rec) + "\n")
        return final_path


def make_sample_weights(n: int, ood_mask: Optional[np.ndarray],
                        ood_weight: float) -> np.ndarray:
    """Per-row sampling weights: 1 for in-distribution, `ood_weight` (x5)
    for OOD rows — the reference's WeightedRandomSampler input
    (`test_train_policy.py:127-134`)."""
    weights = np.ones(n)
    if ood_mask is not None:
        weights[np.asarray(ood_mask, bool)] = ood_weight
    return weights


def compute_ood_mask(states: np.ndarray, nominal_states: np.ndarray,
                     traj_times: np.ndarray, nominal_times: np.ndarray,
                     threshold: float = 4.0) -> np.ndarray:
    """OOD split: L2 distance vs the time-aligned nominal state > threshold
    (reference `data_collection_pretrain_omini_vc_policy_1direction_perturbed.py:93-127`)."""
    order = np.argsort(nominal_times)
    nom_t = nominal_times[order]
    nom_s = nominal_states[order]
    idx = np.clip(np.searchsorted(nom_t, traj_times), 0, len(nom_t) - 1)
    d = np.linalg.norm(states - nom_s[idx], axis=-1)
    return d > threshold
