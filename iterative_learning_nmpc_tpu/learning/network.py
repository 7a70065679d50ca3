"""Goal-conditioned policy network in plain JAX — replaces the torch MLP
(`Behavior_Cloning/utils/network.py:7-81`): Linear -> [BatchNorm] -> ReLU
stacks with Kaiming (fan-in, ReLU) init, plus the experimental dropout
variant (`network_experimental.py`). Deployed configuration: 47 -> 512x3 -> 12
with batch norm (`RolloutPolicy.py:37,42-47,230-244`).

The module keeps a Flax-style surface — `init(key, x)` returns
`{"params", "batch_stats"}` and `apply(variables, x, train=, mutable=,
rngs=)` — and the parameter tree `Dense_i/{kernel,bias}`,
`BatchNorm_i/{scale,bias}`, `batch_stats/BatchNorm_i/{mean,var}`
(momentum 0.9, eps 1e-5), so the checkpoints in `assets/` load unchanged.

Checkpoints are a pure-python payload {params, batch_stats, norm_policy_input}
saved with pickle — the role of the reference's .pth files
(`test_train_policy.py:204-219`).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

kaiming = jax.nn.initializers.variance_scaling(2.0, "fan_in", "normal")
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class GoalConditionedPolicyNet:
    input_size: int
    output_size: int
    num_hidden_layer: int = 4
    hidden_dim: int = 256
    batch_norm: bool = False
    dropout_rate: float = 0.0

    def init(self, key, x=None, train: bool = False):
        """Variables {"params": ..., "batch_stats": ...} (stats only with
        batch norm); `x` and `train` are accepted for Flax parity."""
        assert self.num_hidden_layer > 0
        dims = ([self.input_size] + [self.hidden_dim] * self.num_hidden_layer
                + [self.output_size])
        keys = jax.random.split(key, len(dims) - 1)
        params, stats = {}, {}
        for i, (k, d_in, d_out) in enumerate(zip(keys, dims[:-1], dims[1:])):
            params[f"Dense_{i}"] = {
                "kernel": kaiming(k, (d_in, d_out), jnp.float32),
                "bias": jnp.zeros((d_out,), jnp.float32),
            }
            if self.batch_norm and i < self.num_hidden_layer:
                params[f"BatchNorm_{i}"] = {
                    "scale": jnp.ones((d_out,), jnp.float32),
                    "bias": jnp.zeros((d_out,), jnp.float32),
                }
                stats[f"BatchNorm_{i}"] = {
                    "mean": jnp.zeros((d_out,), jnp.float32),
                    "var": jnp.ones((d_out,), jnp.float32),
                }
        variables = {"params": params}
        if self.batch_norm:
            variables["batch_stats"] = stats
        return variables

    def apply(self, variables, x, train: bool = False, mutable=False,
              rngs=None):
        """Forward pass. In train mode batch norm normalizes with the batch
        statistics and, when "batch_stats" is in `mutable`, returns
        (out, {"batch_stats": updated running stats}); dropout draws from
        rngs["dropout"]. With any `mutable` the result is (out, updates)."""
        params = variables["params"]
        stats = variables.get("batch_stats", {})
        new_stats = {}
        rng = None if rngs is None else rngs.get("dropout")
        h = x
        for i in range(self.num_hidden_layer):
            d = params[f"Dense_{i}"]
            h = h @ d["kernel"] + d["bias"]
            if self.batch_norm:
                bn = params[f"BatchNorm_{i}"]
                s = stats[f"BatchNorm_{i}"]
                if train:
                    axes = tuple(range(h.ndim - 1))
                    mean = jnp.mean(h, axis=axes)
                    var = jnp.maximum(
                        jnp.mean(jnp.square(h), axis=axes) - mean * mean, 0.0)
                    new_stats[f"BatchNorm_{i}"] = {
                        "mean": BN_MOMENTUM * s["mean"]
                        + (1.0 - BN_MOMENTUM) * mean,
                        "var": BN_MOMENTUM * s["var"]
                        + (1.0 - BN_MOMENTUM) * var,
                    }
                else:
                    mean, var = s["mean"], s["var"]
                h = ((h - mean) * jax.lax.rsqrt(var + BN_EPS) * bn["scale"]
                     + bn["bias"])
            if self.dropout_rate > 0.0 and train:
                rng, sub = jax.random.split(rng)
                keep = jax.random.bernoulli(sub, 1.0 - self.dropout_rate,
                                            h.shape)
                h = jnp.where(keep, h / (1.0 - self.dropout_rate), 0.0)
            h = jax.nn.relu(h)
        d = params[f"Dense_{self.num_hidden_layer}"]
        out = h @ d["kernel"] + d["bias"]
        if mutable is False:
            return out
        updates = {}
        if "batch_stats" in mutable and self.batch_norm:
            updates["batch_stats"] = new_stats if train else stats
        return out, updates


def init_network(
    key,
    input_size: int,
    output_size: int,
    num_hidden_layer: int = 3,
    hidden_dim: int = 512,
    batch_norm: bool = True,
    dropout_rate: float = 0.0,
):
    net = GoalConditionedPolicyNet(
        input_size=input_size,
        output_size=output_size,
        num_hidden_layer=num_hidden_layer,
        hidden_dim=hidden_dim,
        batch_norm=batch_norm,
        dropout_rate=dropout_rate,
    )
    variables = net.init(key, jnp.zeros((1, input_size)), train=False)
    return net, variables


def save_policy(
    path: str,
    variables: Dict[str, Any],
    norm_policy_input: Optional[Sequence] = None,
    net_config: Optional[Dict[str, Any]] = None,
) -> str:
    """Save payload {network weights, normalization stats} — the contract the
    controllers load (`RolloutPolicy.py:237,266-274`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "variables": jax.tree.map(lambda x: jax.device_get(x), variables),
        "norm_policy_input": norm_policy_input,
        "net_config": net_config or {},
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def save_policy_bundle(path: str, entries) -> str:
    """Goal-scheduled policy bundle: `entries` = [(goal_vec, payload_path)].

    Gain scheduling over the commanded velocity: a deployment selects the
    member whose training goal is nearest the commanded v_des (selection
    happens once at controller construction — v_des is constant per
    rollout in the reference protocol, `RolloutPolicy.py` passes one
    v_des per run). Round-4 measured motivation (docs/TRANSFER.md):
    per-goal pure-MuJoCo transfer is near-threshold and single policies
    tip between goals with every retrain, while each goal has a robustly
    validated member checkpoint."""
    bundle = []
    for goal, p in entries:
        with open(p, "rb") as f:
            payload = pickle.load(f)
        bundle.append({"goal": [float(g) for g in goal], "payload": payload,
                       "source": os.path.basename(p)})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"bundle": bundle}, f)
    return path


def make_numpy_apply(path: str, v_des=None):
    """Pure-NUMPY batched policy forward (B, 44+3) -> (B, 12) with the
    payload's normalization folded in. For host loops that should not
    dispatch a device call per 1 kHz step: the batched plant collector's
    policy branch, and the float64 reference for the device forward pass."""
    import numpy as _np

    net, variables, norm = load_policy(path, v_des=v_des)
    if norm is None:
        norm = (_np.zeros(44, _np.float32), _np.ones(44, _np.float32),
                _np.zeros(3, _np.float32), _np.ones(3, _np.float32))
    mu_s, sd_s, mu_g, sd_g = [_np.asarray(x, _np.float64) for x in norm]
    sd_s = _np.where(sd_s > 1e-8, sd_s, 1.0)
    sd_g = _np.where(sd_g > 1e-8, sd_g, 1.0)
    params = jax.tree.map(lambda x: _np.asarray(x, _np.float64),
                          variables["params"])
    stats = jax.tree.map(lambda x: _np.asarray(x, _np.float64),
                         variables.get("batch_stats", {}))

    def apply_fn(x):
        x = _np.asarray(x, _np.float64)
        h = x.copy()
        h[:, 1:44] = (h[:, 1:44] - mu_s[1:]) / sd_s[1:]
        h[:, 44:] = (h[:, 44:] - mu_g) / sd_g
        for i in range(net.num_hidden_layer):
            d = params[f"Dense_{i}"]
            h = h @ d["kernel"] + d["bias"]
            if net.batch_norm:
                b = params[f"BatchNorm_{i}"]
                s = stats[f"BatchNorm_{i}"]
                h = ((h - s["mean"]) / _np.sqrt(s["var"] + 1e-5)
                     * b["scale"] + b["bias"])
            h = _np.maximum(h, 0.0)
        d = params[f"Dense_{net.num_hidden_layer}"]
        return h @ d["kernel"] + d["bias"]

    return apply_fn


def sample_policy_inputs(path: str, n: int, seed: int = 0, v_des=None):
    """(n, 47) float32 policy inputs drawn around the payload's normalization
    stats (normalized inputs ~ N(0, 1); phase column uniform in [0, 1])."""
    import numpy as _np

    _, _, norm = load_policy(path, v_des=v_des)
    rng = _np.random.default_rng(seed)
    z = rng.normal(size=(n, 47))
    if norm is not None:
        mu = _np.concatenate([_np.ravel(norm[0]),
                              _np.broadcast_to(norm[2], (3,))])
        sd = _np.concatenate([_np.ravel(norm[1]),
                              _np.broadcast_to(norm[3], (3,))])
        z = mu + sd * z
    z[:, 0] = rng.uniform(0.0, 1.0, n)
    return z.astype(_np.float32)


def make_policy_apply(path: str, v_des=None):
    """(47,) -> (12,) single-sample apply with the payload's normalization
    folded in (state columns 1: and goal; phase column passes through —
    the contract of `PolicyController.policy_input`). jit/vmap/scan-safe:
    use inside device programs (solver warm starts, device-plant rollouts)."""
    import numpy as _np

    net, variables, norm = load_policy(path, v_des=v_des)
    if norm is None:
        norm = (_np.zeros(44, _np.float32), _np.ones(44, _np.float32),
                _np.zeros(3, _np.float32), _np.ones(3, _np.float32))
    mu_s, sd_s, mu_g, sd_g = [_np.asarray(x, _np.float32) for x in norm]
    sd_s = _np.where(sd_s > 1e-8, sd_s, 1.0)
    sd_g = _np.where(sd_g > 1e-8, sd_g, 1.0)

    def apply_fn(x):
        s, g = x[:44], x[44:]
        s = s.at[1:].set((s[1:] - mu_s[1:]) / sd_s[1:])
        g = (g - mu_g) / sd_g
        return net.apply(variables, jnp.concatenate([s, g])[None],
                         train=False)[0]

    return apply_fn


def load_policy(path: str, v_des=None):
    """Returns (net, variables, norm_policy_input).

    For a goal-scheduled bundle (save_policy_bundle), selects the member
    with the nearest training goal to `v_des`. Loading a bundle WITHOUT a
    goal is ambiguous (which member?) — it warns and falls back to the
    first member, so callers that feed a policy into training warm starts
    (`train.py`, `dagger.py`) don't silently fine-tune an arbitrary
    member."""
    import numpy as _np

    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "bundle" in payload:
        entries = payload["bundle"]
        if v_des is None:
            import warnings

            warnings.warn(
                f"load_policy({os.path.basename(path)}): goal-scheduled "
                f"bundle loaded without v_des — falling back to the first "
                f"member (goal {entries[0]['goal']}). Pass v_des to select "
                "a member explicitly.", stacklevel=2)
            payload = entries[0]["payload"]
        else:
            v = _np.asarray(v_des, _np.float64).reshape(-1)[:3]
            d = [
                float(_np.linalg.norm(
                    _np.asarray(e["goal"], _np.float64)[: len(v)] - v))
                for e in entries
            ]
            payload = entries[int(_np.argmin(d))]["payload"]
    cfg = payload.get("net_config", {})
    net = GoalConditionedPolicyNet(
        input_size=cfg.get("input_size", 47),
        output_size=cfg.get("output_size", 12),
        num_hidden_layer=cfg.get("num_hidden_layer", 3),
        hidden_dim=cfg.get("hidden_dim", 512),
        batch_norm=cfg.get("batch_norm", True),
        dropout_rate=cfg.get("dropout_rate", 0.0),
    )
    return net, payload["variables"], payload.get("norm_policy_input")
