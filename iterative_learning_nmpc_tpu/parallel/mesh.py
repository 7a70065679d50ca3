"""Device-mesh parallelism for batched solves and policy training.

The reference has no distributed compute (SURVEY.md §2.4); the scaling
story here is:
- **dp**: thousands of perturbed NMPC instances / rollout seeds sharded over
  the data axis of a `jax.sharding.Mesh` (collectives inserted by XLA),
- policy training data-parallel with replicated parameters and psum'd grads
  (explicit `shard_map` path provided for the collective-controlled variant),
- dataset aggregation via `all_gather` on-device before host write-out
  (DAgger expert relabeling at pod scale).

Multi-host: `initialize_distributed()` wraps `jax.distributed.initialize`;
the same code paths then span hosts over DCN.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _shard_map():
    """jax.shard_map moved out of experimental in v0.8 and renamed check_rep
    to check_vma; resolve whichever exists and normalize the kwarg."""
    import functools, inspect

    try:
        sm = jax.shard_map
    except AttributeError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map as sm

    kw = "check_vma" if "check_vma" in inspect.signature(sm).parameters else "check_rep"

    @functools.wraps(sm)
    def wrapped(f, *, mesh, in_specs, out_specs, check_rep=True):
        return sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **{kw: check_rep})

    return wrapped


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard_batch(mesh: Mesh, tree, axis_name: str = "dp"):
    """Place a batch pytree with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def make_batch_solver(solver, mesh: Mesh, n_iter: int, axis_name: str = "dp"):
    """Jitted batched NMPC solve with the problem axis sharded over the mesh.

    Returns fn(X, U, params) -> Solution where every leaf has a leading batch
    dim sharded over `axis_name`. XLA partitions the vmapped program; the
    Riccati scans stay node-sequential per problem (batch is the parallel
    axis — SURVEY.md §5 long-context note).
    """
    batch_sharding = NamedSharding(mesh, P(axis_name))

    @partial(jax.jit, out_shardings=batch_sharding)
    def solve_batch(X, U, params):
        return jax.vmap(lambda x, u, p: solver.solve(x, u, p, n_iter))(X, U, params)

    return solve_batch


def make_train_step_dp(net, tx, mesh: Mesh, axis_name: str = "dp"):
    """Explicit-collective data-parallel BC train step via shard_map:
    per-shard L1 grads, `psum` across devices, replicated update."""
    shard_map = _shard_map()

    def loss_fn(params, batch_stats, x, y):
        variables = {"params": params}
        if batch_stats is not None:
            variables["batch_stats"] = batch_stats
            out, updates = net.apply(variables, x, train=True, mutable=["batch_stats"])
            return jnp.mean(jnp.abs(out - y)), updates["batch_stats"]
        out = net.apply(variables, x, train=False)
        return jnp.mean(jnp.abs(out - y)), None

    def step(params, batch_stats, opt_state, x, y):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch_stats, x, y
        )
        loss = jax.lax.pmean(loss, axis_name)
        grads = jax.lax.pmean(grads, axis_name)
        if new_stats is not None:
            new_stats = jax.lax.pmean(new_stats, axis_name)
        import optax

        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_stats, opt_state, loss

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P(), P()),
        check_rep=False,
    )
    return jax.jit(smapped)


def shard_by_batch(mesh: Mesh, tree, batch: int, axis_name: str = "dp",
                   batched=None):
    """Shard leaves whose LEADING axis is the batch over the mesh; replicate
    everything else. This is the placement rule for the DAgger data step's
    mixed inputs: per-env x0/v_des/terrain/force windows shard, the nominal
    spec leaves and policy weights replicate.

    `batched` (recommended): a pytree prefix of bools marking which subtrees
    are batch-leading — explicit placement that cannot misfire when a
    replicated leaf coincidentally has shape[0] == batch (e.g. a
    `batch`-wide weight matrix). When omitted, falls back to inferring
    from shape[0] == batch."""
    dp = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())

    def place_infer(x):
        arr = jnp.asarray(x)
        s = dp if (arr.ndim >= 1 and arr.shape[0] == batch) else rep
        return jax.device_put(arr, s)

    if batched is None:
        return jax.tree.map(place_infer, tree)

    def place_marked(is_b, sub):
        return jax.tree.map(
            lambda x: jax.device_put(jnp.asarray(x), dp if is_b else rep), sub
        )

    return jax.tree.map(place_marked, batched, tree,
                        is_leaf=lambda n: isinstance(n, bool))


def all_gather_dataset(mesh: Mesh, local_rows, axis_name: str = "dp"):
    """Gather per-shard dataset rows to every device (DAgger aggregation)."""
    shard_map = _shard_map()

    def gather(x):
        return jax.lax.all_gather(x, axis_name, tiled=True)

    fn = shard_map(
        gather, mesh=mesh, in_specs=P(axis_name), out_specs=P(), check_rep=False
    )
    return jax.jit(fn)(local_rows)


def expert_ratio_psum(mesh: Mesh, is_expert_local, axis_name: str = "dp"):
    """Expert-influence ratio reduced with an explicit psum over the mesh
    (reference metric at `data_collection_locosafedagger.py:219-223`)."""
    shard_map = _shard_map()

    def ratio(mask):
        s = jax.lax.psum(jnp.sum(mask), axis_name)
        n = jax.lax.psum(jnp.asarray(mask.size, jnp.float32), axis_name)
        return s / n

    fn = shard_map(
        ratio, mesh=mesh, in_specs=P(axis_name), out_specs=P(), check_rep=False
    )
    return float(jax.jit(fn)(jnp.asarray(is_expert_local, jnp.float32)))
