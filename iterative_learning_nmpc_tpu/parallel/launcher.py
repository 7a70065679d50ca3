"""Multi-host launch helper (one process per host, jax.distributed).

The reference's cluster story is hydra-submitit single-task SLURM stanzas
(`bc_config.yaml:113-121`); the JAX equivalent is one process per host
joined through `jax.distributed.initialize`, after which every code path in
this framework (mesh solves, dp training, dataset all_gather) spans hosts
transparently.

Usage (per host, e.g. under SLURM/GKE):

    python -m iterative_learning_nmpc_tpu.parallel.launcher \
        --coordinator host0:1234 --num_processes 4 --process_id $RANK \
        -- script.py [args...]

or programmatically: `launch_distributed(main_fn)` reads the standard
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.
The coordinator address, process count and id are always explicit: nothing
on a plain GPU host tells JAX of a cluster.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
from typing import Callable, Optional


def launch_distributed(
    main_fn: Optional[Callable] = None,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize multi-host JAX then run main_fn (or return)."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")

    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )

    if main_fn is not None:
        return main_fn()
    return None


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("script", nargs=argparse.REMAINDER,
                    help="-- script.py [args...] to run after init")
    args = ap.parse_args()

    launch_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    rest = [a for a in args.script if a != "--"]
    if rest:
        sys.argv = rest
        runpy.run_path(rest[0], run_name="__main__")


if __name__ == "__main__":
    main()
