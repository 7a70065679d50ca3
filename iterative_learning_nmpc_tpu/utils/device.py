"""Device guard and comparison helper shared by the GPU entry points
(chip_smoke.py, bench.py): a measurement path that finds no GPU fails, it
never continues on the CPU."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|) — the repo's parity metric (b = reference)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def nvidia_smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return (r.stdout.strip() or r.stderr.strip()).replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def require_gpu() -> dict:
    """Exit with code 2 unless JAX's default backend is a GPU; otherwise
    print and return the device description."""
    import jax
    import jaxlib

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"device guard: JAX default backend is {backend!r}, not 'gpu'",
              file=sys.stderr)
        sys.exit(2)
    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']} jax={jax.__version__} "
          f"jaxlib={jaxlib.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"nvidia-smi: {nvidia_smi_line()}")
    return info
