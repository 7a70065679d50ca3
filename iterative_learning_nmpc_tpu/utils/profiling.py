"""Timing instrumentation (reference `mpc_controller/utils/profiling.py:6-32`).

Same decorator shape as the reference; `print_timings` reports mean/std/max
excluding the first call and the first call separately — on the device the
first call is the XLA compile, exactly the role codegen/compile played for acados.
"""
from __future__ import annotations

import time
from collections import defaultdict
from functools import wraps
from typing import Dict, List


def time_fn(name: str):
    """Append wall-clock ms of each call into ``self.timings[name]`` when the
    object has ``compute_timings`` set."""

    def decorator(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            if not getattr(self, "compute_timings", False):
                return fn(self, *args, **kwargs)
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            dt_ms = (time.perf_counter() - t0) * 1.0e3
            if not hasattr(self, "timings"):
                self.timings = defaultdict(list)
            self.timings[name].append(dt_ms)
            return out

        return wrapper

    return decorator


def print_timings(timings: Dict[str, List[float]]) -> None:
    for name, values in timings.items():
        if not values:
            continue
        first, rest = values[0], values[1:]
        print(f"-- {name}")
        if rest:
            import numpy as np

            arr = np.asarray(rest)
            print(
                f"   mean {arr.mean():.3f} ms | std {arr.std():.3f} ms | "
                f"max {arr.max():.3f} ms | calls {len(rest)}"
            )
        print(f"   first call (compile): {first:.3f} ms")


def summarize_timings(timings: Dict[str, List[float]]) -> Dict[str, Dict[str, float]]:
    """Machine-readable variant for benchmarks."""
    import numpy as np

    out = {}
    for name, values in timings.items():
        if not values:
            continue
        rest = np.asarray(values[1:]) if len(values) > 1 else np.asarray(values)
        out[name] = dict(
            mean_ms=float(rest.mean()),
            std_ms=float(rest.std()),
            max_ms=float(rest.max()),
            first_ms=float(values[0]),
            calls=len(values),
        )
    return out
