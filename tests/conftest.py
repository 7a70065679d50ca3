"""Test configuration: run everything on a virtual 8-device CPU mesh.

Run the suite with `JAX_PLATFORMS=cpu` (set here as well): unit tests check
numerics and sharding semantics on host CPU devices, Pallas kernels run in
interpret mode. Everything that needs the GPU runs in `chip_smoke.py`.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
    setup_compile_cache,
)

setup_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def go2():
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    return go2_spec()


@pytest.fixture(scope="session")
def solo12():
    from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec

    return solo12_spec()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
