"""Platform plumbing: solver-path selection, optional packages, compile cache,
and the GPU guard of the entry points (all CPU-run)."""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from iterative_learning_nmpc_tpu.mpc.config import (
    check_solver_modes,
    get_quadruped_config,
)
from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver
from iterative_learning_nmpc_tpu.utils import compile_cache
from iterative_learning_nmpc_tpu.utils.device import rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("field, value, removed", [
    ("riccati_mode", "pallas", "Riccati kernel was removed"),
    ("linearize_mode", "dynjac", "Jacobian kernel was removed"),
])
def test_removed_modes_raise(go2, field, value, removed):
    _, opt, cost = get_quadruped_config("trot", "go2")
    bad = copy.deepcopy(opt)
    setattr(bad, field, value)
    with pytest.raises(ValueError, match=removed):
        check_solver_modes(bad)
    with pytest.raises(ValueError, match=removed):
        TrajOptSolver(go2, bad, cost)
    with pytest.raises(ValueError, match=removed):
        dataclasses.replace(opt, **{field: value})


def test_unknown_mode_raises(go2):
    _, opt, cost = get_quadruped_config("trot", "go2")
    opt.riccati_mode = "banded"
    with pytest.raises(ValueError, match="not in"):
        TrajOptSolver(go2, opt, cost)


def test_auto_selection_on_cpu(go2):
    """auto resolves from the observable backend: the XLA scan here (the
    Triton kernel only on a GPU); explicit modes pass through."""
    assert jax.default_backend() == "cpu"
    _, opt, cost = get_quadruped_config("trot", "go2")
    assert opt.riccati_mode == "auto"
    assert TrajOptSolver(go2, opt, cost)._riccati_mode == "sequential"
    for mode in ("sequential", "triton", "associative"):
        o = copy.deepcopy(opt)
        o.riccati_mode = mode
        assert TrajOptSolver(go2, o, cost)._riccati_mode == mode


def test_imports_without_flax_and_h5py():
    """The package, the trainer and the DAgger loops import with flax and
    h5py unavailable (h5py is needed only for HDF5 files)."""
    code = (
        "import sys; sys.modules['flax'] = None; sys.modules['h5py'] = None\n"
        "import iterative_learning_nmpc_tpu\n"
        "from iterative_learning_nmpc_tpu.learning import "
        "network, train, database, dagger, ondevice\n"
        "db = database.Database(limit=10)\n"
        "try:\n"
        "    db.save_as_hdf5('unused.hdf5')\n"
        "except ImportError:\n"
        "    print('lazy-h5py')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "lazy-h5py" in r.stdout


def test_main_path_imports_without_mujoco_and_yaml():
    """chip_smoke.py's modules need neither MuJoCo nor yaml."""
    code = (
        "import sys; sys.modules['mujoco'] = None; sys.modules['yaml'] = None\n"
        "import chip_smoke, bench, __graft_entry__\n"
        "from iterative_learning_nmpc_tpu.mpc import controller\n"
        "from iterative_learning_nmpc_tpu.learning import ondevice, train\n"
        "from iterative_learning_nmpc_tpu.parallel import mesh\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_default_path(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_chip_smoke_refuses_cpu():
    """No accelerator: non-zero exit and no result line."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_rel_err_helper():
    ref = np.array([[0.0, 10.0], [-3.0, 1.0]])
    assert rel_err(ref, ref) == 0.0
    got = ref + np.array([[1e-3, 0.0], [0.0, -2e-3]])
    # normalized by (1 + |ref|): 1e-3 / 1 and 2e-3 / 2
    assert rel_err(got, ref) == pytest.approx(1e-3)
    assert rel_err(np.float32(1.5), 1.0) == pytest.approx(0.25)
