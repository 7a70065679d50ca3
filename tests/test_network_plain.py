"""Plain-JAX policy MLP: checkpoint compatibility, parameter tree, batch norm."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.learning.network import (
    BN_EPS,
    BN_MOMENTUM,
    init_network,
    load_policy,
    make_numpy_apply,
    make_policy_apply,
    sample_policy_inputs,
)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")


@pytest.mark.parametrize("name", [
    "policy_go2_trot_envelope.pkl",
    "policy_go2_trot_host_bc.pkl",
    "policy_go2_trot_inplant_dagger.pkl",
    "policy_go2_trot_ondevice_dagger.pkl",
])
def test_shipped_policy_matches_numpy_forward(name):
    """Each checkpoint in assets/ loads into the JAX MLP unchanged and its
    forward pass matches the float64 numpy forward."""
    path = os.path.join(ASSETS, name)
    v_des = np.array([0.3, 0.0, 0.0])
    x = sample_policy_inputs(path, 64, seed=0, v_des=v_des)
    a_dev = np.asarray(jax.jit(jax.vmap(make_policy_apply(path, v_des)))(x))
    a_np = make_numpy_apply(path, v_des)(x)
    assert a_dev.shape == (64, 12)
    err = np.max(np.abs(a_dev - a_np) / (1.0 + np.abs(a_np)))
    assert err <= 1e-4, err


def test_init_tree_names_and_shapes():
    net, variables = init_network(jax.random.PRNGKey(0), 47, 12,
                                  num_hidden_layer=3, hidden_dim=512,
                                  batch_norm=True)
    shapes = jax.tree.map(lambda a: tuple(a.shape), variables)
    expect_params = {f"Dense_{i}": {"kernel": (d_in, d_out), "bias": (d_out,)}
                     for i, (d_in, d_out) in enumerate(
                         [(47, 512), (512, 512), (512, 512), (512, 12)])}
    for i in range(3):
        expect_params[f"BatchNorm_{i}"] = {"scale": (512,), "bias": (512,)}
    assert shapes["params"] == expect_params
    assert shapes["batch_stats"] == {
        f"BatchNorm_{i}": {"mean": (512,), "var": (512,)} for i in range(3)}
    # Kaiming fan-in normal init: std sqrt(2 / fan_in)
    k1 = np.asarray(variables["params"]["Dense_1"]["kernel"])
    assert abs(k1.std() / np.sqrt(2.0 / 512) - 1.0) < 0.05
    # same tree as the shipped checkpoints
    _, shipped, _ = load_policy(os.path.join(
        ASSETS, "policy_go2_trot_host_bc.pkl"))
    assert jax.tree.structure(shipped) == jax.tree.structure(
        jax.tree.map(np.asarray, variables))


def test_train_mode_batch_stats_update_matches_formula():
    net, variables = init_network(jax.random.PRNGKey(1), 5, 3,
                                  num_hidden_layer=2, hidden_dim=8,
                                  batch_norm=True)
    x = jax.random.normal(jax.random.PRNGKey(2), (16, 5))
    out, upd = net.apply(variables, x, train=True, mutable=["batch_stats"])
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), variables["params"])
    h = np.asarray(x, np.float64)
    for i in range(2):
        h = h @ p[f"Dense_{i}"]["kernel"] + p[f"Dense_{i}"]["bias"]
        mean, var = h.mean(0), h.var(0)
        s = upd["batch_stats"][f"BatchNorm_{i}"]
        # running stats start at (0, 1): new = m * old + (1 - m) * batch
        np.testing.assert_allclose(s["mean"], (1 - BN_MOMENTUM) * mean,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            s["var"], BN_MOMENTUM + (1 - BN_MOMENTUM) * var,
            rtol=1e-4, atol=1e-6)
        # train mode normalizes with the batch statistics
        h = ((h - mean) / np.sqrt(var + BN_EPS) * p[f"BatchNorm_{i}"]["scale"]
             + p[f"BatchNorm_{i}"]["bias"])
        h = np.maximum(h, 0.0)
    h = h @ p["Dense_2"]["kernel"] + p["Dense_2"]["bias"]
    np.testing.assert_allclose(np.asarray(out), h, rtol=1e-4, atol=1e-5)


def test_mutable_and_dropout_surface():
    """mutable=[] returns (out, {}) and dropout draws from rngs['dropout']
    in train mode only (the trainer's dropout-only branch)."""
    net, variables = init_network(jax.random.PRNGKey(0), 6, 2,
                                  num_hidden_layer=2, hidden_dim=16,
                                  batch_norm=False, dropout_rate=0.5)
    x = jnp.ones((4, 6))
    out, upd = net.apply(variables, x, train=True, mutable=[],
                         rngs={"dropout": jax.random.PRNGKey(3)})
    assert upd == {} and out.shape == (4, 2)
    out2, _ = net.apply(variables, x, train=True, mutable=[],
                        rngs={"dropout": jax.random.PRNGKey(4)})
    assert not np.allclose(np.asarray(out), np.asarray(out2))
    e1 = net.apply(variables, x, train=False)
    e2 = net.apply(variables, x, train=False)
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
