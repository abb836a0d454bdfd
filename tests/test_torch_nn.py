"""Port parity: the MLP of easyhybrid_tpu_torch.models.nn against
easyhybrid_tpu.models.nn, for the 12 activations and the three input-norm
forms, with the JAX weights carried across (float32, rtol=1e-5, atol=1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhybrid_tpu.models import nn as jnn
from easyhybrid_tpu_torch import load_jax_params
from easyhybrid_tpu_torch.models import nn as tnn

RTOL, ATOL = 1e-5, 1e-6
ACTS = sorted(jnn.ACTIVATIONS)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mlp(act, norm, seed=0, in_dim=3, out_dim=2, hidden=(7, 5)):
    """A JAX MLP with random weights and, where it has a norm, random norm
    statistics and affine parameters (the defaults would hide them)."""
    spec = jnn.MLP(in_dim, out_dim, hidden=hidden, activation=act,
                   input_batchnorm=norm)
    params, state = spec.init(jax.random.PRNGKey(seed))
    if norm:
        rng = np.random.default_rng(seed)
        params["norm"] = {
            "scale": jnp.asarray(rng.uniform(0.5, 2.0, in_dim), jnp.float32),
            "bias": jnp.asarray(rng.normal(size=in_dim), jnp.float32),
        }
        state["norm"] = {
            "mean": jnp.asarray(rng.normal(size=in_dim), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 4.0, in_dim), jnp.float32),
        }
    return spec, params, state


def _torch_mlp(spec, params, state):
    mlp = tnn.MLP(spec.in_dim, spec.out_dim, hidden=spec.hidden,
                  activation=spec.activation, input_batchnorm=spec.input_batchnorm)
    load_jax_params(mlp, _np_tree(params), _np_tree(state))
    return mlp


def _x(seed=0, n=33, f=3):
    return (np.random.default_rng(seed).standard_normal((n, f)) * 3).astype(np.float32)


@pytest.mark.parametrize("act", ACTS)
def test_activation_matches_jax(act):
    """Each activation over a wide range: gelu is the tanh form, softplus has
    no identity threshold above 20, leakyrelu has slope 0.01."""
    x = np.linspace(-40, 40, 1601).astype(np.float32)
    want = np.asarray(jnn.get_activation(act)(jnp.asarray(x)))
    got = tnn.get_activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # NaN propagates
    assert np.isnan(tnn.get_activation(act)(torch.tensor([np.nan])).item())


@pytest.mark.parametrize("norm", [False, "static", True])
@pytest.mark.parametrize("act", ACTS)
def test_mlp_matches_jax(act, norm):
    spec, params, state = _jax_mlp(act, norm, seed=ACTS.index(act))
    mlp = _torch_mlp(spec, params, state)
    x = _x(seed=ACTS.index(act))

    want, _ = spec.apply(params, state, jnp.asarray(x), training=False)
    mlp.eval()
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    # one training step: trainable BN normalises with the batch statistics
    # and moves its EMA (biased variance); the static norm never moves
    want_t, new_state = spec.apply(params, state, jnp.asarray(x), training=True)
    mlp.train()
    with torch.no_grad():
        got_t = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RTOL, atol=ATOL)
    if norm:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(mlp.norm, k).numpy(), np.asarray(new_state["norm"][k]),
                rtol=RTOL, atol=ATOL,
            )
        if norm == "static":
            np.testing.assert_array_equal(
                mlp.norm.mean.numpy(), np.asarray(state["norm"]["mean"])
            )


def test_dense_weight_is_transposed():
    """JAX stores (in, out); the port stores torch's (out, in)."""
    spec, params, state = _jax_mlp("tanh", False, in_dim=3, out_dim=4, hidden=(6,))
    mlp = _torch_mlp(spec, params, state)
    w_jax = np.asarray(params["layers"][0]["w"])
    assert w_jax.shape == (3, 6)
    assert tuple(mlp.layers[0].weight.shape) == (6, 3)
    np.testing.assert_array_equal(mlp.layers[0].weight.detach().numpy(), w_jax.T)


def test_load_jax_params_rejects_mismatched_trees():
    spec, params, state = _jax_mlp("tanh", "static")
    mlp = tnn.MLP(3, 2, hidden=(7, 5), activation="tanh", input_batchnorm="static")
    p, s = _np_tree(params), _np_tree(state)
    missing = {**p, "layers": p["layers"][:-1]}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(mlp, missing, s)
    extra = {**p, "spare": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(mlp, extra, s)
    bad = {**p, "layers": [{**p["layers"][0], "w": np.zeros((5, 7), np.float32)}]
           + p["layers"][1:]}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(mlp, bad, s)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(mlp, p, {})


def test_glorot_uniform_bounds_and_generator():
    a = tnn.glorot_uniform(30, 20, generator=torch.Generator().manual_seed(3))
    b = tnn.glorot_uniform(30, 20, generator=torch.Generator().manual_seed(3))
    assert tuple(a.shape) == (20, 30)
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= (6.0 / 50) ** 0.5


def test_lstm_spec_builds_an_lstm_net():
    net = tnn.construct_nn({"lstm": 4}, 2, 1, activation="swish", output_activation="softplus")
    assert isinstance(net, tnn.LSTMNet) and (net.in_dim, net.out_dim, net.hidden_size) == (2, 1, 4)
    assert net.wi.shape == (16, 2) and net.wh.shape == (16, 4) and net.b.shape == (16,)
    assert net.head.weight.shape == (1, 4) and net.head.bias.shape == (1,)
    assert net.output_activation == "softplus" and net.norm is None  # no hidden activation
    assert net(torch.zeros(3, 5, 2)).shape == (3, 5, 1)
    with pytest.raises(ValueError, match="unknown NN spec"):
        tnn.construct_nn({"gru": 4}, 2, 1)
    with pytest.raises(ValueError, match="unknown activation"):
        tnn.get_activation("mish")
