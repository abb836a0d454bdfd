"""Port parity of the sequence-training path: ``LSTMNet``, the hybrid forward
on ``(N, T, F)`` windows, the masked loss over the trailing output window,
the torch epoch and ``train(sequence_kwargs=...)`` of easyhybrid_tpu_torch
against easyhybrid_tpu, with the JAX parameters carried across
(``load_jax_params``) and the JAX permutations injected.

Tolerances, float32: forwards and losses rtol 1e-5, atol 1e-5 (a window is a
chain of ``T`` cells, each a few ulp apart between XLA's and torch's tanh and
sigmoid); parameters after a few epochs atol 5e-5, rtol 5e-4, as
tests/test_fused.py holds the JAX kernel against the JAX epoch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.data.prepare import HybridData as JaxHybridData
from easyhybrid_tpu.losses.compute import compute_loss as jax_compute_loss
from easyhybrid_tpu.models import nn as jnn
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu.training.epoch import make_train_epoch as jax_train_epoch
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.data.sequences import split_into_sequences
from easyhybrid_tpu_torch.losses.compute import compute_loss
from easyhybrid_tpu_torch.models import nn as tnn
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer

RTOL, ATOL = 1e-5, 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lstm(norm, out_act, seed=0, in_dim=3, out_dim=2, hidden=5):
    """A JAX LSTMNet with random weights, a non-zero bias and, where it has a
    norm, random statistics and affine parameters (the defaults hide them)."""
    spec = jnn.LSTMNet(in_dim, out_dim, hidden_size=hidden, output_activation=out_act,
                       input_batchnorm=norm)
    params, state = spec.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params["b"] = jnp.asarray(rng.normal(size=4 * hidden) * 0.3, jnp.float32)
    if norm:
        params["norm"] = {"scale": jnp.asarray(rng.uniform(0.5, 2.0, in_dim), jnp.float32),
                          "bias": jnp.asarray(rng.normal(size=in_dim), jnp.float32)}
        state["norm"] = {"mean": jnp.asarray(rng.normal(size=in_dim), jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 4.0, in_dim), jnp.float32)}
    return spec, params, state


def _torch_lstm(spec, params, state):
    net = tnn.LSTMNet(spec.in_dim, spec.out_dim, hidden_size=spec.hidden_size,
                      output_activation=spec.output_activation,
                      input_batchnorm=spec.input_batchnorm)
    et.load_jax_params(net, _np_tree(params), _np_tree(state))
    return net


def _windows(seed=0, n=9, steps=7, f=3):
    return (np.random.default_rng(seed).standard_normal((n, steps, f)) * 2).astype(np.float32)


@pytest.mark.parametrize("out_act", ["identity", "softplus"])
@pytest.mark.parametrize("norm", [False, "static", True])
def test_lstm_forward_matches_jax(norm, out_act):
    spec, params, state = _jax_lstm(norm, out_act)
    net = _torch_lstm(spec, params, state).eval()
    x = _windows()
    want, _ = spec.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (9, 7, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_lstm_training_mode_uses_batch_statistics_over_batch_and_time():
    spec, params, state = _jax_lstm(True, "identity", seed=3)
    net = _torch_lstm(spec, params, state).train()
    x = _windows(seed=3)
    want, new_state = spec.apply(params, state, jnp.asarray(x), training=True)
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(net.norm.mean.numpy(), np.asarray(new_state["norm"]["mean"]),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(net.norm.var.numpy(), np.asarray(new_state["norm"]["var"]),
                               rtol=RTOL, atol=1e-6)


def test_lstm_layout_gate_order_and_initialisation():
    net = tnn.construct_nn({"lstm": 4}, 2, 3, output_activation="sigmoid",
                           input_batchnorm="static", generator=torch.Generator().manual_seed(0))
    assert isinstance(net, tnn.LSTMNet) and net.hidden_size == 4
    assert net.wi.shape == (16, 2) and net.wh.shape == (16, 4) and net.b.shape == (16,)
    assert net.head.weight.shape == (3, 4) and net.head.activation == "sigmoid"
    assert net.norm is not None and net.norm.frozen
    assert float(net.b.detach().abs().max()) == 0.0
    # Glorot over the (F, 4H) and (H, 4H) matrices
    assert float(net.wi.detach().abs().max()) <= np.sqrt(6.0 / (2 + 16))
    assert float(net.wh.detach().abs().max()) <= np.sqrt(6.0 / (4 + 16))
    # the forget gate is rows H:2H: a large bias there keeps c, so h follows c0 = 0
    with torch.no_grad():
        net.b[4:8] = 50.0
        net.b[0:4] = -50.0  # input gate shut
        out = net.eval()(torch.randn(2, 5, 2))
        want = torch.sigmoid(net.head.bias).expand(2, 5, 3)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


def test_lstm_refuses_other_ranks_and_compute_dtype():
    net = tnn.LSTMNet(2, 1, hidden_size=3)
    with pytest.raises(ValueError, match=r"expects \(batch, time, features\)"):
        net(torch.zeros(4, 2))
    with pytest.raises(ValueError, match="compute_dtype is not supported"):
        tnn.construct_nn({"lstm": 4}, 2, 1, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown NN spec"):
        tnn.construct_nn({"gru": 4}, 2, 1)


@pytest.mark.parametrize("norm", [False, "static"])
def test_load_export_round_trip(norm):
    spec, params, state = _jax_lstm(norm, "identity", seed=5)
    net = _torch_lstm(spec, params, state)
    assert net.wi.shape == (20, 3) and params["wi"].shape == (3, 20)  # one transpose
    got_p, got_s = et.export_jax_params(net)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(_np_tree(params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(_np_tree(state))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(got_p) == jax.tree.structure(_np_tree(params))


def test_load_refuses_a_wrong_shape_and_a_missing_leaf():
    spec, params, state = _jax_lstm(False, "identity")
    net = tnn.LSTMNet(3, 2, hidden_size=5)
    bad = _np_tree(params)
    bad["wi"] = bad["wi"].T  # already (4H, F): the transpose must not be applied twice
    with pytest.raises(ValueError, match="leaf 'wi' has shape"):
        et.load_jax_params(net, bad, _np_tree(state))
    missing = _np_tree(params)
    del missing["head"]["b"]
    with pytest.raises(ValueError, match="missing"):
        et.load_jax_params(net, missing, _np_tree(state))


# --------------------------------------------------------------------------
# the hybrid over windows
# --------------------------------------------------------------------------

def _spec(norm="static", hidden=4, **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(kw)
    return spec


def setup(norm="static", n=260, batch=64, steps=6, out_steps=2, nan_frac=0.1, hidden=4, **kw):
    """The same model in both packages from the JAX initial parameters, and
    the same windows as epoch tensors of both."""
    spec = _spec(norm, hidden, **kw)
    jm = eh.construct_hybrid_model(**spec)
    tm = et.construct_hybrid_model(**spec, device="cpu")
    cols = et.rbq10_columns(n, seed=21, nan_frac=nan_frac)
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    data = split_into_sequences(rows, input_window=steps, output_window=out_steps)
    jdata = JaxHybridData(x=data.x, forcing=data.forcing, y=data.y)
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        state = jax_fit_input_norm(jm, state, jdata)
    et.load_jax_params(tm, _np_tree(params), _np_tree(state))
    jt = jax.device_put(jax_epoch_tensors(jdata, batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt, data


def jax_perms(shuffle, key, epochs, nb, batch):
    if not shuffle or nb == 1:
        return None
    n = nb * batch if shuffle is True else nb
    keys = [key] if epochs == 1 else list(jax.random.split(key, epochs))
    return np.stack([np.asarray(jax_permutation(k, n)) for k in keys])


def test_hybrid_forward_on_windows_matches_jax():
    jm, params, state, jt, tm, tt, data = setup()
    x, forcing = data.x[:20], {"ta": data.forcing["ta"][:20]}
    want, _ = jm.apply(params, state, (jnp.asarray(x), {"ta": jnp.asarray(forcing["ta"])}))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), {"ta": torch.from_numpy(forcing["ta"])})
    assert got["reco"].shape == (20, 6) and got["parameters"]["rb"].shape == (20, 6)
    np.testing.assert_allclose(got["reco"].numpy(), np.asarray(want["reco"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["parameters"]["rb"].numpy(),
                               np.asarray(want["parameters"]["rb"]), rtol=RTOL, atol=ATOL)
    assert got["parameters"]["Q10"].shape == (1,)


def test_fit_input_norm_flattens_windows_to_rows():
    _, _, state, _, tm, _, data = setup()
    et.fit_input_norm(tm, data)
    flat = data.x.reshape(-1, 2)
    np.testing.assert_allclose(tm.nn.norm.mean.numpy(), flat.mean(0), rtol=1e-6)
    np.testing.assert_allclose(tm.nn.norm.var.numpy(), flat.var(0), rtol=1e-5)
    np.testing.assert_allclose(tm.nn.norm.mean.numpy(), np.asarray(state["nn"]["norm"]["mean"]),
                               rtol=1e-6)


@pytest.mark.parametrize("loss", ["mse", "mae", "nseLoss"])
@pytest.mark.parametrize("out_steps", [1, 2])
def test_masked_loss_over_the_trailing_window_matches_jax(out_steps, loss):
    jm, params, state, jt, tm, tt, _ = setup(out_steps=out_steps, nan_frac=0.2)
    jll = eh.LoggingLoss(training_loss=loss, loss_types=(loss, "mse"), train_mode=True)
    tll = et.LoggingLoss(training_loss=loss, loss_types=(loss, "mse"), train_mode=True)
    jbatch = ((jt.x[0], {"ta": jt.forcing["ta"][0]}), ({"reco": jt.y["reco"][0]},
                                                        {"reco": jt.mask["reco"][0]}))
    tbatch = ((tt.x[0], {"ta": tt.forcing["ta"][0]}), ({"reco": tt.y["reco"][0]},
                                                        {"reco": tt.mask["reco"][0]}))
    assert tt.y["reco"].shape[2] == out_steps and tt.forcing["ta"].shape[2] == 6
    want, _ = jax_compute_loss(jm, params, state, jbatch, jll)
    got = compute_loss(tm, tbatch, tll)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    jm_metrics = jax_compute_loss(jm, params, state, jbatch,
                                  dataclasses.replace(jll, train_mode=False))[0]
    tm_metrics, outputs = compute_loss(tm, tbatch, dataclasses.replace(tll, train_mode=False))
    assert outputs["reco"].shape == (64, 6)  # the outputs keep the whole input window
    for name in (loss, "mse"):
        np.testing.assert_allclose(float(tm_metrics[name]["reco"]),
                                   float(jm_metrics[name]["reco"]), rtol=RTOL)


@pytest.mark.parametrize("opt,shuffle,norm", [
    (("adam", 0.01), False, "static"),
    (("sgd", 0.05), False, "static"),
    (("sgd", 0.005), False, False),
    (("adam", 0.01), True, "static"),
    (("adam", 0.01), False, True),
])
def test_torch_epoch_matches_the_jax_epoch(opt, shuffle, norm):
    """Three epochs from the JAX initial parameters with the JAX permutations.
    Without an input norm the raw predictors (hundreds) saturate the gates
    and a large step makes the run chaotic: there ulp differences grow past
    any tolerance within three epochs in both packages alike, so that case
    takes a small learning rate."""
    jm, params, state, jt, tm, tt, _ = setup(norm)
    epochs = 3
    key = jax.random.PRNGKey(4)
    jll = eh.LoggingLoss(training_loss="mse", loss_types=("mse",))
    joptim = optax.flatten(optax.adam(opt[1]) if opt[0] == "adam" else optax.sgd(opt[1]))
    jfn = jax_train_epoch(jm, jll, joptim, shuffle=shuffle, epochs_per_call=epochs)
    jp, _, js, jloss = jfn(jax.tree.map(jnp.array, params), joptim.init(params),
                           jax.tree.map(jnp.array, state), jt, key)
    optim = resolve_optimizer(opt)
    nb, batch = tt.weight.shape
    tfn = tepoch.make_train_epoch(tm, et.LoggingLoss(training_loss="mse", loss_types=("mse",)),
                                  optim, shuffle=shuffle, epochs_per_call=epochs)
    _, tloss = tfn(optim.init(dict(tm.named_parameters())), tt,
                   perm=jax_perms(shuffle, key, epochs, nb, batch))
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(js)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)


# --------------------------------------------------------------------------
# train(sequence_kwargs=...)
# --------------------------------------------------------------------------

SEQ = dict(input_window=6, output_window=2, lead_time=0)


def test_train_on_windows_with_trainable_batchnorm_runs_the_torch_engine():
    tm = et.construct_hybrid_model(**_spec(True, 8), generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    r = et.train(tm, et.rbq10_columns(300, seed=11), nepochs=2, batchsize=32,
                 show_progress=False, sequence_kwargs=dict(input_window=8, output_window=2,
                                                           lead_time=0), use_kernel=True)
    assert np.isfinite(r.best_loss)
    assert r.epoch_path == "torch" and "trainable input BatchNorm" in r.engine_reason
    assert not torch.equal(tm.nn.norm.mean, torch.zeros(2))  # the running statistics moved


def test_train_on_windows_gives_long_format_frames():
    tm = et.construct_hybrid_model(**_spec(False, 4), generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    cols = et.rbq10_columns(200, seed=9)
    r = et.train(tm, cols, nepochs=1, batchsize=16, show_progress=False, sequence_kwargs=SEQ)
    assert r.epoch_path == "torch"
    assert {"sample", "step", "reco"} <= set(r.train_obs.columns)
    assert len(r.train_obs) == len(r.train_pred)
    assert sorted(r.train_obs["step"].unique()) == [0, 1]
    n_train = r.train_obs_columns["sample"].max() + 1
    assert r.train_pred_columns["reco_pred"].shape == (2 * n_train,)
    # the predictions are the trailing two steps of each six-step window
    train, _ = et.split_data(cols, tm, sequence_kwargs=SEQ)
    tm.eval()
    with torch.no_grad():
        full = tm(torch.from_numpy(train.x), {"ta": torch.from_numpy(train.forcing["ta"])})["reco"]
    np.testing.assert_allclose(r.train_pred_columns["reco_pred"], full[:, -2:].numpy().ravel(),
                               rtol=1e-6)
    np.testing.assert_array_equal(r.train_obs_columns["reco"], train.y["reco"].ravel())


def test_sequence_length_is_the_input_window():
    tm = et.construct_hybrid_model(**_spec(False, 4), generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    r = et.train(tm, et.rbq10_columns(120, seed=2), nepochs=1, batchsize=16, show_progress=False,
                 sequence_length=5)
    assert np.isfinite(r.best_loss)
    assert r.history[0].l_val["mse"]["reco"] > 0
    assert sorted(set(r.val_obs_columns["step"])) == [0]  # output_window defaults to 1
