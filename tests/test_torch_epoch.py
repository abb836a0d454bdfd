"""The port's torch epoch against the JAX package's make_train_epoch: the
same model and parameters (carried across), the same padded epoch data and
the JAX permutations injected, for adam and sgd, the three shuffle modes,
three epochs per call, trainable BatchNorm with its running statistics, NaN
targets and an all-masked batch. Tolerances as tests/test_fused.py: atol
2e-6 after one epoch, 1e-5 after three (float32, other summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu.training.epoch import make_train_epoch as jax_train_epoch
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer


def _spec(norm=True, hidden=(8,), act="tanh"):
    return dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
    )


def setup(norm=True, n=512, batch=128, nan_frac=0.0, data=None, hidden=(8,), act="tanh"):
    """JAX model, params, state and tensors; the port's model with the same
    parameters and its tensors."""
    spec = _spec(norm, hidden, act)
    jm = eh.construct_hybrid_model(**spec)
    tm = et.construct_hybrid_model(**spec)
    if data is None:
        data = et.prepare_data(tm, et.rbq10_columns(n, seed=42, nan_frac=nan_frac))
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        from easyhybrid_tpu.training.train import fit_input_norm

        state = fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    host = build_epoch_tensors(data, batch)
    jt = jax.device_put(jax_epoch_tensors(eh.prepare_data(jm, tuple_of(data)), batch))
    return jm, params, state, jt, tm, tepoch.epoch_tensors_to(host, "cpu")


def tuple_of(data):
    return ((data.x, data.forcing), data.y)


def jax_perms(shuffle, key, epochs, nb, batch):
    """The permutations the JAX epoch draws for ``key``."""
    n = nb * batch if shuffle is True else nb
    if epochs == 1:
        return np.asarray(jax_permutation(key, n))
    keys = jax.random.split(key, epochs)
    return np.stack([np.asarray(jax_permutation(k, n)) for k in keys])


def assert_params_match(tm, jparams, jstate, atol):
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)


def run_both(opt, shuffle, epochs, *, norm=True, atol=2e-6, **kw):
    jm, params, state, jt, tm, tt = setup(norm=norm, **kw)
    ll = eh.LoggingLoss(training_loss="mse", loss_types=("mse",))
    tll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    joptim = optax.adam(opt[1]) if opt[0] == "adam" else optax.sgd(opt[1])
    key = jax.random.PRNGKey(7)
    jfn = jax_train_epoch(jm, ll, joptim, shuffle=shuffle, epochs_per_call=epochs)
    jp, _, js, jloss = jfn(jax.tree.map(jnp.array, params), joptim.init(params),
                           jax.tree.map(jnp.array, state), jt, key)
    toptim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(tm, tll, toptim, shuffle=shuffle, epochs_per_call=epochs)
    nb, batch = tt.weight.shape
    perm = jax_perms(shuffle, key, epochs, nb, batch) if shuffle and nb > 1 else None
    tstate, tloss = tfn(toptim.init(dict(tm.named_parameters())), tt, perm=perm)
    assert_params_match(tm, jp, js, atol)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    return tm, tstate


@pytest.mark.parametrize("opt,norm", [
    (("adam", 0.01), True), (("adam", 0.01), "static"),
    (("sgd", 0.05), True), (("sgd", 0.05), "static"), (("sgd", 0.05), False),
])
def test_unshuffled_epoch_matches_jax(opt, norm):
    # no adam without a norm: raw inputs (~50) saturate tanh units, and Adam's
    # g / sqrt(v) turns their ~1e-9 gradients' rounding into whole steps
    run_both(opt, False, 1, norm=norm)


@pytest.mark.parametrize("shuffle", [True, "batches"])
def test_shuffled_epoch_with_the_jax_permutation(shuffle):
    run_both(("adam", 0.01), shuffle, 1)


@pytest.mark.parametrize("shuffle", [False, True, "batches"])
def test_three_epochs_per_call(shuffle):
    _, state = run_both(("adam", 0.01), shuffle, 3, atol=1e-5)
    assert int(state["count"]) == 12


def test_nan_targets():
    run_both(("adam", 0.01), True, 1, n=256, batch=64, nan_frac=0.5)


def test_all_masked_batch_changes_nothing():
    """The first batch has no valid target: parameters, Adam's moments and
    count, and the BatchNorm running statistics skip it, as in JAX."""
    cols = et.rbq10_columns(256, seed=3)
    y = cols["reco"].copy()
    y[:64] = np.nan
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": y})
    tm, state = run_both(("adam", 0.01), False, 1, data=data, batch=64)
    assert int(state["count"]) == 3
    assert all(torch.isfinite(p).all() for p in tm.parameters())


def test_permutation_helpers():
    gen = torch.Generator().manual_seed(0)
    perm = tepoch.epoch_permutation(gen, 50)
    assert sorted(perm.tolist()) == list(range(50))
    _, _, _, _, tm, tt = setup(n=300, batch=64)
    shuffled = tepoch.shuffle_epoch_tensors(tt, torch.arange(tt.weight.numel()).flip(0))
    assert torch.equal(shuffled.weight.reshape(-1), tt.weight.reshape(-1).flip(0))
    assert tepoch.perms_for_epochs(False, tt, 2) is None
    assert tepoch.perms_for_epochs("batches", tt, 2, generator=gen).shape == (2, tt.weight.shape[0])
    with pytest.raises(ValueError, match="generator"):
        tepoch.perms_for_epochs(True, tt, 1)
    from easyhybrid_tpu.training.epoch import can_skip_empty_guard

    assert tepoch.can_skip_empty_guard(tt)  # 20 padding rows, fewer than a batch
    cols = et.rbq10_columns(300, seed=42)
    y = cols["reco"].copy()
    y[:50] = np.nan  # 50 target-less rows + 20 padding rows >= a batch of 64
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": y})
    assert not can_skip_empty_guard(jax_epoch_tensors(eh.prepare_data(
        eh.construct_hybrid_model(**_spec()), tuple_of(data)), 64))
    assert not tepoch.can_skip_empty_guard(build_epoch_tensors(data, 64))


def test_evaluators_and_loss_fn():
    _, _, _, _, tm, tt = setup(norm="static", n=300, batch=300)  # train mode == eval mode
    batch = ((tt.x[0], {"ta": tt.forcing["ta"][0]}), ({"reco": tt.y["reco"][0]}, {"reco": tt.mask["reco"][0]}))
    ll = et.LoggingLoss()
    (m_tr, out_tr), (m_va, _) = tepoch.make_dual_evaluator(tm, ll)(batch, batch)
    assert set(m_tr) == {"mse", "r2"} and float(m_tr["mse"]["sum"]) == float(m_va["mse"]["sum"])
    assert out_tr["reco"].shape == (300,)
    loss = tepoch.make_loss_fn(tm, ll)(batch)
    assert loss.requires_grad and float(loss.detach()) == pytest.approx(float(m_tr["mse"]["sum"]), rel=1e-3)
