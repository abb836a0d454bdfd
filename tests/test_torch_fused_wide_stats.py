"""Kernel 3 under a trainable input BatchNorm and the moment losses (nseLoss,
rmse, pearsonLoss, kgeLoss, pbkgeLoss): its plain version
(``fused_wide_reference``, what the wrapper computes on CPU tensors) against
the JAX package's unchunked fused epoch kernel in interpret mode and against
the port's torch epoch; a fully masked batch under a statistic loss; the
loss scales and target moments made before the launch; the gate on the
running statistics; and the slice as a whole, ``train()`` against the JAX
``train()``.

Tolerances, float32, as tests/test_torch_fused_wide.py states them: against
the JAX kernel parameters, moments and running statistics rtol 1e-5 with atol
1e-5 after two epochs of three steps (mae under adam atol 1e-4, for the sign
flips that file describes), the loss rtol 1e-5; against the torch epoch the
statistic losses atol 2e-5, as tests/test_torch_fused_losses.py holds kernel
2 (their gradients divide by batch moments), the running statistics atol
5e-6 (the variance is ~400); ``train()`` as tests/test_torch_fused_wide.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.ops.fused_epoch import _pick_batch_chunks
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from test_torch_fused_epoch import assert_model_matches, assert_slots_match, assert_torch_slots_match
from test_torch_fused_wide import _atol, _ll, _spec, jax_perms, setup

MOMENT_LOSSES = ("nseLoss", "rmse", "pearsonLoss", "kgeLoss", "pbkgeLoss")

JAX_CASES = [
    # norm, loss, agg, opt, shuffle, NaN fraction of the targets
    (True, "mse", "sum", ("adam", 0.01), True, 0.0),
    (True, "mae", "sum", ("adam", 0.01), "batches", 0.3),
    (True, "mse", "mean", ("sgd", 0.05), False, 0.3),
    ("static", "nseLoss", "mean", ("adam", 0.01), True, 0.3),
    ("static", "rmse", "sum", ("adam", 0.01), False, 0.0),
    ("static", "pearsonLoss", "sum", ("adam", 0.01), "batches", 0.3),
    ("static", "kgeLoss", "mean", ("adam", 0.01), True, 0.0),
    ("static", "pbkgeLoss", "sum", ("rmsprop", 0.01), True, 0.3),
    (True, "kgeLoss", "mean", ("adam", 0.01), True, 0.3),
]


@pytest.mark.parametrize("norm,loss,agg,opt,shuffle,nan_frac", JAX_CASES, ids=str)
def test_reference_matches_the_jax_unchunked_kernel(norm, loss, agg, opt, shuffle, nan_frac):
    """Two epochs per call of the JAX kernel with each batch of 256 whole
    (its unchunked body, which carries the norm's EMA and takes the batch's
    moments) against the plain version: parameters, moments, running
    statistics, step count, loss."""
    jm, params, state, jt, tm, tt = setup(norm, nan_frac=nan_frac)
    jll = eh.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    assert _pick_batch_chunks(jm, [jm.nn], jt, jll) == 1
    key = jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=2)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)

    fn = et.make_fused_wide_epoch(tm, opt, _ll(et, loss, agg=agg), shuffle=shuffle,
                                  epochs_per_call=2)
    assert fn.plan.norm_mode == (2 if norm is True else 1) and fn.plan.loss == loss
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, got_loss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                          perms=jax_perms(shuffle, key, 2, nb, batch))
    atol = _atol(loss, opt)
    assert_model_matches(tm, jp, js, atol)  # the parameters and the running statistics
    if norm is True:
        assert not torch.equal(fn.plan.pack(tm).bn, p0.bn)
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(np.asarray(jos["t"])[0]) == 6
    assert_slots_match(fn.plan, tm, os_, jos, atol=atol, rtol=1e-4)


TORCH_CASES = [(True, "mse"), (True, "mae"), *[("static", loss) for loss in MOMENT_LOSSES],
               (True, "pearsonLoss")]


@pytest.mark.parametrize("norm,loss", TORCH_CASES, ids=str)
def test_reference_matches_the_torch_epoch(norm, loss):
    """Two epochs of adam over 30% NaN targets at a width no single block
    holds, against the port's torch epoch (autograd through
    losses/metrics.py and the BatchNorm module)."""
    *_, tm, tt = setup(norm, nan_frac=0.3, hidden=(70, 33), act="swish")
    twin = et.construct_hybrid_model(**_spec(norm, hidden=(70, 33), act="swish"), device="cpu")
    twin.load_state_dict(tm.state_dict())
    ll = _ll(et, loss, agg="mean")
    perms = tepoch.perms_for_epochs(True, tt, 2, generator=torch.Generator().manual_seed(1))
    opt = ("adam", 0.01)
    fn = et.make_fused_wide_epoch(tm, opt, ll, shuffle=True, epochs_per_call=2)
    p0 = fn.plan.pack(tm)
    packed, os_, got_loss = fn(p0, fe.init_fused_opt_state(p0, opt), tt, perms=perms)
    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, ll, optim, shuffle=True, epochs_per_call=2)
    state, tloss = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    atol = 2e-5 if loss in fe.STAT_LOSSES else _atol(loss, opt)
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(packed.bn.numpy(), want.bn.numpy(), atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(tloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])
    assert_torch_slots_match(fn.plan, opt, os_, state, atol=atol, rtol=1e-4)


def _masked_first(n, masked):
    cols = et.rbq10_columns(n, seed=3, nan_frac=0.2)
    y = cols["reco"].copy()
    y[:masked] = np.nan

    def data(rows):
        return HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1)[rows],
                          forcing={"ta": cols["ta"][rows]}, y={"reco": y[rows]})

    return data


@pytest.mark.parametrize("norm,loss", [(True, "kgeLoss"), ("static", "pearsonLoss"),
                                       (True, "rmse")], ids=str)
def test_a_fully_masked_batch_under_a_moment_loss_takes_no_step(norm, loss):
    """The first (unshuffled) batch has no valid target: its gradient is NaN
    (the statistic losses' Shh = 0), yet it takes no step, counts none, moves
    neither the parameters, the moments nor the running statistics, and adds
    0 to the loss, so the run equals one over the other batches alone, bit
    for bit (the JAX kernel spreads the NaN there: ROADMAP C)."""
    data = _masked_first(256, 64)
    *_, tm, tt = setup(norm, data=data(slice(None)), batch=64, hidden=(70, 33), act="swish")
    *_, tm2, tt2 = setup(norm, data=data(slice(64, None)), batch=64, hidden=(70, 33), act="swish")
    tm2.load_state_dict(tm.state_dict())
    fn = et.make_fused_wide_epoch(tm, ("adam", 0.01), _ll(et, loss), shuffle=False)
    p0 = fn.plan.pack(tm)
    scale, valid = fw.batch_scales(fn.plan, fn._make_data(fn.plan, tt), fn.rows(tt))
    assert valid.tolist() == [[0.0, 1.0, 1.0, 1.0]]
    got, os_, got_loss = fn(p0, fe.init_fused_opt_state(p0), tt)
    want, os2, want_loss = fn(p0, fe.init_fused_opt_state(p0), tt2)
    assert int(os_["t"][0]) == 3 == int(os2["t"][0])
    assert torch.isfinite(got.params).all() and torch.isfinite(got.bn).all()
    assert torch.equal(got.params, want.params) and torch.equal(got.bn, want.bn)
    assert torch.equal(os_["m"], os2["m"]) and torch.equal(os_["v"], os2["v"])
    np.testing.assert_allclose(float(got_loss) * 4, float(want_loss) * 3, rtol=1e-6)


@pytest.mark.parametrize("loss", ["mse", *MOMENT_LOSSES])
def test_scales_and_target_moments_are_the_batch_s(loss):
    """The scales and target moments made before the launch, step by step,
    against kernel 2's per-batch forms (``target_scale``; the statistic
    losses' count, target mean and SST as ``stat_loss_cotangent`` takes
    them): nseLoss's scale is agg over the centred SST, rmse's and the
    statistic losses' is agg (their factors come from the predictions)."""
    *_, tm, tt = setup(True, nan_frac=0.3, n=700, batch=128)
    fn = et.make_fused_wide_epoch(tm, "adam", _ll(et, loss, agg="mean"), shuffle=True,
                                  epochs_per_call=2)
    data = fn._make_data(fn.plan, tt)
    rows = fn.rows(tt, generator=torch.Generator().manual_seed(2))
    scale, valid = fw.batch_scales(fn.plan, data, rows)
    moments = fw.target_moments(fn.plan, data, rows)
    assert scale.shape == valid.shape + (1,) and moments.shape == valid.shape + (1, 3)
    for e in range(2):
        for i in range(data.n_batches):
            idx = rows[e, i * 128 : (i + 1) * 128].long()
            m, y = data.mask[0][idx], data.y[0][idx]
            if loss in fw.TWO_PASS_LOSSES:
                want = torch.tensor(fn.plan.agg_scale)
            else:
                want = fe.target_scale(fn.plan, m, y)
            torch.testing.assert_close(scale[e, i, 0], want.float(), rtol=1e-6, atol=0.0)
            n = m.sum().clamp_min(1.0)
            mu = y.sum() / n
            dev = (y - mu) * m
            torch.testing.assert_close(moments[e, i, 0], torch.stack([n, mu, (dev * dev).sum()]),
                                       rtol=1e-6, atol=1e-6)
            assert bool(valid[e, i]) == bool(m.sum() > 0)


@pytest.mark.parametrize("norm,loss,opt,shuffle", [
    (True, "mse", ("adam", 0.01), True), ("static", "nseLoss", ("adam", 0.01), False),
    (True, "kgeLoss", ("sgd", 0.05), "batches"), ("static", "rmse", ("adam", 0.01), True),
], ids=str)
def test_gate_passes_under_batchnorm_and_the_moment_losses(norm, loss, opt, shuffle):
    *_, tm, tt = setup(norm, hidden=(128, 64), act="swish")
    assert fe.fused_engine(tm, tt).epoch_path == "cuda_fused_wide"
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ok, worst = fe.fused_exactness_check(tm, opt, _ll(et, loss), tt, epochs_per_call=2,
                                         shuffle=shuffle)
    assert ok and worst < 1e-4
    for k, v in tm.state_dict().items():  # the gate leaves the model as it was
        assert torch.equal(v, before[k])


def test_gate_fails_on_corrupted_running_statistics(monkeypatch):
    """The gate holds the running statistics as well: an EMA that moves them
    a tenth too far fails it, though every gradient is right."""
    *_, tm, tt = setup(True, hidden=(128, 64), act="swish")
    real = fw.reference_grads

    def corrupted(plan, p, bn, *args, **kwargs):
        g, loss, valid, new_bn = real(plan, p, bn, *args, **kwargs)
        return g, loss, valid, new_bn + 0.1 * (new_bn - bn)

    monkeypatch.setattr(fw, "reference_grads", corrupted)
    ok, worst = fe.fused_exactness_check(tm, ("sgd", 0.01), _ll(et), tt)
    assert not ok and worst > 3e-2


TRAIN_CASES = [(True, "mse"), ("static", "nseLoss"), ("static", "rmse"), (True, "kgeLoss")]


@pytest.mark.parametrize("norm,loss", TRAIN_CASES, ids=str)
def test_train_matches_jax_under_batchnorm_and_the_moment_losses(norm, loss):
    """The slice as a whole: ``train()`` with ``use_kernel=True`` on a model
    too wide for kernel 2 against the JAX ``train()`` from the same
    parameters, unshuffled: per-epoch metrics, best epoch, parameters and
    the running statistics."""
    spec = _spec(norm, hidden=(128, 64), act="swish")
    kw = dict(nepochs=6, batchsize=128, optimizer=("adam", 0.01), shuffle_each_epoch=False,
              show_progress=False, training_loss=loss, loss_types=[loss, "mse"], eval_every=2)
    jm = eh.construct_hybrid_model(**spec)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cols = et.rbq10_columns(512, seed=42)
    jr = eh.train(jm, cols, train_from=jax.tree.map(np.array, init), **kw)
    tm = et.construct_hybrid_model(**spec, device="cpu")
    tr = et.train(tm, cols, train_from=init, use_kernel=True, **kw)
    assert tr.epoch_path == "cuda_fused_wide" and "exactness gate passed" in tr.engine_reason
    assert len(tr.val_history) == len(jr.val_history) == 4
    for got, want in ((tr.train_history, jr.train_history), (tr.val_history, jr.val_history)):
        for g, w in zip(got, want):
            for metric in w:
                for k in w[metric]:
                    np.testing.assert_allclose(g[metric][k], w[metric][k], rtol=1e-4, atol=1e-5)
    assert tr.best_epoch == jr.best_epoch
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(jr.state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)
    assert int(tr.opt_state["t"][0]) == 6 * 4


@pytest.mark.parametrize("norm,loss,moments", [
    (True, "mse", False), ("static", "kgeLoss", True), (True, "rmse", True),
    (False, "nseLoss", False),
], ids=str)
def test_the_plan_s_layout_holds_the_statistics_and_the_moments(norm, loss, moments):
    """The plan asks the layout for the batch's statistics under a trainable
    norm and for the predictions and head moments under rmse and the
    statistic losses; the launcher's struct carries the norm's momentum."""
    tm = et.construct_hybrid_model(**_spec(norm, hidden=(128, 64), act="swish"), device="cpu")
    plan = fw.plan_fused_wide(tm, ("adam", 0.01), _ll(et, loss))
    lay = plan.layout(300)
    base = fw.wide_layout(plan.dims, plan.has_norm, 300)
    assert (lay.ws_stats != 0) == (norm is True) and (lay.ws_pred != 0) == moments
    extra = (2 * 2 if norm is True else 0) + ((300 + 2 * 3) if moments else 0)
    assert lay.ws_floats == base.ws_floats + extra and lay.part_floats == base.part_floats
    a = fw._Args.from_buffer_copy(plan.args_bytes)
    assert a.norm_mode == {True: 2, "static": 1, False: 0}[norm]
    assert a.momentum == np.float32(tm.nn.norm.momentum if norm else 0.0)
    assert a.one_minus_momentum == np.float32(1.0 - (tm.nn.norm.momentum if norm else 0.0))
    assert a.loss_kind == fe.LOSS_KINDS[loss]
