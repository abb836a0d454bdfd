"""Every training loss of the JAX kernels in the port's training kernels:
kernel 2's plain version (``fused_epoch_reference``) under mae, nseLoss,
rmse, pearsonLoss, kgeLoss, pbkgeLoss and a traced ``ElementwiseLoss``
against the JAX package's fused epoch kernel in interpret mode and against
the port's torch epoch; kernels 3, 4 and 5's plain versions under pinball
and huber (by mean and by sum), and kernel 5's under rmse, against the JAX
kernels; the traced loss (``kernel_forms.traced_loss``): its emitted header
compiled on the host against ``torch.func.jvp``, its refusals, the
divergence from JAX at a residual of 0; and the statistic losses' closed-form
partials (``ehe_stat_loss`` in ``csrc/eh_device.cuh``) transcribed to float32
numpy against ``jax.jvp`` of the JAX kernel's ``make_stat_loss_g``.

Tolerances, float32: kernel 2 and its torch epoch as
tests/test_torch_fused_epoch.py holds them after one epoch (atol 2e-6), the
statistic losses 1e-5 (their gradients divide by batch moments); kernels 3-5
as their own parity tests hold them."""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.ops.fused_epoch import make_stat_loss_g
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.losses.metrics import _pinball_elem
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_multisite as fm
from easyhybrid_tpu_torch.ops import kernel_forms as kf
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from test_torch_fused_epoch import assert_model_matches, jax_perms
from test_torch_fused_epoch import setup as epoch_setup
from test_torch_kernel_forms import (TWO_SPEC, _pair, two_output_columns, two_outputs,
                                     two_outputs_jnp)

CSRC = Path(fe.__file__).resolve().parent.parent / "csrc"


def loss_pair(loss, agg="sum", normalize="mean"):
    """The same training loss as the JAX package and the port spell it."""
    if loss in ("pinball", "huber"):
        arg = 0.9 if loss == "pinball" else 1.0
        return (getattr(eh, loss)(arg, normalize=normalize),
                getattr(et, loss)(arg, normalize=normalize))
    return loss, loss


def logging_pair(loss, agg="sum", normalize="mean"):
    jl, tl = loss_pair(loss, agg, normalize)
    return (eh.LoggingLoss(training_loss=jl, loss_types=("mse",), agg=agg),
            et.LoggingLoss(training_loss=tl, loss_types=("mse",), agg=agg))


def masked_first_batch(n=512, seed=3):
    cols = et.rbq10_columns(n, seed=seed, nan_frac=0.2)
    y = cols["reco"].copy()
    y[:128] = np.nan
    return HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": y})


def two_output_setup(batch=128):
    jm, params, state, tm, data = _pair(TWO_SPEC, two_outputs_jnp, two_outputs,
                                        two_output_columns(512))
    jt = jax.device_put(jax_epoch_tensors(eh.prepare_data(jm, ((data.x, data.forcing), data.y)),
                                          batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


# kernel 2: each loss once, agg sum and mean split between them, NaN targets;
# the two-output model for rmse and pearsonLoss; a fully masked first batch
# under kgeLoss (test_a_fully_masked_batch_under_a_statistic_loss). A summed
# loss scales the gradient by the batch: sgd at 1e-3 and the static norm
# there (on raw predictors of a few hundred its first steps are large enough
# that float32 rounding grows past 1e-5 between any two summation orders).
# (loss, agg, normalize, optimizer, shuffle, setup kwargs)
EPOCH_CASES = [
    ("mae", "sum", "mean", ("adam", 0.01), True, dict(nan_frac=0.3)),
    ("nseLoss", "mean", "mean", ("adam", 0.01), True, dict(nan_frac=0.3)),
    ("rmse", "mean", "mean", ("adam", 0.01), True, "two"),
    ("pearsonLoss", "sum", "mean", ("adam", 0.01), False, "two"),
    ("kgeLoss", "mean", "mean", ("adam", 0.01), True, dict(nan_frac=0.3)),
    ("pbkgeLoss", "sum", "mean", ("rmsprop", 0.01), True, dict(norm="static")),
    ("pinball", "sum", "mean", ("adam", 0.01), True, dict(nan_frac=0.3)),
    ("huber", "mean", "sum", ("sgd", 0.001), "batches", dict(norm="static")),
]


def _epoch_setup(kw):
    if kw == "two":
        return two_output_setup()
    return epoch_setup(**{"norm": True, "hidden": (8,), **kw})


@pytest.mark.parametrize("loss,agg,normalize,opt,shuffle,kw", EPOCH_CASES, ids=str)
def test_kernel_2_reference_matches_the_jax_fused_epoch(loss, agg, normalize, opt, shuffle, kw):
    jm, params, state, jt, tm, tt = _epoch_setup(kw)
    jll, tll = logging_pair(loss, agg, normalize)
    key = jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=1)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)
    fn = et.make_fused_epoch(tm, opt, tll, shuffle=shuffle, epochs_per_call=1)
    assert fn.plan.loss == (fe.ELEMENTWISE if loss in ("pinball", "huber") else loss)
    nb, batch = tt.weight.shape
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                       perms=jax_perms(shuffle, key, 1, nb, batch))
    stat = loss in fe.STAT_LOSSES
    assert_model_matches(tm, jp, js, 1e-5 if stat else 2e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(jos["t"][0])


def test_a_fully_masked_batch_under_a_statistic_loss():
    """kgeLoss's gradient on a batch without a valid target is NaN (Shh = 0).
    The port's kernel takes no step there, as its torch epoch and the JAX
    epoch do, so a run whose first batch is fully masked equals the JAX
    kernel's run over the other batches. The JAX kernel itself gates its
    update arithmetically (``p - valid * lr * upd``) and spreads the NaN into
    every parameter: a divergence of the reference, pinned here (ROADMAP C)."""
    data = masked_first_batch()
    opt = ("adam", 0.01)
    jll, tll = logging_pair("kgeLoss", "mean")
    jm, params, state, jt, tm, tt = epoch_setup(True, data=data, hidden=(8,))
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=False, epochs_per_call=1)
    leaky = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                jax.random.PRNGKey(5))[0]
    assert all(np.isnan(np.asarray(v)).all() for v in jax.tree.leaves(leaky))
    rest = HybridData(x=data.x[128:], forcing={"ta": data.forcing["ta"][128:]},
                      y={"reco": data.y["reco"][128:]})
    jm2, params2, state2, jt2, *_ = epoch_setup(True, data=rest, hidden=(8,))
    jp, jos, js, jloss = jax_fused_epoch(jm2, state2, opt, jll, shuffle=False)(
        jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt2,
        jax.random.PRNGKey(5))
    fn = et.make_fused_epoch(tm, opt, tll, shuffle=False)
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt)
    assert int(os_["t"][0]) == int(jos["t"][0]) == 3
    assert all(torch.isfinite(p).all() for p in tm.parameters())
    assert_model_matches(tm, jp, js, 1e-5)
    # the epoch's mean over its batches, the empty one counted 0
    np.testing.assert_allclose(4.0 * float(tloss), 3.0 * float(jloss), rtol=1e-5)


@pytest.mark.parametrize("loss", list(fe.FUSED_LOSSES) + ["pinball", "huber"])
def test_kernel_2_reference_matches_the_torch_epoch(loss):
    """Every loss, two epochs of adam over NaN targets, against the port's
    torch epoch (autograd through losses/metrics.py)."""
    two = loss in ("rmse", "pearsonLoss")
    *_, tm, tt = two_output_setup() if two else epoch_setup(True, hidden=(8,), nan_frac=0.2)
    twin = et.construct_hybrid_model(**(dict(TWO_SPEC, mechanistic_model=two_outputs) if two else
                                        dict(predictors=["sw_pot", "dsw_pot"], forcing=["ta"],
                                             targets=["reco"], mechanistic_model=et.rbq10,
                                             parameters={"rb": (3.0, 0.0, 13.0),
                                                         "Q10": (2.0, 1.0, 4.0)},
                                             neural_param_names=["rb"],
                                             global_param_names=["Q10"], hidden_layers=[8],
                                             activation="tanh", scale_nn_outputs=True,
                                             input_batchnorm=True)), device="cpu")
    twin.load_state_dict(tm.state_dict())
    _, tll = logging_pair(loss, "mean" if two else "sum")
    perms = tepoch.perms_for_epochs(True, tt, 2, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_epoch(tm, ("adam", 0.01), tll, shuffle=True, epochs_per_call=2)
    p0 = fn.plan.pack(tm)
    packed, os_, loss_f = fn(p0, fe.init_fused_opt_state(p0), tt, perms=perms)
    optim = resolve_optimizer(("adam", 0.01))
    tfn = tepoch.make_train_epoch(twin, tll, optim, shuffle=True, epochs_per_call=2)
    state, loss_t = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    atol = 2e-5 if loss in fe.STAT_LOSSES else 1e-5
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(packed.bn.numpy(), want.bn.numpy(), atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(float(loss_f), float(loss_t), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])


# --------------------------------------------------------------------------
# kernels 3, 4 and 5: the traced elementwise loss (and kernel 5's rmse)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("loss,normalize,shuffle", [("pinball", "mean", True),
                                                     ("huber", "sum", "batches")], ids=str)
def test_kernel_3_reference_matches_the_jax_chunked_kernel(monkeypatch, loss, normalize, shuffle):
    """The JAX kernel's batch-chunked body (run as tests/test_fused.py runs
    it) against kernel 3's plain version: the chunkable losses' scale over
    the whole batch, by mean or by sum."""
    from easyhybrid_tpu.ops.fused_epoch import _pick_batch_chunks
    from test_torch_fused_wide import _atol
    from test_torch_fused_wide import setup as wide_setup

    jm, params, state, jt, tm, tt = wide_setup(nan_frac=0.3)
    monkeypatch.setenv("EASYHYBRID_FUSED_MAX_VMEM_MB", "0.45")
    monkeypatch.setenv("EASYHYBRID_FUSED_CHUNKED", "1")
    jll, tll = logging_pair(loss, "sum", normalize)
    assert _pick_batch_chunks(jm, [jm.nn], jt, jll) == 2
    opt, key = ("adam", 0.01), jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=2)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                            key)
    fn = et.make_fused_wide_epoch(tm, opt, tll, shuffle=shuffle, epochs_per_call=2)
    assert fn.plan.loss == fe.ELEMENTWISE and fn.plan.loss_form.normalize == normalize
    nb, batch = tt.weight.shape
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                       perms=jax_perms(shuffle, key, 2, nb, batch))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=_atol("mae", opt))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(np.asarray(jos["t"])[0])


@pytest.mark.parametrize("loss,normalize,kw", [
    ("pinball", "mean", {}), ("pinball", "sum", {"out_steps": 1}),
    ("huber", "sum", {"nan_frac": 0.3}),
], ids=str)
def test_kernel_4_reference_matches_the_jax_lstm_kernel(loss, normalize, kw):
    """Kernel 4's plain version against the JAX kernel's LSTM body: the
    traced loss's scale spans the whole (T_out x B) window, agg / n by mean
    and agg by sum, as the JAX kernel builds ``inv_n``."""
    from test_torch_fused_lstm import jax_perms as lstm_perms
    from test_torch_fused_lstm import setup as lstm_setup

    jm, params, state, jt, tm, tt = lstm_setup("static", **kw)
    jll, tll = logging_pair(loss, "mean", normalize)
    opt, key = ("adam", 0.01), jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=True, epochs_per_call=2)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                            key)
    fn = et.make_fused_lstm_epoch(tm, opt, tll, shuffle=True, epochs_per_call=2)
    nb, batch = tt.weight.shape
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                       perms=lstm_perms(True, key, 2, nb, batch))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert int(os_["t"][0]) == int(jos["t"][0])


def test_kernel_4_scales_span_the_window_by_mean_and_by_sum():
    """``window_scales``: an elementwise loss by mean takes agg / n over
    every valid target of the (B, T_out) window, by sum agg alone."""
    from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
    from test_torch_fused_lstm import setup as lstm_setup

    *_, tm, tt = lstm_setup("static", out_steps=2, nan_frac=0.3)
    y, m = tt.y["reco"][0], tt.mask["reco"][0]
    for normalize, want in (("mean", 0.5 / float(m.sum())), ("sum", 0.5)):
        _, tll = logging_pair("pinball", "mean", normalize)
        plan = et.make_fused_lstm_epoch(tm, ("adam", 0.01), tll).plan
        plan = plan.__class__(**{**plan.__dict__, "agg_scale": 0.5})
        (scale,), valid = fl.window_scales(plan, [y], [m])
        assert bool(valid) and float(scale) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("kw,loss,normalize,shuffle", [
    (dict(), "pinball", "mean", False),
    (dict(S=300, N=8, batch=128), "huber", "sum", True),
    (dict(), "rmse", "mean", False),
    (dict(S=300, N=8, batch=128), "rmse", "mean", "batches"),
], ids=str)
def test_kernel_5_reference_matches_the_jax_kernel_in_interpret_mode(kw, loss, normalize, shuffle):
    """Kernel 5's plain version against the JAX multisite kernel: the traced
    loss, and rmse with its batch-scoped deferred factor (one batch, and a
    factor a minibatch)."""
    from easyhybrid_tpu.ops.fused_multisite import make_fused_multisite_epoch as jax_multisite
    from test_torch_fused_multisite import jax_perms as ms_perms
    from test_torch_fused_multisite import setup as ms_setup

    jm, params, state, jt, tm, tt = ms_setup(**kw)
    jll, tll = logging_pair(loss, "sum", normalize)
    opt, key, epochs = ("adam", 0.01), jax.random.PRNGKey(7), 3
    jfn = jax_multisite(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs,
                        interpret=True)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.copy, params), jax_init_opt(params, opt), state, jt,
                            key)
    assert et.supports_fused_multisite(tm, opt, tll, tt, shuffle=shuffle)
    fn = et.make_fused_multisite_epoch(tm, opt, tll, shuffle=shuffle, epochs_per_call=epochs)
    nb, sb = tt.weight.shape
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                       perms=ms_perms(shuffle, key, epochs, nb, sb))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-4)
    assert int(os_["t"][0]) == int(jos["t"][0])


def test_kernel_5_refuses_rmse_on_two_targets():
    """rmse's deferred factor is one target's, as the JAX kernel has it."""
    base = et.construct_hybrid_model(**{**TWO_SPEC, "input_batchnorm": False},
                                     mechanistic_model=two_outputs, device="cpu")
    tm = et.MultiSiteHybridModel(base, 16, device="cpu")
    reason = fm.fused_multisite_unsupported_reason(tm, ("adam", 0.01),
                                                   et.LoggingLoss(training_loss="rmse"))
    assert reason is not None and "rmse on 2 targets" in reason


# --------------------------------------------------------------------------
# the traced loss, and the loss layer's device functions on the host
# --------------------------------------------------------------------------

def _huber_like(yh, y):
    r = torch.abs(yh - y)
    return torch.where(r <= 0.5, 0.5 * r * r, 0.5 * (r - 0.25)) + 0.01 * torch.clamp_max(yh, y)


TRACED_LOSSES = {
    "pinball": et.pinball(0.9),
    "huber_sum": et.huber(1.0, normalize="sum"),
    "one_bound_clamps": et.ElementwiseLoss(_huber_like, name="huber_like"),
}


def _probe_rows(n=200, seed=0):
    """Predictions and targets with residuals of both signs, exactly 0, and
    on huber's bound."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(n, generator=g) * 2.0
    yh = y + torch.randn(n, generator=g) * 1.5
    yh[:10] = y[:10]
    yh[10:15] = y[10:15] + 1.0
    yh[15:20] = y[15:20] - 0.5
    return yh, y


@pytest.mark.parametrize("key", list(TRACED_LOSSES))
def test_the_traced_loss_gives_the_function_and_its_jvp(key):
    spec = TRACED_LOSSES[key]
    form = kf.traced_loss(spec)
    assert isinstance(form, kf.LossForm), form
    assert form.normalize == spec.normalize and kf.traced_loss(spec) is form  # cached
    yh, y = _probe_rows()
    want, tangent = torch.func.jvp(lambda v: spec.elementwise(v, y), (yh,), (torch.ones_like(yh),))
    assert torch.equal(form.value_fn(yh, y).view(torch.int32), want.view(torch.int32))
    torch.testing.assert_close(form.grad_fn(yh, y), tangent, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn,cause", [
    (lambda yh, y: torch.sin(yh - y), "operation torch.sin is outside"),
    (lambda yh, y: (yh - y) if float((yh - y).sum()) > 0 else y, "tracing it raised"),
    (lambda yh, y: (yh - y) * torch.ones(3), "tensor constants"),
])
def test_a_loss_the_tracer_refuses_names_its_cause(fn, cause):
    got = kf.traced_loss(et.ElementwiseLoss(fn, name="mine"))
    assert isinstance(got, str) and got.startswith("training loss 'mine' has no kernel form: ")
    assert cause in got


def test_clamp_min_and_clamp_max_trace_to_the_one_bound_clamp():
    """Both spellings, function and method, with the bound by position and
    by keyword, against torch.func.jvp; the port's own pinball traces."""
    fns = [lambda *, a, b: {"y": torch.clamp_min(a, 1.0) * b + torch.clamp_max(b, 1.5)},
           lambda *, a, b: {"y": a.clamp_min(b) - a.clamp_max(max=b)},
           lambda *, a, b: {"y": torch.clamp_min(a, min=0.8) + torch.clamp_max(a * b, 2.0)}]
    g = torch.Generator().manual_seed(0)
    a, b = 0.5 + 2.0 * torch.rand(64, generator=g), 0.5 + 2.0 * torch.rand(64, generator=g)
    a[:4], b[:4] = 1.0, a[:4]  # ties with the bounds
    for fn in fns:
        form = kf.traced_form(fn, ("a", "b"))
        assert isinstance(form, kf.KernelForm), form
        args = [dict(a=a, b=b)[n] for n in form.args]
        torch.testing.assert_close(form.torch_fn(*args)[0], fn(a=a, b=b)["y"], rtol=0, atol=0)
        parts = form.partials_fn(*args)
        for i in range(len(args)):
            seeds = tuple(torch.ones_like(x) if j == i else torch.zeros_like(x)
                          for j, x in enumerate(args))
            _, want = torch.func.jvp(lambda *xs: form.torch_fn(*xs)[0], tuple(args), seeds)
            _, ref = torch.func.jvp(lambda *xs: fn(**dict(zip(form.args, xs)))["y"], tuple(args),
                                    seeds)
            torch.testing.assert_close(parts[0][i].expand(64), ref, rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(want, ref, rtol=1e-6, atol=1e-7)
    assert isinstance(kf.traced_form(lambda *, a, b: {"y": _pinball_elem(a, b, 0.9)}, ("a", "b")),
                      kf.KernelForm)


def test_pinball_at_a_residual_of_zero_differs_from_jax():
    """At ŷ = y torch's clamp passes the tangent (2τ − 1), where JAX's
    maximum and minimum take half of it (τ − ½): the port follows torch, as
    its gate and its torch epoch do (ROADMAP C). A masked slot has ŷ·m − y =
    0 there, and its cotangent is multiplied by m = 0, so it moves nothing."""
    form = kf.traced_loss(et.pinball(0.9))
    zero = torch.zeros(3)
    assert torch.allclose(form.grad_fn(zero, zero), torch.full((3,), 0.8))
    jl = eh.pinball(0.9)
    _, jt = jax.jvp(lambda v: jl.elementwise(v, jnp.zeros(3)), (jnp.zeros(3),), (jnp.ones(3),))
    np.testing.assert_allclose(np.asarray(jt), 0.4, rtol=1e-6)
    # off the tie both give τ or τ − 1
    yh = torch.tensor([0.5, -0.5])
    _, jt = jax.jvp(lambda v: jl.elementwise(v, jnp.zeros(2)), (jnp.asarray(yh.numpy()),),
                    (jnp.ones(2),))
    np.testing.assert_allclose(form.grad_fn(yh, torch.zeros(2)).numpy(), np.asarray(jt),
                               rtol=1e-6)


HOST_HEADER_STUB = r"""
#include <math.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
#include "loss.cuh"
extern "C" void run(float yh, float y, float* val, float* dval) {
  eh_traced_loss(yh, y, *val, *dval);
}
"""


@pytest.mark.parametrize("key", list(TRACED_LOSSES))
def test_the_emitted_loss_header_computes_the_loss_and_its_jvp(tmp_path, key):
    """The traced loss's header compiled on the host (g++, its CUDA spellings
    stubbed): ``eh_traced_loss`` gives the loss and ``torch.func.jvp``'s
    tangent, row by row."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to compile the emitted header with")
    spec = TRACED_LOSSES[key]
    (tmp_path / "loss.cuh").write_text(kf.traced_loss(spec).header)
    (tmp_path / "run.cpp").write_text(HOST_HEADER_STUB)
    lib_path = tmp_path / "librun.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(lib_path),
                    str(tmp_path / "run.cpp"), "-lm"], check=True, cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_float)]
    yh, y = _probe_rows(60, seed=3)
    want, tangent = torch.func.jvp(lambda v: spec.elementwise(v, y), (yh,), (torch.ones_like(yh),))
    val, dval = ctypes.c_float(), ctypes.c_float()
    for r in range(60):
        lib.run(float(yh[r]), float(y[r]), ctypes.byref(val), ctypes.byref(dval))
        np.testing.assert_allclose([val.value, dval.value], [float(want[r]), float(tangent[r])],
                                   rtol=1e-6, atol=1e-7)


HOST_LOSS_STUB = r"""
#include <math.h>
#include <string.h>
#define __device__
#define __host__
#define __forceinline__ inline
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
#include "loss.cuh"
#define EH_TRACED_LOSS_HEADER
%s
extern "C" float stat_loss(int kind, const float* m, float* d3) {
  float d[3];
  const float g = ehe_stat_loss(kind, m[0], m[1], m[2], m[3], m[4], m[5], d);
  for (int k = 0; k < 3; ++k) d3[k] = d[k];
  return g;
}
extern "C" float loss_row(int kind, const float* c8, const float* row, float* cot) {
  EhLossCoef c;
  c.c0 = c8[0]; c.c1 = c8[1]; c.n = c8[2]; c.mu_h = c8[3]; c.mu_y = c8[4];
  c.k_mu = c8[5]; c.k_h = c8[6]; c.k_c = c8[7];
  return ehe_loss_row<true>(kind, c, row[0], row[1], row[2], row[3], *cot);
}
"""


def _device_code() -> str:
    """The loss layer's definitions from csrc/eh_device.cuh: the kinds, the
    coefficients, and the functions they use."""
    src = (CSRC / "eh_device.cuh").read_text()
    parts = [re.search(r"enum \{ LOSS_SQUARED.*?\};", src, re.S).group(0),
             re.search(r"struct EhLossCoef \{.*?\n\};", src, re.S).group(0)]
    parts.append(re.search(r"__host__ __device__ __forceinline__ bool ehe_loss_is_stat\(.*?\n\}",
                           src, re.S).group(0))
    for name in ("ehe_sign", "ehe_max_nan", "ehe_loss_row", "ehe_stat_loss"):
        parts.append(re.search(r"(template <bool TWO_PASS>\n)?__device__ __forceinline__ float "
                               + name + r"\(.*?\n\}", src, re.S).group(0))
    return "\n\n".join(parts)


@pytest.fixture(scope="module")
def host_loss_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to compile the loss layer with")
    d = tmp_path_factory.mktemp("loss")
    (d / "loss.cuh").write_text(kf.traced_loss(et.pinball(0.9)).header)
    (d / "run.cpp").write_text(HOST_LOSS_STUB % _device_code())
    lib = d / "librun.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib), str(d / "run.cpp"), "-lm"], check=True, cwd=d)
    out = ctypes.CDLL(str(lib))
    out.stat_loss.restype = ctypes.c_float
    out.loss_row.restype = ctypes.c_float
    return out


def _kind(loss):
    return fe.LOSS_KINDS[loss]


@pytest.mark.parametrize("loss", fe.STAT_LOSSES)
def test_the_closed_form_statistic_partials_give_jax_jvp(host_loss_lib, loss):
    """``ehe_stat_loss`` compiled on the host against ``jax.jvp`` of the JAX
    kernel's ``make_stat_loss_g``, a seed per moment, on batch moments of
    several sizes, and at Shh = 0 (a batch whose predictions are all equal),
    where both give NaN partials."""
    rng = np.random.default_rng(1)
    f3 = ctypes.c_float * 3
    for case in range(40):
        n = float(rng.integers(2, 600))
        mu_y, mu_h = rng.uniform(0.5, 6.0), rng.uniform(0.3, 7.0)
        syy, shh = rng.uniform(1.0, 400.0), (0.0 if case == 0 else rng.uniform(0.5, 500.0))
        c = rng.uniform(-0.9, 0.99) * math.sqrt(max(shh, 1e-3) * syy)
        moments = np.array([mu_h, shh, c, syy, mu_y, n], np.float32)
        d = f3()
        g = host_loss_lib.stat_loss(_kind(loss), (ctypes.c_float * 6)(*moments), d)
        jg = make_stat_loss_g(loss, jnp.float32(moments[3]), jnp.float32(moments[4]),
                              jnp.float32(moments[5]))
        prim = tuple(jnp.float32(v) for v in moments[:3])
        want = []
        for k in range(3):
            seeds = tuple(jnp.float32(1.0 if i == k else 0.0) for i in range(3))
            val, t = jax.jvp(jg, prim, seeds)
            want.append(float(t))
        np.testing.assert_allclose(g, float(val), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(list(d), want, rtol=2e-5, atol=1e-7, equal_nan=True,
                                   err_msg=f"{loss}, moments {moments}")


def test_each_row_kind_gives_the_plain_version_s_term_and_cotangent(host_loss_lib):
    """``ehe_loss_row`` compiled on the host (the traced pinball included)
    against the per-row formulas of the plain versions."""
    form = kf.traced_loss(et.pinball(0.9))
    f8, f4 = ctypes.c_float * 8, ctypes.c_float * 4
    rng = np.random.default_rng(2)
    for _ in range(50):
        pred, y = np.float32(rng.normal(3, 2)), np.float32(rng.normal(3, 2))
        m = np.float32(rng.integers(0, 2))
        diff = np.float32((pred - y) * m)
        c0, c1, n = np.float32(rng.uniform(0.001, 1)), np.float32(rng.uniform(0.001, 1)), 37.0
        mu_h, mu_y = np.float32(rng.normal(3, 1)), np.float32(rng.normal(3, 1))
        k = rng.normal(size=3).astype(np.float32)
        coef = f8(c0, c1, n, mu_h, mu_y, *k)
        row = f4(pred, y, m, diff)
        want = {
            "mse": (c0 * diff * diff, c1 * diff),
            "mae": (c0 * abs(diff), c0 * np.sign(diff)),
            "rmse": (0.0, c1 * diff),
            "kgeLoss": (0.0, c0 * (k[0] * (m / np.float32(n)) + k[1] * ((pred * m - mu_h) * m)
                                   + k[2] * ((y - mu_y) * m))),
            fe.ELEMENTWISE: (c0 * float(form.value_fn(torch.tensor(pred * m), torch.tensor(y))) * m,
                             c0 * float(form.grad_fn(torch.tensor(pred * m), torch.tensor(y))) * m),
        }
        for loss, (term, cot) in want.items():
            got_cot = ctypes.c_float()
            got = host_loss_lib.loss_row(_kind(loss), coef, row, ctypes.byref(got_cot))
            np.testing.assert_allclose([got, got_cot.value], [term, cot], rtol=1e-6, atol=1e-7,
                                       err_msg=loss)


def test_a_traced_loss_is_built_beside_the_form_under_one_key(monkeypatch, tmp_path):
    """``form_build`` with a traced loss writes the loss's header under
    ``_build/forms/`` by its hash and names it with
    ``EH_TRACED_LOSS_HEADER`` beside the form's (none for the hand-written
    form); the key holds both, and a build without a loss keeps its key."""
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops.fused_forward import KERNEL_FORMS
    from test_torch_kernel_forms import _fake_nvcc, expo_model

    log = _fake_nvcc(monkeypatch, tmp_path)
    loss = kf.traced_loss(et.pinball(0.9))
    form = kf.traced_form(expo_model, ("ta", "rb", "k"))
    plain = _build.form_build("fused_epoch.cu", KERNEL_FORMS["rbq10"], loss=loss)
    both = _build.form_build("fused_epoch.cu", form, loss=loss)
    alone = _build.form_build("fused_epoch.cu", form)
    header = tmp_path / "build" / "forms" / f"eh_loss_{loss.header_hash}.cuh"
    assert header.read_text() == loss.header
    lines = log.read_text().splitlines()
    assert len(lines) == 3 and len({plain.path, both.path, alone.path}) == 3
    assert f'-DEH_TRACED_LOSS_HEADER="{header.name}"' in lines[0]
    assert "EH_TRACED_FORM_HEADER" not in lines[0]
    assert "EH_TRACED_FORM_HEADER" in lines[1] and "EH_TRACED_LOSS_HEADER" in lines[1]
    assert "EH_TRACED_LOSS_HEADER" not in lines[2]
    key = _build._form_key("fused_epoch.cu", form, None, ())
    assert key == ("fused_epoch.cu", form.header_hash, ())
    assert _build.form_build("fused_epoch.cu", KERNEL_FORMS["rbq10"], loss=loss).seconds == 0.0


def test_every_training_kernel_takes_the_losses_the_jax_kernels_take():
    """The envelopes: kernel 2 every loss of ``_FUSED_LOSSES`` and a traced
    loss; kernel 5 mse, mae, nseLoss, rmse (one target) and a traced loss;
    kernels 3 and 4 every loss of ``_FUSED_LOSSES`` and a traced loss."""
    from easyhybrid_tpu.ops.fused_epoch import _FUSED_LOSSES
    from easyhybrid_tpu.ops.fused_multisite import _MS_LOSSES
    from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
    from easyhybrid_tpu_torch.ops import fused_wide as fw

    assert set(fe.FUSED_LOSSES) == set(_FUSED_LOSSES) and set(fm.MS_LOSSES) == set(_MS_LOSSES)
    *_, tm, _ = epoch_setup(True, hidden=(8,))
    for loss in list(fe.FUSED_LOSSES) + [et.pinball(0.9), et.huber(2.0, normalize="sum")]:
        ll = et.LoggingLoss(training_loss=loss)
        assert fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), ll) is None, loss
    wide = et.construct_hybrid_model(**dict(TWO_SPEC, mechanistic_model=two_outputs,
                                            hidden_layers=[80]), device="cpu")
    for loss in list(_FUSED_LOSSES) + [et.pinball(0.9)]:
        assert fw.fused_wide_unsupported_reason(wide, "adam", et.LoggingLoss(training_loss=loss)) \
            is None
    assert set(fw.WIDE_LOSSES) == set(_FUSED_LOSSES)
    assert "trains mse, mae, rmse, nseLoss" in fw.fused_wide_unsupported_reason(
        wide, "adam", et.LoggingLoss(training_loss="r2"))
    assert set(fl.LSTM_LOSSES) == set(_FUSED_LOSSES)


@pytest.mark.parametrize("loss", ["nseLoss", "rmse", "kgeLoss", "pinball"])
def test_every_loss_keeps_kernel_2s_envelope_and_has_a_geometry(loss):
    """The envelope does not depend on the loss, and every admitted model has
    a geometry at every batch size with the loss's shared memory (the batch
    moments of nseLoss, rmse and the statistic losses) counted."""
    from test_torch_fused_epoch import SWEEP, _smem_bytes
    from test_torch_fused_epoch import _spec as epoch_spec

    mse = et.LoggingLoss(training_loss="mse")
    ll = et.LoggingLoss(training_loss=et.pinball(0.9) if loss == "pinball" else loss)
    for width, n_hidden, norm in SWEEP:
        tm = et.construct_hybrid_model(**epoch_spec(norm, hidden=(width,) * n_hidden))
        admitted = fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), mse) is None
        assert (fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), ll) is None) == admitted
        if not admitted:
            continue
        plan = fe.plan_fused_epoch(tm, ("adam", 0.01), ll)
        for batch in (1, 100, 513, 100_000):
            g = plan.geometry(batch)
            assert _smem_bytes(plan, g) <= fe.MAX_SMEM_BYTES
            if loss == "pinball":  # no shared memory of its own: mse's geometry
                assert g == fe.plan_fused_epoch(tm, ("adam", 0.01), mse).geometry(batch)
