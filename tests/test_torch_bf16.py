"""Mixed precision (``compute_dtype=bfloat16``) in the port: the torch
``Dense`` and ``MLP`` against the JAX package's, and the plain versions of
kernels 1, 2 and 3 (what their wrappers compute on CPU tensors) against the
JAX Pallas kernels in interpret mode, as tests/test_fused.py runs them; the
slice as a whole, ``train()`` against the JAX ``train()``; the refusals that
still hold (another compute dtype in kernels 1-3, any in kernel 5); and the
bf16 builds' shared memory and library.

Tolerances, float32. ``Dense`` and ``MLP``: outputs and bias gradients within
``1e-5·max(1,|ref|)``; the weight gradients and the input cotangents are
bf16 values (the cast's VJP rounds them), and at most 0.1% of their elements
are one bf16 ulp apart: where the two packages' float32 sums, taken in
different orders, fall on either side of a bf16 rounding boundary
(tests/test_fused.py:1373-1381 describes the same flips for the JAX
kernel). Kernels 2 and 3 after two epochs of sgd 0.05, JAX's own bf16 test's
tolerances: parameters atol 5e-5, the loss rtol 1e-4 (sgd: an adaptive rule
turns such a flip into a step of the learning rate, the reason the JAX test
runs sgd). Kernel 1 within ``1e-5·max(1,|ref|)`` on every row but those
where a hidden activation ties at a bf16 rounding boundary, which are held
as chip_smoke.py holds the kernel on the card (``chip_smoke.bf16_rows_held``:
within ``1e-5·max(1,|ref|)`` plus one bf16 ulp on every hidden activation of
the row carried through the model to first order). ``train()`` under sgd as
well, at ``test_train_matches_jax_on_a_small_wide_model``'s tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.models.nn import MLP as JaxMLP
from easyhybrid_tpu.models.nn import Dense as JaxDense
from easyhybrid_tpu.ops.fused_epoch import _pick_batch_chunks
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.ops.fused_epoch import supports_fused_epoch as jax_supports
from easyhybrid_tpu.ops.fused_forward import make_fused_forward as jax_make_fused_forward
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.models import nn as tnn
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.ops import fused_multisite as fm
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training import epoch as tepoch
from test_torch_fused_epoch import CU_SOURCE, assert_model_matches, jax_perms
from test_torch_fused_multinn import SPECS, columns

TOL = 1e-5
ULP_SHARE = 1e-3
PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}
SGD = ("sgd", 0.05)


def assert_bf16_grads(got, want, what):
    """``got`` bf16-valued; at most ULP_SHARE of its elements apart from
    ``want``, each by one bf16 ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy()), what
    apart = got != want
    assert apart.mean() <= ULP_SHARE, (what, int(apart.sum()), got.size)
    diff = np.abs(got[apart].astype(np.float64) - want[apart])
    ulp = cs.bf16_ulp(torch.from_numpy(np.maximum(np.abs(got[apart]), np.abs(want[apart]))))
    assert np.all(diff <= ulp.double().numpy()), what


def assert_close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), (
        what, float(np.abs(got - want).max()) if got.size else 0.0)


def _jax_grads(fn, params, x, ct):
    out, vjp = jax.vjp(fn, params, x)
    return out, vjp(ct)


def test_dense_matches_jax_and_rounds_like_its_cast():
    """A (64, 256) x (256, 128) layer: the forward of bf16 operands summed in
    float32 (the parent's bf16 product was up to 0.0155 from JAX's on values
    up to 6.47); the cast VJP's bf16 weight and input gradients."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    ct = rng.normal(size=(64, 128)).astype(np.float32)
    jd = JaxDense(256, 128, compute_dtype=jnp.bfloat16)
    params, _ = jd.init(jax.random.PRNGKey(1))
    out, (gp, gx) = _jax_grads(lambda p, h: jd.apply(p, {}, h)[0], params, x, ct)

    td = tnn.Dense(256, 128, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        td.weight.copy_(torch.from_numpy(np.asarray(params["w"]).T.copy()))
        td.bias.copy_(torch.from_numpy(np.asarray(params["b"])))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = td(tx)
    y.backward(torch.from_numpy(ct))
    assert y.dtype == torch.float32
    assert_close(y.detach().numpy(), out, "forward")
    assert_bf16_grads(td.weight.grad.numpy().T, gp["w"], "weight gradient")
    assert_close(td.bias.grad.numpy(), gp["b"], "bias gradient")
    assert_bf16_grads(tx.grad.numpy(), gx, "input cotangent")


@pytest.mark.parametrize("norm", [False, "static", True], ids=str)
def test_mlp_matches_jax(norm):
    """The MLP [2 -> 32 -> 16 -> 1] with an input norm of each kind, forward
    and every parameter's gradient."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(128, 2)) * 3.0 + 1.0).astype(np.float32)
    ct = rng.normal(size=(128, 1)).astype(np.float32)
    jm = JaxMLP(2, 1, hidden=(32, 16), activation="swish", input_batchnorm=norm,
                compute_dtype=jnp.bfloat16)
    params, state = jm.init(jax.random.PRNGKey(2))
    if norm:
        state = {"norm": {"mean": jnp.asarray([1.0, 0.5]), "var": jnp.asarray([9.0, 4.0])}}
    training = norm is True
    out, (gp, _) = _jax_grads(lambda p, h: jm.apply(p, state, h, training=training)[0],
                              params, x, ct)
    tm = tnn.MLP(2, 1, hidden=(32, 16), activation="swish", input_batchnorm=norm,
                 compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for layer, lp in zip(tm.layers, params["layers"]):
            layer.weight.copy_(torch.from_numpy(np.asarray(lp["w"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(lp["b"])))
        if norm:
            tm.norm.mean.copy_(torch.tensor([1.0, 0.5]))
            tm.norm.var.copy_(torch.tensor([9.0, 4.0]))
    tm.train(training)
    y = tm(torch.from_numpy(x))
    y.backward(torch.from_numpy(ct))
    assert_close(y.detach().numpy(), out, "forward")
    for i, (layer, lp) in enumerate(zip(tm.layers, gp["layers"])):
        assert_bf16_grads(layer.weight.grad.numpy().T, lp["w"], f"layer {i} weight gradient")
        assert_close(layer.bias.grad.numpy(), lp["b"], f"layer {i} bias gradient")
    if norm:
        assert_close(tm.norm.scale.grad.numpy(), gp["norm"]["scale"], "norm scale gradient")
        assert_close(tm.norm.bias.grad.numpy(), gp["norm"]["bias"], "norm bias gradient")


def _spec(norm="static", hidden=(16, 16), **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        parameters=PARAMS, neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=list(hidden), activation="swish", scale_nn_outputs=True,
        input_batchnorm=norm)
    spec.update(kw)
    return spec


def rbq10(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def _pair(spec, jax_fn=rbq10, torch_fn=et.rbq10):
    jm = eh.construct_hybrid_model(**spec, mechanistic_model=jax_fn, compute_dtype=jnp.bfloat16)
    tm = et.construct_hybrid_model(**spec, mechanistic_model=torch_fn,
                                   compute_dtype=torch.bfloat16, device="cpu")
    return jm, tm


def setup(spec, cols, batch, **fns):
    """The same bf16 model in both packages from the JAX parameters (the
    static norm fitted), and the same epoch tensors for each."""
    jm, tm = _pair(spec, **fns)
    data = et.prepare_data(tm, cols)
    params, state = jm.init(jax.random.PRNGKey(0))
    state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    jt = jax.device_put(jax_epoch_tensors(eh.prepare_data(jm, ((data.x, data.forcing), data.y)),
                                          batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


def _run_both(jm, params, state, jt, tm, tt, make, loss, opt=SGD, shuffle=True, epochs=2):
    jll = eh.LoggingLoss(training_loss=loss, loss_types=(loss,))
    assert jax_supports(jm, opt, jll)
    key = jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)
    fn = make(tm, opt, et.LoggingLoss(training_loss=loss, loss_types=(loss,)), shuffle=shuffle,
              epochs_per_call=epochs)
    assert fn.plan.bf16
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, got_loss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                          perms=jax_perms(shuffle, key, epochs, nb, batch))
    assert not torch.equal(fn.plan.pack(tm).params, p0.params)
    assert_model_matches(tm, jp, js, 5e-5)
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-4)
    assert int(os_["t"][0]) == int(jos["t"][0]) == epochs * nb


@pytest.mark.parametrize("norm,loss", [("static", "mse"), (True, "mse"), ("static", "nseLoss")],
                         ids=str)
def test_kernel_2_reference_matches_the_jax_kernel(norm, loss):
    """Kernel 2's plain version, hidden (16, 16), against the JAX kernel."""
    _run_both(*setup(_spec(norm), et.rbq10_columns(512, seed=42), 128), et.make_fused_epoch, loss)


def test_kernel_2_reference_matches_the_jax_kernel_on_multinn_branches():
    """The ExpoHybrid model's two single-predictor branches (the JAX kernel
    promotes their size-1 bf16 operands to float32: the same numbers)."""
    spec, jax_fn, torch_fn = SPECS["expo"]
    spec = {**spec, "hidden_layers": [8, 8]}
    _run_both(*setup(spec, columns("expo", 512, 13), 128, jax_fn=jax_fn, torch_fn=torch_fn),
              et.make_fused_epoch, "mse")


@pytest.mark.parametrize("norm,loss", [("static", "mse"), (True, "mse"), ("static", "nseLoss")],
                         ids=str)
def test_kernel_3_reference_matches_the_jax_unchunked_kernel(norm, loss):
    """Kernel 3's plain version, hidden (32, 16), 768 rows in batches of 256,
    against the JAX kernel with each batch whole."""
    jm, params, state, jt, tm, tt = setup(_spec(norm, (32, 16)),
                                          et.rbq10_columns(768, seed=42), 256)
    jll = eh.LoggingLoss(training_loss=loss, loss_types=(loss,))
    assert _pick_batch_chunks(jm, [jm.nn], jt, jll) == 1
    _run_both(jm, params, state, jt, tm, tt, et.make_fused_wide_epoch, loss)


def test_kernel_1_reference_matches_the_jax_kernel():
    """Within 1e-5·max(1,|ref|) on every row but those where an activation
    ties at a bf16 rounding boundary (at most four times their expected
    share of the rows), each held within that plus its one-ulp flip bound,
    as chip_smoke.py holds the kernel (``bf16_rows_held``)."""
    spec = _spec("static", (16, 16))
    jm, tm = _pair(spec)
    data = eh.prepare_data(jm, eh.gen_rbq10_data(512, seed=0))
    params, state = jm.init(jax.random.PRNGKey(0))
    state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    rows = eh.prepare_data(jm, eh.gen_rbq10_data(256, seed=5))
    jfwd = jax_make_fused_forward(jm, params, state, batch_size=128, interpret=True)
    want = jfwd(jnp.asarray(rows.x), {k: jnp.asarray(v) for k, v in rows.forcing.items()})
    fn = et.make_fused_forward(tm, batch_size=128)
    assert fn.plan.bf16
    x = torch.tensor(rows.x)
    forcing = {k: torch.tensor(v) for k, v in rows.forcing.items()}
    got = fn(x, forcing)
    assert set(want) <= set(got)
    cs.bf16_rows_held("kernel 1's plain version against the JAX kernel",
                      {k: got[k] for k in want}, {k: torch.from_numpy(np.asarray(want[k]))
                                                  for k in want}, tm, x, forcing)
    # and the port's module forward, the repaired Dense
    tm.eval()
    with torch.no_grad():
        plain = tm(torch.tensor(rows.x), {k: torch.tensor(v) for k, v in rows.forcing.items()})
    assert_close(got["reco"].numpy(), plain["reco"].numpy(), "module forward")


def test_train_matches_jax_on_a_small_wide_bf16_model():
    """The slice as a whole: ``train()`` with ``use_kernel=True`` on a bf16
    model too wide for kernel 2 (kernel 3's plain version behind the gate)
    against the JAX ``train()`` from the same parameters."""
    spec = _spec("static", (128, 64))
    kw = dict(nepochs=6, batchsize=128, optimizer=SGD, shuffle_each_epoch=False,
              show_progress=False, loss_types=["mse"], eval_every=2)
    jm, tm = _pair(spec)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cols = et.rbq10_columns(512, seed=42)
    jr = eh.train(jm, cols, train_from=jax.tree.map(np.array, init), **kw)
    tr = et.train(tm, cols, train_from=init, use_kernel=True, **kw)
    assert tr.epoch_path == "cuda_fused_wide" and "exactness gate passed" in tr.engine_reason
    assert len(tr.val_history) == len(jr.val_history) == 4
    for got, want in ((tr.train_history, jr.train_history), (tr.val_history, jr.val_history)):
        for g, w in zip(got, want):
            for metric in w:
                for k in w[metric]:
                    np.testing.assert_allclose(g[metric][k], w[metric][k], rtol=1e-4, atol=1e-5)
    assert tr.best_epoch == jr.best_epoch
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)
    assert int(tr.opt_state["t"][0]) == 6 * 4


def test_float16_is_refused_by_kernels_1_to_3():
    reason = "compute_dtype=torch.float16 (the kernels take bfloat16 only"
    small = et.construct_hybrid_model(**_spec(), mechanistic_model=et.rbq10,
                                      compute_dtype=torch.float16, device="cpu")
    wide = et.construct_hybrid_model(**_spec(hidden=(128, 64)), mechanistic_model=et.rbq10,
                                     compute_dtype=torch.float16, device="cpu")
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    assert reason in ff.fused_forward_unsupported_reason(small)
    assert reason in fe.fused_epoch_unsupported_reason(small, "adam", ll)
    assert reason in fw.fused_wide_unsupported_reason(wide, "adam", ll)
    for ok in (ff.fused_forward_unsupported_reason(_pair(_spec())[1]),
               fe.fused_epoch_unsupported_reason(_pair(_spec())[1], "adam", ll),
               fw.fused_wide_unsupported_reason(_pair(_spec(hidden=(128, 64)))[1], "adam", ll)):
        assert ok is None


def test_a_bf16_multisite_model_is_refused_by_kernel_5():
    base = et.construct_hybrid_model(**_spec(), mechanistic_model=et.rbq10,
                                     compute_dtype=torch.bfloat16, device="cpu")
    model = et.MultiSiteHybridModel(base, n_sites=4, device="cpu")
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    reason = fm.fused_multisite_unsupported_reason(model, "adam", ll)
    assert reason is not None and "the multi-site kernel runs float32" in reason
    assert fe.fused_engine(model).epoch_path == "cuda_fused_multisite"


def test_bf16_plans_ask_for_the_bf16_builds(monkeypatch):
    """A bf16 model's plans carry the flag, kernel 2's counts its rounded
    copy of the parameters (the launcher's n_padded more floats), and each
    wrapper asks for the source's -DEH_BF16 build; a float32 model keeps the
    package's library."""
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    f32 = fe.plan_fused_epoch(et.construct_hybrid_model(**_spec(), mechanistic_model=et.rbq10,
                                                        device="cpu"), "adam", ll)
    bf = fe.plan_fused_epoch(_pair(_spec())[1], "adam", ll)
    assert bf.bf16 and not f32.bf16
    g = bf.geometry(512)
    assert (bf.smem_bytes(g.threads, g.stages, g.moments_shared)
            == f32.smem_bytes(g.threads, g.stages, g.moments_shared) + 4 * bf.branch_layout.n_padded)
    src = CU_SOURCE.read_text()
    assert "(ehe_smem_floats(args) + (EH_BF16_BUILD ? (size_t)args->n_padded : 0))" in src
    asked = []
    monkeypatch.setattr(_build, "form_library",
                        lambda source, form, *d, loss=None: asked.append((source, d)) or "bf16")
    monkeypatch.setattr(_build, "load_library", lambda: asked.append("package") or "package")
    assert _build.kernel_library("fused_wide.cu", ff.KERNEL_FORMS["rbq10"]) == "package"
    assert _build.kernel_library("fused_wide.cu", ff.KERNEL_FORMS["rbq10"], bf16=True) == "bf16"
    assert _build.kernel_library("fused_epoch.cu", ff.KERNEL_FORMS["rbq10"], bf16=True,
                                 width=bf.width) == "bf16"
    assert asked == ["package", ("fused_wide.cu", ("-DEH_BF16",)),
                     ("fused_epoch.cu", ("-DEH_BF16", f"-DEH_ONLY_WIDTH={bf.width}"))]
