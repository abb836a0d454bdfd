"""Kernel 4's plain version (``fused_lstm_reference``, what the wrapper
computes on CPU tensors) against the JAX package's fused LSTM epoch kernel
in interpret mode and against the port's torch epoch; the envelope and its
reasons; the window cap; the exactness gate; ``train(sequence_kwargs=...)``
on both engines; and the ctypes mirror of the CUDA argument struct.

Tolerances, float32: parameters after two or three epochs atol 5e-5, rtol
5e-4 against the JAX kernel (as tests/test_fused.py holds it against the JAX
epoch: a window is a chain of ``T`` cells forward and ``T`` backward), and
atol 1e-5, rtol 1e-4 against the port's own torch epoch, which shares
torch's transcendentals."""

import copy
import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.data.prepare import HybridData as JaxHybridData
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.data.sequences import split_into_sequences
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from test_torch_fused_epoch import RULES, assert_slots_match, assert_torch_slots_match

CU_SOURCE = Path(fl.__file__).resolve().parent.parent / "csrc" / "fused_epoch_lstm.cu"


def _ll(loss="mse", **kw):
    return et.LoggingLoss(training_loss=loss, loss_types=(loss,), **kw)


def _spec(norm="static", hidden=4, **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(kw)
    return spec


def setup(norm="static", n=260, batch=64, steps=6, out_steps=2, nan_frac=0.1, hidden=4,
          mask_first=0, **kw):
    """The same model in both packages from the JAX initial parameters, and
    the same windows (NaN targets kept) as epoch tensors of both."""
    spec = _spec(norm, hidden, **kw)
    jm = eh.construct_hybrid_model(**spec)
    tm = et.construct_hybrid_model(**spec, device="cpu")
    cols = et.rbq10_columns(n, seed=21, nan_frac=nan_frac)
    cols["reco"][:mask_first] = np.nan
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    data = split_into_sequences(rows, input_window=steps, output_window=out_steps)
    jdata = JaxHybridData(x=data.x, forcing=data.forcing, y=data.y)
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        state = jax_fit_input_norm(jm, state, jdata)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    et.load_jax_params(tm, np_tree(params), np_tree(state))
    jt = jax.device_put(jax_epoch_tensors(jdata, batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


def jax_perms(shuffle, key, epochs, nb, batch):
    if not shuffle or nb == 1:
        return None
    n = nb * batch if shuffle is True else nb
    keys = [key] if epochs == 1 else list(jax.random.split(key, epochs))
    return np.stack([np.asarray(jax_permutation(k, n)) for k in keys])


CASES = [
    # loss, optimizer, shuffle, epochs, norm, setup kwargs
    ("mse", ("adam", 0.01), False, 3, "static", {}),
    ("mae", ("sgd", 0.05), False, 3, "static", {}),
    ("nseLoss", ("adam", 0.01), True, 2, "static", {"out_steps": 1}),
    ("mse", ("adam", 0.02), True, 2, False, {"nan_frac": 0.3}),
    ("nseLoss", ("adam", 0.01), "batches", 2, "static", {"steps": 5, "out_steps": 5}),
    ("mae", ("adam", 0.01), True, 2, "static", {"agg": "mean", "nan_frac": 0.3}),
]
# one case per optimizer rule besides adam and plain sgd: 8 steps (radam
# rectifies from step 6)
RULE_CASES = [("mse", opt, True, 2, "static", {}) for opt in RULES]


@pytest.mark.parametrize("loss,opt,shuffle,epochs,norm,kw", CASES + RULE_CASES, ids=str)
def test_reference_matches_jax_fused_lstm_epoch(loss, opt, shuffle, epochs, norm, kw):
    kw = dict(kw)
    agg = kw.pop("agg", "sum")
    jm, params, state, jt, tm, tt = setup(norm, **kw)
    key = jax.random.PRNGKey(5)
    jll = eh.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)

    fn = et.make_fused_lstm_epoch(tm, opt, _ll(loss, agg=agg), shuffle=shuffle,
                                  epochs_per_call=epochs)
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                       perms=jax_perms(shuffle, key, epochs, nb, batch))
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(js)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)  # static: untouched
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert int(os_["t"][0]) == int(jos["t"][0])
    assert_slots_match(fn.plan, tm, os_, jos, atol=1e-5, rtol=1e-3)  # the moments' tolerance


@pytest.mark.parametrize("loss,opt,shuffle,epochs,norm,kw", CASES + RULE_CASES, ids=str)
def test_reference_matches_the_torch_epoch(loss, opt, shuffle, epochs, norm, kw):
    kw = dict(kw)
    agg = kw.pop("agg", "sum")
    *_, tm, tt = setup(norm, **kw)
    with torch.no_grad():  # the initial zeros and ones would hide these
        tm.nn.b.add_(0.1)
        if norm:
            tm.nn.norm.scale.mul_(1.3)
            tm.nn.norm.bias.add_(0.2)
    twin = copy.deepcopy(tm)
    ll = _ll(loss, agg=agg)
    perms = tepoch.perms_for_epochs(shuffle, tt, epochs, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_lstm_epoch(tm, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    p0 = fn.plan.pack(tm)
    packed, os_, loss_f = fn(p0, fe.init_fused_opt_state(p0, opt), tt, perms=perms)
    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, ll, optim, shuffle=shuffle, epochs_per_call=epochs)
    state, loss_t = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=1e-5, rtol=1e-4)
    assert torch.equal(packed.bn, want.bn)
    np.testing.assert_allclose(float(loss_f), float(loss_t), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])
    assert_torch_slots_match(fn.plan, opt, os_, state, atol=1e-5, rtol=1e-3)


def test_batches_without_a_valid_target_change_nothing():
    """The first two unshuffled batches are fully masked: no step is counted
    for them, Adam's bias correction (1 - b1^0 = 0) leaks no NaN, and the
    result is the JAX kernel's."""
    jm, params, state, jt, tm, tt = setup(mask_first=2 * 64 + 8, nan_frac=0.0)
    assert float(tt.mask["reco"][:2].sum()) == 0.0
    jfn = jax_fused_epoch(jm, state, ("adam", 0.01), eh.LoggingLoss(training_loss="mse"),
                          shuffle=False)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params), state, jt,
                            jax.random.PRNGKey(0))
    fn = et.make_fused_lstm_epoch(tm, ("adam", 0.01), _ll(), shuffle=False)
    _, os_, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm)), tt)
    assert int(os_["t"][0]) == int(jos["t"][0]) == tt.weight.shape[0] - 2
    assert all(bool(torch.isfinite(p).all()) for p in tm.parameters())
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_mae_cotangent_is_zero_at_a_zero_residual():
    """sign(0) = 0: a window whose prediction equals its target adds nothing."""
    *_, tm, tt = setup(nan_frac=0.0, out_steps=1)
    plan = fl.plan_fused_lstm(tm, ("sgd", 0.1), _ll("mae"))
    data = fl.fused_lstm_data(plan, tt)
    idx = torch.arange(8)
    x, forcing = data.x[idx], [c[idx] for c in data.forcing]
    tm.eval()
    with torch.no_grad():
        pred = tm(x, {"ta": forcing[0]})["reco"][:, -1:]
    packed = plan.pack(tm)
    g, loss, valid = fl.lstm_reference_grads(plan, packed.params, packed.bn, plan.consts, x,
                                             forcing, [pred], [torch.ones_like(pred)])
    assert bool(valid) and float(loss) == 0.0 and float(g.abs().max()) == 0.0


@pytest.mark.parametrize("overrides,optimizer,logging,reason", [
    ({"input_batchnorm": True}, "adam", _ll(), "trainable input BatchNorm"),
    ({}, "adam", et.LoggingLoss(extra_loss=et.l2_extra_loss()), "extra_loss"),
    ({}, "adam", _ll("rmse"), "trains mse, mae, nseLoss"),
    ({}, "adam", _ll("pearsonLoss"), "trains mse, mae, nseLoss"),
    ({}, ("rmsprop", {"centered": True}), _ll(), "centered"),
    ({}, {"nn": ("adam", 0.01)}, _ll(), "per-branch"),
    ({}, "adam", _ll(agg=lambda xs: xs[0]), "agg"),
    ({"hidden_layers": {"lstm": 65}}, "adam", _ll(), "cap of 64"),
    ({"hidden_layers": [8]}, "adam", _ll(), "not an LSTMNet"),
    ({"mechanistic_model": lambda *, ta, rb, Q10: {"reco": rb * Q10 ** (0.1 * (ta - 15.0))}},
     "adam", _ll(), "no kernel form"),
])
def test_envelope_reasons(overrides, optimizer, logging, reason):
    tm = et.construct_hybrid_model(**_spec(**overrides), device="cpu")
    got = fl.fused_epoch_lstm_unsupported_reason(tm, optimizer, logging)
    assert got is not None and reason in got
    assert not et.supports_fused_epoch_lstm(tm, optimizer, logging)


def test_the_mlp_kernels_refuse_an_lstm_by_name():
    tm = et.construct_hybrid_model(**_spec(), device="cpu")
    assert "LSTMNet" in ff.fused_forward_unsupported_reason(tm)
    assert "LSTMNet" in fe.fused_epoch_unsupported_reason(tm, "adam", _ll())
    assert not et.supports_fused_forward(tm) and not et.supports_fused_epoch(tm, "adam", _ll())


def test_the_window_is_bounded_by_shared_memory():
    tm = et.construct_hybrid_model(**_spec(hidden=16), device="cpu")
    # the largest tile whose checkpoints fit beside the parameters and gradients
    assert [fl.lstm_tile_rows(tm, t) for t in (10, 32, 64, 128, 256)] == [64, 32, 16, 8, None]
    sizes = fl._sizes(tm)
    for t in (10, 32, 64, 128):
        rows = fl.lstm_tile_rows(tm, t)
        assert sizes.smem_bytes(t, 1, rows) <= fe.MAX_SMEM_BYTES < sizes.smem_bytes(t, 1, 2 * rows)
    # 10 steps of (x, xhat, h, c) + dz, dh, dc + one head cotangent + Q10 + the norm's gradients
    assert sizes.res_floats(10, 1) == 10 * (2 + 2 + 16 + 16) + 6 * 16 + 1 + 1 + 4
    *_, tm4, tt = setup(steps=6)
    assert et.supports_fused_epoch_lstm(tm4, "adam", _ll(), tt)
    cols = et.rbq10_columns(400, seed=1)
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    long = tepoch.epoch_tensors_to(build_epoch_tensors(
        split_into_sequences(rows, input_window=256, output_window=1), 32), "cpu")
    got = fl.fused_epoch_lstm_unsupported_reason(tm, "adam", _ll(), long)
    assert "a window of 256 steps at hidden size 16 needs" in got and "232448" in got
    fn = et.make_fused_lstm_epoch(tm, "adam", _ll())
    assert fn.plan.sizes.tile_rows(256, 1) is None and fn.plan.sizes == sizes
    # the hidden size 64 of the caps fits with its moments in device memory
    wide = et.construct_hybrid_model(**_spec(hidden=64), device="cpu")
    assert fl.lstm_tile_rows(wide, 10) == 8 and fl.plan_fused_lstm(wide, "adam", _ll()).width == 64
    # row-shaped tensors are refused by shape
    flat = tepoch.epoch_tensors_to(build_epoch_tensors(rows, 32), "cpu")
    assert "windowed targets" in fl.fused_epoch_lstm_unsupported_reason(tm, "adam", _ll(), flat)


@pytest.mark.parametrize("loss,shuffle,epochs", [("mse", False, 1), ("nseLoss", True, 3),
                                                 ("mae", "batches", 2)])
def test_gate_passes_on_the_plain_version(loss, shuffle, epochs):
    *_, tm, tt = setup(hidden=8)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), _ll(loss), tt,
                                         epochs_per_call=epochs, shuffle=shuffle)
    assert ok and worst < 1e-4
    for k, v in tm.state_dict().items():  # the gate leaves the model as it was
        assert torch.equal(v, before[k])


def test_gate_fails_on_a_corrupted_gradient(monkeypatch):
    *_, tm, tt = setup()
    real = fl.lstm_reference_grads

    def corrupted(*args):
        g, loss, valid = real(*args)
        return g * 1.5, loss, valid

    monkeypatch.setattr(fl, "lstm_reference_grads", corrupted)
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), _ll(), tt)
    assert not ok and worst > 0.1


def test_kernel_source_and_ctypes_mirror_agree():
    src = CU_SOURCE.read_text()
    assert '#include "eh_device.cuh"' in src and "--use_fast_math" in src  # only to disown it
    defines = dict(re.findall(r"#define (EH_LSTM_\w+) (\d+)", src))
    assert int(defines["EH_LSTM_MAX_OUT"]) == fl.MAX_LSTM_OUT
    assert int(defines["EH_LSTM_MAX_CLUSTER"]) == fl.MAX_CLUSTER
    assert f"#define EHL_MAX_THREADS {fl._MAX_THREADS}" in src
    body = re.search(r"struct EhFusedLstmArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body))
    assert fields == [name for name, _ in fl._Args._fields_]
    assert fields[-7:] == ["threads", "lanes", "windows", "cluster", "tiles", "stages", "res_floats"]
    assert ctypes.sizeof(fl._Args) % 8 == 0
    for width in fl._HIDDEN_WIDTHS:
        assert f"case {width}: return ehl_launch<{width}>" in src
    for c in (1, 2, 4, 8):
        assert f"c != {c}" in src
    assert "c != EH_LSTM_MAX_CLUSTER" in src
    assert "atomicAdd" not in src and "cublas" not in src.lower()
    stamps = re.search(r"#define EHL_N_STAMPS (\d+)", src).group(1)
    assert int(stamps) == len(fl.STAGES) + 1
    # the cluster launch and the folding tree are the shared header's, not copies
    header = CU_SOURCE.with_name("eh_device.cuh").read_text()
    for name in ("eh_launch_cluster", "ehe_fold", "ehe_warp_sum", "ehe_cp_async4"):
        assert name in header
    assert "cudaLaunchKernelEx" not in src + CU_SOURCE.with_name("fused_epoch.cu").read_text()


def test_smem_formula_matches_the_source():
    """``_Sizes.smem_floats`` against ``ehl_smem_floats``'s return
    expression, parsed from the source and evaluated on the same numbers."""
    src = CU_SOURCE.read_text()
    body = re.search(r"static size_t ehl_smem_floats\(.*?\{(.*?)\n\}", src, re.S).group(1)
    expr = re.search(r"return (.*?);", body, re.S).group(1).replace("(size_t)", "")
    expr = re.sub(r"a->(\w+)", r"a_\1", " ".join(expr.split()))
    rng = np.random.default_rng(0)
    for _ in range(60):
        f, h, p, g, k, t = (int(rng.integers(lo, hi)) for lo, hi in
                            ((1, 65), (1, 65), (1, 9), (0, 9), (0, 5), (1, 5)))
        norm = bool(rng.integers(0, 2))
        steps = int(rng.integers(1, 300))
        out_steps = int(rng.integers(1, steps + 1))
        lanes = int(rng.choice([8, 16, 32]))
        windows = int(rng.integers(1, 65))
        n_params = (2 * f if norm else 0) + 4 * h * (f + h + 1) + p * (h + 1) + g
        sizes = fl._Sizes(n_params, f, h, p, g, k, t, norm)
        names = dict(F=f, P=p, G=g, K=k, T=t, nw=-(-windows * lanes // 32), W=windows, TO=out_steps,
                     a_n_params=n_params, a_res_floats=sizes.pair_features(), a_n_steps=steps,
                     a_lanes=lanes, ehl_ld=lambda cols: cols | 1, min=min)
        want = eval(expr, {"__builtins__": {}}, names)  # noqa: S307 - the repository's own source
        assert want == sizes.smem_floats(steps, out_steps, windows, lanes)


def _plan(hidden=16, norm="static", loss="nseLoss"):
    tm = et.construct_hybrid_model(**_spec(norm, hidden), device="cpu")
    return fl.plan_fused_lstm(tm, ("adam", 0.01), _ll(loss))


def test_geometry_of_the_main_and_bench_shapes():
    """The main path's 128 windows over a cluster of 8 blocks of 16 windows,
    a window in 16 lanes; the bench's 512 over the non-portable cluster of 16
    blocks, 2 tiles of 16 each, or 8 blocks of 4 tiles where the plan says."""
    plan = _plan(16)
    assert plan.geometry(128, 10, 1) == fl.LSTMGeometry(256, 16, 16, 8, 1, 0)
    bench = _plan(16, norm=False, loss="mse")
    assert bench.geometry(512, 10, 1) == fl.LSTMGeometry(256, 16, 16, 16, 2, 0)
    forced = dataclasses.replace(bench, cluster=8)
    assert forced.geometry(512, 10, 1) == fl.LSTMGeometry(256, 16, 16, 8, 4, 0)
    assert _plan(64).geometry(128, 10, 1).lanes == 32 and _plan(8).geometry(128, 10, 1).lanes == 8
    # a window too long for a whole warp's windows takes a warp that is not full
    assert _plan(8, norm=False, loss="mse").geometry(128, 300, 300) == fl.LSTMGeometry(
        32, 8, 3, 16, 3, 0)


@pytest.mark.parametrize("hidden", [1, 4, 8, 16, 24, 32, 48, 64])
def test_geometry_is_a_pure_function_that_covers_the_batch(hidden):
    plan = _plan(hidden)
    twin = _plan(hidden)
    for batch in (1, 7, 31, 100, 128, 512, 1000, 5000):
        for steps, out_steps in ((1, 1), (10, 1), (10, 10), (64, 1)):
            if plan.sizes.tile_rows(steps, out_steps) is None:
                continue
            g = plan.geometry(batch, steps, out_steps)
            assert g == plan.geometry(batch, steps, out_steps) == twin.geometry(batch, steps, out_steps)
            assert g.lanes == min(32, plan.width) and 32 % g.lanes == 0
            assert g.threads % 32 == 0 and g.threads == -(-g.windows * g.lanes // 32) * 32
            assert g.threads <= fl._MAX_THREADS and g.stages == 0
            assert g.cluster in (1, 2, 4, 8, 16) and g.cluster * g.windows * g.tiles >= batch
            block = -(-batch // g.cluster)
            assert (g.tiles - 1) * g.windows < block <= g.tiles * g.windows
            assert plan.sizes.smem_floats(steps, out_steps, g.windows, g.lanes) * 4 <= fe.MAX_SMEM_BYTES


def _first_kernel_rows(sizes, steps, out_steps):
    """The envelope of the kernel's first form, frozen: the largest of 128,
    64, 32, 16 and 8 checkpoint rows that fit one block of 512 threads."""
    f = 2 * sizes.f if sizes.norm else sizes.f
    res = (steps * (2 * sizes.h + f) + 6 * sizes.h + out_steps * sizes.p + sizes.g
           + (2 * sizes.f if sizes.norm else 0))
    fixed = (2 * sizes.n_params + 2 * sizes.f + (2 * sizes.p + 2 * sizes.g + sizes.k)
             + (sizes.g + sizes.k) + sizes.g + 2 * sizes.f + sizes.t + 4 + 2 * 512)
    for rows in (128, 64, 32, 16, 8):
        if 4 * (fixed + res * (rows + 1)) <= 227 * 1024:
            return rows
    return None


@pytest.mark.parametrize("hidden,norm", [(h, n) for h in (1, 5, 8, 16, 17, 32, 48, 64)
                                         for n in (True, False)], ids=str)
def test_envelope_is_unchanged_and_every_admitted_window_has_a_geometry(hidden, norm):
    """The redesign admits and refuses exactly the windows the first kernel
    did, over features, outputs, globals, fixed values, targets and windows,
    and every admitted one fits shared memory at every batch size."""
    base = _plan(hidden, norm="static" if norm else False)
    width = base.width
    for f, p, g, k, t in ((1, 1, 1, 0, 1), (2, 1, 1, 0, 1), (7, 8, 16, 0, 4), (33, 4, 8, 8, 4),
                          (64, 8, 0, 2, 2)):
        n_params = (2 * f if norm else 0) + 4 * hidden * (f + hidden + 1) + p * (hidden + 1) + g
        plan = dataclasses.replace(
            base, in_dim=f, out_dim=p, n_params=n_params, global_names=("g",) * g,
            fixed_names=("k",) * k, target_names=("y",) * t)
        assert plan.width == width and plan.sizes.n_params == n_params
        for steps in (1, 2, 6, 10, 32, 64, 100, 128, 200, 256, 400, 1000):
            for out_steps in sorted({1, steps}):
                frozen = _first_kernel_rows(plan.sizes, steps, out_steps)
                assert plan.sizes.tile_rows(steps, out_steps) == frozen
                if frozen is None:
                    continue
                for batch in (1, 128, 512, 1000):
                    geo = plan.geometry(batch, steps, out_steps)
                    assert plan.sizes.smem_floats(steps, out_steps, geo.windows,
                                                  geo.lanes) * 4 <= fe.MAX_SMEM_BYTES


def test_kernel_arguments_pack_the_plan():
    tm = et.construct_hybrid_model(**_spec(hidden=16), device="cpu")
    plan = fl.plan_fused_lstm(tm, ("adam", 0.01), _ll("nseLoss", agg="mean"))
    a = fl._Args.from_buffer_copy(plan.args_bytes)
    n_params = 2 * 2 + 64 * 2 + 64 * 16 + 64 + 16 + 1 + 1
    assert plan.n_params == a.n_params == n_params == fl._sizes(tm).n_params
    assert (a.n_features, a.hidden, a.n_out, a.norm_mode, a.optimizer.rule) == (2, 16, 1, 1, 1)
    assert (a.p_off_wi, a.p_off_wh, a.p_off_b, a.p_off_hw, a.p_off_hb, a.p_off_g) == (
        4, 132, 1156, 1220, 1236, 1237)
    assert a.loss_kind == 0 and a.loss_nse == 1 and a.agg_scale == 1.0
    assert a.optimizer.one_minus_b1 == np.float32(1.0 - 0.9) and plan.width == 16
    assert [name for name, _, _ in plan.segments] == [
        "nn.norm.scale", "nn.norm.bias", "nn.wi", "nn.wh", "nn.b", "nn.head.weight",
        "nn.head.bias", "globals.Q10"]
    packed = plan.pack(tm)
    assert packed.params.numel() == n_params and packed.bn.numel() == 4
    twin = et.construct_hybrid_model(**_spec(hidden=16), device="cpu")
    plan.unpack(packed, twin)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k])
    assert fl.plan_fused_lstm(tm, "sgd", _ll("mae")).args_bytes != plan.args_bytes


SEQ = dict(input_window=6, output_window=2, lead_time=0)


@pytest.mark.parametrize("loss", ["mse", "nseLoss"])
def test_train_on_windows_runs_both_engines_alike(loss):
    """``use_kernel=True`` on a CPU model runs the plain version behind the
    gate; it follows the torch engine (same seed, same permutations)."""
    cols = et.rbq10_columns(300, seed=11)
    results = {}
    for use_kernel in (True, False):
        tm = et.construct_hybrid_model(**_spec(hidden=8),
                                       generator=torch.Generator().manual_seed(0), device="cpu")
        results[use_kernel] = et.train(
            tm, cols, nepochs=4, eval_every=2, batchsize=32, optimizer=("adam", 0.01),
            training_loss=loss, loss_types=[loss, "mse"], show_progress=False,
            sequence_kwargs=SEQ, use_kernel=use_kernel)
    fused, plain = results[True], results[False]
    assert fused.epoch_path == "cuda_fused_lstm" and "exactness gate passed" in fused.engine_reason
    assert plain.epoch_path == "torch" and "use_kernel=False" in plain.engine_reason
    assert len(fused.train_history) == 3
    for k, v in plain.params.items():
        np.testing.assert_allclose(fused.params[k].numpy(), v.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(fused.best_loss, plain.best_loss, rtol=1e-4)
    assert {"sample", "step", "reco"} <= set(fused.val_obs.columns)
    assert sorted(fused.val_pred["step"].unique()) == [0, 1]
    assert len(fused.val_pred) == len(fused.val_obs) == 2 * (fused.val_obs["sample"].max() + 1)
    assert np.isfinite(fused.val_pred_columns["reco_pred"]).all()
    assert int(fused.opt_state["t"][0]) == 4 * 8  # 236 training windows in batches of 32


def test_train_outside_the_envelope_says_why():
    tm = et.construct_hybrid_model(**_spec(hidden=4), device="cpu")
    r = et.train(tm, et.rbq10_columns(200, seed=3), nepochs=1, batchsize=32, training_loss="rmse",
                 show_progress=False, sequence_kwargs=SEQ, use_kernel=True)
    assert r.epoch_path == "torch"
    assert "supports_fused_epoch_lstm" in r.engine_reason and "rmse" in r.engine_reason


def test_cuda_tensors_never_take_the_plain_version():
    """On a CUDA tensor the wrapper launches the kernel or raises; here, with
    no card, a meta tensor stands for 'not the CPU'."""
    *_, tm, tt = setup()
    fn = et.make_fused_lstm_epoch(tm, "adam", _ll())
    p0 = fn.plan.pack(tm)
    meta = tepoch.EpochTensors(
        x=tt.x.to("meta"), forcing={k: v.to("meta") for k, v in tt.forcing.items()},
        y={k: v.to("meta") for k, v in tt.y.items()},
        mask={k: v.to("meta") for k, v in tt.mask.items()}, weight=tt.weight.to("meta"),
        n_samples=tt.n_samples)
    with pytest.raises(ValueError):
        fn(p0, fe.init_fused_opt_state(p0), meta, perms=None)
    assert fl.launch_fused_lstm.launches == 0
