"""Kernel 3's plain version (``fused_wide_reference``, what the wrapper
computes on CPU tensors) against the JAX package's batch-chunked fused epoch
kernel in interpret mode and against the port's torch epoch; a fully masked
batch; the envelope, its reasons and the size rule between kernels 2 and 3;
the exactness gate; the workspace layout and the products' launch geometry;
the 3xTF32 split's accuracy against TF32's, emulated in numpy; the ctypes
mirror of the CUDA argument struct; and the slice as a whole, ``train()`` against the JAX
``train()``.

Tolerances, float32: parameters and moments rtol 1e-5 with atol 1e-5 after
two epochs of three steps (tests/test_fused.py holds the chunked kernel
against the unchunked one at rtol 1e-5, atol 1e-6 with one summation order
on both sides; here torch's products and JAX's sum in different orders), the
loss rtol 1e-5. With mae under adam atol 1e-4, a hundredth of the learning
rate: mae's cotangent is a sign, so where a prediction sits within rounding
of its target the row's whole contribution flips, and adam turns the flip of
a small gradient into a visible fraction of a step (measured 3.1e-5 on one
element of 2,592). The whole slice as tests/test_torch_train.py."""

import ctypes
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
from easyhybrid_tpu.ops.fused_epoch import _pick_batch_chunks
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from test_torch_fused_epoch import RULES, assert_slots_match, assert_torch_slots_match

CU_SOURCE = Path(fw.__file__).resolve().parent.parent / "csrc" / "fused_wide.cu"


def _ll(pkg, loss="mse", **kw):
    return pkg.LoggingLoss(training_loss=loss, loss_types=(loss,), **kw)


def _spec(norm="static", hidden=(32, 16), act="tanh", **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(kw)
    return spec


def setup(norm="static", n=768, batch=256, nan_frac=0.0, data=None, **kw):
    """The same model in both packages from the JAX initial parameters, the
    static norm fitted, and the same epoch tensors for each."""
    spec = _spec(norm, **kw)
    jm, tm = eh.construct_hybrid_model(**spec), et.construct_hybrid_model(**spec, device="cpu")
    if data is None:
        data = et.prepare_data(tm, et.rbq10_columns(n, seed=42, nan_frac=nan_frac))
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    jt = jax.device_put(jax_epoch_tensors(eh.prepare_data(jm, ((data.x, data.forcing), data.y)), batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


def jax_perms(shuffle, key, epochs, nb, batch):
    if not shuffle or nb == 1:
        return None
    n = nb * batch if shuffle is True else nb
    keys = [key] if epochs == 1 else list(jax.random.split(key, epochs))
    return np.stack([np.asarray(jax_permutation(k, n)) for k in keys])


def _atol(loss, opt):
    return 1e-4 if (loss, opt[0]) == ("mae", "adam") else 1e-5


CASES = [
    # loss, opt, shuffle, NaN fraction of the targets
    ("mse", ("adam", 0.01), True, 0.0),
    ("mae", ("adam", 0.01), True, 0.0),
    ("mse", ("sgd", 0.05), False, 0.0),
    ("mae", ("sgd", 0.05), "batches", 0.0),
    ("mse", ("adam", 0.01), "batches", 0.3),
    ("mae", ("adam", 0.01), True, 0.3),
    ("mse", ("adam", 0.01), False, 0.3),
]
# one case per optimizer rule besides adam and plain sgd (6 steps: radam's
# last is rectified)
RULE_CASES = [("mse", opt, (True, "batches", False)[i % 3], 0.3 * (i % 2))
              for i, opt in enumerate(RULES)]


@pytest.mark.parametrize("loss,opt,shuffle,nan_frac", CASES + RULE_CASES, ids=str)
def test_reference_matches_the_jax_chunked_kernel(monkeypatch, loss, opt, shuffle, nan_frac):
    """Two epochs per call of the JAX kernel with each batch of 256 in two
    chunks (run as tests/test_fused.py runs it) against the plain version,
    which sees each batch whole: parameters, moments, step count, loss."""
    jm, params, state, jt, tm, tt = setup(nan_frac=nan_frac)
    monkeypatch.setenv("EASYHYBRID_FUSED_MAX_VMEM_MB", "0.45")
    monkeypatch.setenv("EASYHYBRID_FUSED_CHUNKED", "1")
    jll = _ll(eh, loss)
    assert _pick_batch_chunks(jm, [jm.nn], jt, jll) == 2
    key = jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=2)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt, key)

    fn = et.make_fused_wide_epoch(tm, opt, _ll(et, loss), shuffle=shuffle, epochs_per_call=2)
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, got_loss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                          perms=jax_perms(shuffle, key, 2, nb, batch))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=_atol(loss, opt))
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(np.asarray(jos["t"])[0]) == 6
    # every slot, leaf by leaf through the JAX layout
    assert_slots_match(fn.plan, tm, os_, jos, atol=_atol(loss, opt), rtol=1e-4)


@pytest.mark.parametrize("loss,opt,shuffle,nan_frac", CASES + RULE_CASES, ids=str)
def test_reference_matches_the_torch_epoch(loss, opt, shuffle, nan_frac):
    *_, tm, tt = setup(nan_frac=nan_frac, hidden=(70, 33), act="swish")
    twin = et.construct_hybrid_model(**_spec(hidden=(70, 33), act="swish"), device="cpu")
    twin.load_state_dict(tm.state_dict())
    ll = _ll(et, loss, agg="mean")
    perms = tepoch.perms_for_epochs(shuffle, tt, 2, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_wide_epoch(tm, opt, ll, shuffle=shuffle, epochs_per_call=2)
    p0 = fn.plan.pack(tm)
    packed, os_, got_loss = fn(p0, fe.init_fused_opt_state(p0, opt), tt, perms=perms)
    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, ll, optim, shuffle=shuffle, epochs_per_call=2)
    state, tloss = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=_atol(loss, opt),
                               rtol=1e-5)
    assert torch.equal(packed.bn, p0.bn)  # the static statistics stay
    np.testing.assert_allclose(float(got_loss), float(tloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])
    assert_torch_slots_match(fn.plan, opt, os_, state, atol=_atol(loss, opt), rtol=1e-4)


def test_a_fully_masked_batch_changes_nothing():
    """The first (unshuffled) batch has no valid target: its step is not
    counted and leaves parameters and moments as they were, so the run
    equals one over the other batches alone."""
    cols = et.rbq10_columns(256, seed=3)
    y = cols["reco"].copy()
    y[:64] = np.nan

    def data(rows):
        return HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1)[rows],
                          forcing={"ta": cols["ta"][rows]}, y={"reco": y[rows]})

    *_, tm, tt = setup(data=data(slice(None)), batch=64)
    *_, tm2, tt2 = setup(data=data(slice(64, None)), batch=64)
    tm2.load_state_dict(tm.state_dict())  # the same norm statistics
    fn = et.make_fused_wide_epoch(tm, ("adam", 0.01), _ll(et), shuffle=False)
    p0 = fn.plan.pack(tm)
    scale, valid = fw.batch_scales(fn.plan, fn._make_data(fn.plan, tt), fn.rows(tt))
    assert valid.tolist() == [[0.0, 1.0, 1.0, 1.0]] and float(scale[0, 0, 0]) == 1.0
    got, os_, loss = fn(p0, fe.init_fused_opt_state(p0), tt)
    want, os2, loss2 = fn(p0, fe.init_fused_opt_state(p0), tt2)
    assert int(os_["t"][0]) == 3 == int(os2["t"][0])
    assert torch.isfinite(got.params).all()
    assert torch.equal(got.params, want.params) and torch.equal(os_["m"], os2["m"])
    np.testing.assert_allclose(float(loss) * 4, float(loss2) * 3, rtol=1e-6)

    # one masked batch alone: nothing moves at all
    *_, tm3, tt3 = setup(data=data(slice(0, 64)), batch=64)
    p3 = fn.plan.pack(tm3)
    got3, os3, loss3 = fn(p3, fe.init_fused_opt_state(p3), tt3)
    assert torch.equal(got3.params, p3.params) and int(os3["t"][0]) == 0 and float(loss3) == 0.0
    assert not os3["m"].any() and not os3["v"].any()


@pytest.mark.parametrize("overrides,optimizer,logging,reason", [
    # MultiNN branches train on the kernel (tests/test_torch_fused_wide_multinn.py); nine do not
    ({"predictors": {f"p{i}": ["sw_pot"] for i in range(9)},
      "parameters": {f"p{i}": (1.0, 0.0, 2.0) for i in range(9)},
      "neural_param_names": [f"p{i}" for i in range(9)], "global_param_names": [],
      "mechanistic_model": lambda *, ta, p0, p1, p2, p3, p4, p5, p6, p7, p8: {
          "reco": p0 * ta + p1 + p2 + p3 + p4 + p5 + p6 + p7 + p8}},
     "adam", _ll(et), "MultiNN branches"),
    ({"compute_dtype": torch.float16}, "adam", _ll(et),
     "compute_dtype=torch.float16 (the kernels take bfloat16 only"),
    # the declarative weight-L2 trains on the kernel (tests/test_torch_fused_l2.py); an
    # opaque extra_loss does not
    ({}, "adam", et.LoggingLoss(extra_loss=lambda outputs, params: 0.0), "extra_loss"),
    ({}, ("radam", {"learning_rate": 0.01, "threshold": 3.0}), _ll(et),
     "threshold 3.0 < 4"),
    ({}, ("rmsprop", {"centered": True}), _ll(et), "centered"),
    ({"hidden_layers": {"lstm": 8}}, "adam", _ll(et), "LSTMNet, not an MLP"),
    ({"hidden_layers": [fw.MAX_WIDE_WIDTH + 1]}, "adam", _ll(et), f"cap of {fw.MAX_WIDE_WIDTH}"),
    ({"hidden_layers": [8] * 9}, "adam", _ll(et), "10 layers exceed"),
    ({"activation": torch.tanh}, "adam", _ll(et), "activation"),
    ({"mechanistic_model": lambda *, ta, rb, Q10: {"reco": rb * Q10 if ta > 15.0 else rb}},
     "adam", _ll(et), "kernel form"),  # control flow on a value: the tracer refuses it
])
def test_envelope_reasons(overrides, optimizer, logging, reason):
    tm = et.construct_hybrid_model(**_spec(**overrides), device="cpu")
    got = fw.fused_wide_unsupported_reason(tm, optimizer, logging)
    assert got is not None and reason in got
    assert not et.supports_fused_wide(tm, optimizer, logging)
    if isinstance(getattr(tm, "nn", None), et.MLP):
        with pytest.raises(ValueError, match="wide fused epoch kernel"):
            et.make_fused_wide_epoch(tm, optimizer, logging)


def test_envelope_accepts_the_tower_and_refuses_a_workspace_beyond_the_card():
    """Every loss of the JAX kernel under both aggregations, with a static
    and with a trainable input norm (the reference's GPU tutorial); a
    workspace beyond the card's share is refused."""
    tower = et.construct_hybrid_model(**_spec(hidden=(1024, 512, 256, 128, 64), act="swish"),
                                      device="cpu")
    tutorial = et.construct_hybrid_model(**_spec(True, hidden=(1024, 512, 256, 128, 64),
                                                 act="swish"), device="cpu")
    assert set(fw.WIDE_LOSSES) == set(fe.FUSED_LOSSES)
    for loss in fw.WIDE_LOSSES:
        for agg in ("sum", "mean"):
            assert et.supports_fused_wide(tower, ("adam", 0.01), _ll(et, loss, agg=agg))
            assert et.supports_fused_wide(tutorial, ("adam", 0.01), _ll(et, loss, agg=agg))
    plan = fw.plan_fused_wide(tower, ("sgd", 0.1), _ll(et, "mae"))
    assert plan.n_params == 4 + 698_432 + 1_985 + 1 and plan.loss == "mae"
    *_, tt = setup(n=300, batch=100)
    need = fw.wide_layout(plan.dims, True, 100).nbytes
    ok = fw.fused_wide_unsupported_reason(tower, "adam", _ll(et), tt, memory_bytes=4 * need)
    assert ok is None
    got = fw.fused_wide_unsupported_reason(tower, "adam", _ll(et), tt, memory_bytes=4 * need - 4)
    assert f"take {need} bytes" in got and "0.25 of the card's" in got
    # on the CPU there is no card to measure against
    assert fw.fused_wide_unsupported_reason(tower, "adam", _ll(et), tt) is None
    # more row tiles than a grid's second dimension takes
    rows = 65_535 * 64 + 1
    huge = tt._replace(x=tt.x[:1, :1].expand(1, rows, 2), weight=tt.weight[:1, :1].expand(1, rows))
    assert f"a batch of {rows} rows" in fw.fused_wide_unsupported_reason(tower, "adam", _ll(et), huge)


@pytest.mark.parametrize("hidden,path", [
    ((16, 16), "cuda_fused_epoch"), ((64, 64), "cuda_fused_epoch"),
    ((128, 64), "cuda_fused_wide"), ((65,), "cuda_fused_wide"),
    ((64,) * 7, "cuda_fused_wide"),  # within the width cap, beyond one block's shared memory
    ((1024, 512, 256, 128, 64), "cuda_fused_wide"),
])
def test_the_size_rule_between_kernels_2_and_3(hidden, path):
    tm = et.construct_hybrid_model(**_spec(hidden=hidden), device="cpu")
    engine = fe.fused_engine(tm)
    assert engine.epoch_path == path
    assert engine.unsupported_reason(tm, ("adam", 0.01), _ll(et), shuffle=True) is None
    assert "shuffle" in engine.unsupported_reason(tm, ("adam", 0.01), _ll(et), shuffle="rows")


def test_the_other_models_keep_their_engines():
    lstm = et.construct_hybrid_model(**_spec(hidden_layers={"lstm": 8}), device="cpu")
    assert fe.fused_engine(lstm).epoch_path == "cuda_fused_lstm"
    sites = et.MultiSiteHybridModel(et.construct_hybrid_model(**_spec(), device="cpu"),
                                    n_sites=4, device="cpu")
    assert fe.fused_engine(sites).epoch_path == "cuda_fused_multisite"
    # trainable BatchNorm at width 128 takes kernel 3, under mse and the moment losses
    wide_bn = et.construct_hybrid_model(**_spec(True, hidden=(128, 64)), device="cpu")
    engine = fe.fused_engine(wide_bn)
    assert engine.epoch_path == "cuda_fused_wide"
    for loss in ("mse", "nseLoss", "kgeLoss"):
        assert engine.unsupported_reason(wide_bn, "adam", _ll(et, loss), shuffle=True) is None
    # predict on a wide model stays on the torch engine
    assert "cap of 64" in ff.fused_forward_unsupported_reason(
        et.construct_hybrid_model(**_spec(hidden=(128, 64)), device="cpu"))


@pytest.mark.parametrize("loss,opt,shuffle,epochs", [
    ("mse", ("adam", 0.01), False, 1), ("mse", ("adam", 0.01), True, 3),
    ("mae", ("sgd", 0.05), "batches", 2),
])
def test_gate_passes_on_the_plain_version(loss, opt, shuffle, epochs):
    *_, tm, tt = setup(hidden=(128, 64), act="swish")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ok, worst = fe.fused_exactness_check(tm, opt, _ll(et, loss), tt, epochs_per_call=epochs,
                                         shuffle=shuffle)
    assert ok and worst < 1e-4
    for k, v in tm.state_dict().items():  # the gate leaves the model as it was
        assert torch.equal(v, before[k])


def test_gate_fails_on_a_corrupted_gradient(monkeypatch):
    *_, tm, tt = setup(hidden=(128, 64), act="swish")
    real = fw.reference_grads

    def corrupted(*args, **kwargs):
        g, loss, valid, bn = real(*args, **kwargs)
        return g * 1.5, loss, valid, bn

    monkeypatch.setattr(fw, "reference_grads", corrupted)
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), _ll(et), tt)
    assert not ok and worst > 0.1


LAYOUT_CASES = [
    # dims, norm, batch, trainable norm, targets, the batch's prediction moments
    ((2, 1024, 512, 256, 128, 64, 1), True, 1024, False, 1, False),
    ((2, 1024, 512, 256, 128, 64, 1), True, 64, False, 1, False),
    ((2, 100, 37, 1), False, 300, False, 1, False), ((3, 65, 2), True, 1, False, 1, False),
    ((2, 4096, 4096, 1), True, 5000, False, 1, False),
    ((2, 1024, 512, 256, 128, 64, 1), True, 64, True, 1, False),
    ((2, 1024, 512, 256, 128, 64, 1), True, 1024, True, 1, True),
    ((3, 65, 2), False, 700, False, 2, True),
]


@pytest.mark.parametrize("dims,norm,batch,train_norm,targets,moments", LAYOUT_CASES)
def test_workspace_layout(dims, norm, batch, train_norm, targets, moments):
    """No two blocks of the workspace or of the partials overlap, every
    split covers the batch in whole tiles of its route's depth (16 rows on
    the FMA tile, 32 on the tensor cores), and small FMA products are split
    until they fill the card. A tensor-core layer also keeps its input and
    its output's cotangent feature-major and its W transposed (the forward
    and data products' pieces sum their tiles in shared memory: no room
    here). A trainable norm adds the batch's mean and variance; rmse and the
    statistic losses the predictions and three moments per head block and
    target."""
    lay = fw.wide_layout(dims, norm, batch, train_norm, targets, moments)
    f = dims[0]
    blocks = [(lay.ws_h0, batch * f)]
    if norm:
        blocks += [(lay.ws_xhat, batch * f), (lay.ws_d0, batch * f)]
    if train_norm:
        blocks.append((lay.ws_stats, 2 * f))
    else:
        assert lay.ws_stats == 0
    if moments:
        blocks += [(lay.ws_pred, targets * batch), (lay.ws_mom, lay.head_blocks * targets * 3)]
    else:
        assert lay.ws_pred == lay.ws_mom == 0
    for off_a, off_d, width in zip(lay.ws_a, lay.ws_d, dims[1:]):
        blocks += [(off_a, batch * width), (off_d, batch * width)]
    for l, (din, dout, geo) in enumerate(zip(dims[:-1], dims[1:], lay.geometry)):
        if geo.route == fw.TENSOR_CORES:
            blocks += [(lay.ws_ht[l], din * batch), (lay.ws_dt[l], dout * batch),
                       (lay.ws_wt[l], din * dout)]
        else:
            assert lay.ws_ht[l] == lay.ws_dt[l] == lay.ws_wt[l] == 0
    blocks.sort()
    assert blocks[0][0] == 0 and blocks[-1][0] + blocks[-1][1] == lay.ws_floats
    for (a, n), (b, _) in zip(blocks, blocks[1:]):
        assert a + n == b
    part = 0
    for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        s, rows = lay.splits[l], lay.split_rows[l]
        weight = lay.geometry[l].weight
        assert (s, rows) == (weight.splits, weight.split_k)
        assert lay.part_off[l] == part and (s - 1) * rows < batch <= s * rows
        if weight.route == fw.TENSOR_CORES:
            assert rows % 32 == 0 and s <= 16
        else:
            tiles = -(-dout // 64) * -(-din // 64)
            assert rows % 16 == 0 and (s == 1 or (s - 1) * tiles < 2 * 132 and rows >= 64)
        part += s * dout * (din + 1)
    assert lay.part_off_norm == part
    assert (lay.norm_splits - 1) * lay.norm_split_rows < batch <= lay.norm_splits * lay.norm_split_rows
    assert lay.part_floats == part + (lay.norm_splits * 2 * f if norm else 0)
    assert lay.head_blocks * 256 >= batch > (lay.head_blocks - 1) * 256
    assert lay.nbytes == 4 * (lay.ws_floats + lay.part_floats)


def test_the_tower_s_layout_at_the_main_shape():
    dims = (2, 1024, 512, 256, 128, 64, 1)
    lay = fw.wide_layout(dims, True, 1024)
    # the activations (16.3 MB) and the four tensor-core layers' H^T, dZ^T and W^T (14.6 MB)
    inner = ((1024, 512), (512, 256), (256, 128), (128, 64))
    assert lay.ws_floats == (1024 * (3 * 2 + 2 * (1024 + 512 + 256 + 128 + 64 + 1))
                             + sum(1024 * (i + o) + i * o for i, o in inner))
    assert lay.splits == (16, 4, 16, 16, 16, 16) and lay.split_rows == (64, 256, 64, 64, 64, 64)
    # the new rows go after the parent's, whose offsets stay: a trainable norm's
    # statistics (4 floats), the predictions and 4 head blocks' moments
    both = fw.wide_layout(dims, True, 1024, True, 1, True)
    assert both.ws_stats == lay.ws_floats and both.ws_pred == lay.ws_floats + 4
    assert both.ws_mom == both.ws_pred + 1024 and both.ws_floats == both.ws_mom + 4 * 3
    for name in ("ws_xhat", "ws_d0", "ws_a", "ws_d", "ws_ht", "ws_dt", "ws_wt", "part_off",
                 "part_off_norm", "part_floats"):
        assert getattr(both, name) == getattr(lay, name)


def _tc(bm, bn, splits, split_k):
    return fw.Product(fw.TENSOR_CORES, bm, bn, splits, split_k)


def _fma(splits, split_k):
    return fw.Product(fw.FMA, 64, 64, splits, split_k)


def test_the_tower_s_geometry():
    """The plan's choice for the tower at the main shape and at batch 64:
    the input and output layers on the FMA tile, the four inner layers'
    three products on the tensor cores, each cut to about one block a
    multiprocessor."""
    dims = (2, 1024, 512, 256, 128, 64, 1)
    assert fw.wide_geometry(dims, 1024) == (
        fw.LayerGeometry(_fma(1, 16), _fma(8, 128), _fma(16, 64)),
        fw.LayerGeometry(_tc(128, 64, 4, 256), _tc(128, 64, 2, 256), _tc(128, 64, 4, 256)),
        fw.LayerGeometry(_tc(128, 64, 8, 64), _tc(128, 64, 4, 64), _tc(128, 64, 16, 64)),
        fw.LayerGeometry(_tc(128, 64, 8, 32), _tc(128, 64, 4, 32), _tc(128, 64, 16, 64)),
        fw.LayerGeometry(_tc(128, 64, 4, 32), _tc(128, 64, 2, 32), _tc(64, 64, 16, 64)),
        fw.LayerGeometry(_fma(1, 64), _fma(1, 16), _fma(16, 64)),
    )
    assert fw.wide_geometry(dims, 64) == (
        fw.LayerGeometry(_fma(1, 16), _fma(8, 128), _fma(1, 64)),
        fw.LayerGeometry(_tc(64, 64, 8, 128), _tc(64, 64, 8, 64), _tc(128, 64, 2, 32)),
        fw.LayerGeometry(_tc(64, 64, 8, 64), _tc(64, 64, 8, 32), _tc(128, 64, 2, 32)),
        fw.LayerGeometry(_tc(64, 64, 8, 32), _tc(64, 64, 4, 32), _tc(128, 64, 2, 32)),
        fw.LayerGeometry(_tc(64, 64, 4, 32), _tc(64, 64, 2, 32), _tc(64, 64, 2, 32)),
        fw.LayerGeometry(_fma(1, 64), _fma(1, 16), _fma(1, 64)),
    )


@pytest.mark.parametrize("dims,batch", [
    ((2, 1024, 512, 256, 128, 64, 1), 1024), ((2, 1024, 512, 256, 128, 64, 1), 64),
    ((2, 100, 37, 1), 100), ((2, 100, 37, 1), 300), ((2, 65, 1), 300), ((2, 70, 33, 1), 128),
    ((2, 300, 200, 100, 1), 64), ((2, 5, 1), 7), ((3, 65, 2), 1), ((2, 4096, 4096, 1), 5000),
    ((20, 16, 15, 1), 33), ((2, 33, 33, 33, 1), 1),
])
def test_every_product_s_geometry_is_a_whole_launch(dims, batch):
    """Per layer: the route (tensor cores where both sides are at least 16
    wide, else the FMA tile); every product's tile one the kernels have; its
    inner dimension cut into at most 16 pieces, each a whole number of the
    route's depth (32 for the tensor cores' staged slice, 16 for the FMA
    tile), none empty, together covering it; a forward or data product's
    pieces a cluster of at most 8 blocks that share its tile's rows out
    evenly."""
    geometry = fw.wide_geometry(dims, batch)
    assert len(geometry) == len(dims) - 1
    for din, dout, geo in zip(dims[:-1], dims[1:], geometry):
        route = fw.TENSOR_CORES if min(din, dout) >= 16 else fw.FMA
        assert geo.route == route
        for prod, m, inner in ((geo.forward, batch, din), (geo.data, batch, dout),
                               (geo.weight, dout, batch)):
            assert prod.route == route
            if route == fw.TENSOR_CORES:
                assert prod.bm == (64 if m <= 64 else 128) and prod.bn == 64
                depth = 32
            else:
                assert prod.bm == prod.bn == 64
                depth = 16
            assert prod.split_k % depth == 0 and 1 <= prod.splits <= 16
            assert (prod.splits - 1) * prod.split_k < inner <= prod.splits * prod.split_k
            if prod is not geo.weight:
                assert prod.splits in (1, 2, 4, 8) and prod.bm % prod.splits == 0


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: half of the dropped 13 bits' weight is
    added to the magnitude, then they are cleared."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_matches_cvt_rna():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -11 - 2.0 ** -23, 3.14159265], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                     3.140625], np.float32)
    np.testing.assert_array_equal(_tf32(x), want)
    y = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    big = _tf32(y)
    assert np.all(np.abs(y - big) <= np.abs(y) * 2.0 ** -11)
    assert not np.any(big.view(np.uint32) & np.uint32(0x1FFF))


@pytest.mark.parametrize("product", ["forward", "weight"])
def test_3xtf32_keeps_float32_accuracy_where_tf32_does_not(product):
    """The tolerance argument, before any chip run: the tower's 1024 -> 512
    products at a small batch, from operands split into big = tf32(x) and
    small = tf32(x - big), summed as big*big + big*small + small*big (the
    dropped small*small is 2^-22 of a product). The split product is within
    1e-4 max(1, |ref|) of the float64 product, as chip_smoke.py's criteria
    ask of the kernel; TF32 alone (big*big) is not."""
    rng = np.random.default_rng(8)
    batch = 64
    if product == "forward":  # A = H W^T: 64 rows of 1024 inputs by 512 outputs
        a = rng.normal(size=(batch, 1024)).astype(np.float32)
        b = (rng.normal(size=(512, 1024)) / 32).astype(np.float32)
    else:  # dW = dZ^T H over the batch's rows
        a = rng.normal(size=(512, batch)).astype(np.float32)
        b = rng.normal(size=(1024, batch)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64).T
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    tf32 = f64(a_big) @ f64(b_big).T
    three = tf32 + f64(a_big) @ f64(b_small).T + f64(a_small) @ f64(b_big).T
    scale = np.maximum(1.0, np.abs(ref))
    assert np.max(np.abs(three - ref) / scale) < 1e-5
    assert np.max(np.abs(tf32 - ref) / scale) > 1e-4


def test_wide_product_on_the_cpu_is_the_plain_product():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(37, 65)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(33, 65)).astype(np.float32))
    assert torch.equal(fw._wide_product(a, b), a @ b.T)
    with pytest.raises(ValueError, match="float32"):
        fw._wide_product(a.double(), b)
    with pytest.raises(ValueError, match="float32"):
        fw._wide_product(a, b[:, :64])


def test_kernel_source_and_ctypes_mirror_agree():
    src = CU_SOURCE.read_text()
    assert '#include "eh_device.cuh"' in src
    defines = dict(re.findall(r"#define (EHW?_\w+) (\d+)", src))
    assert int(defines["EH_WIDE_MAX_WIDTH"]) == fw.MAX_WIDE_WIDTH
    assert int(defines["EHW_TILE"]) == fw._TILE and int(defines["EHW_BK"]) == fw._DEPTH
    assert int(defines["EHW_HEAD_THREADS"]) == fw._HEAD_THREADS
    assert int(defines["EHW_TC_BK"]) == fw._TC_DEPTH and int(defines["EHW_TC_MIN"]) == fw._TC_MIN
    assert int(defines["EHW_UTILE"]) == fw._UPDATE_TILE
    body = re.search(r"struct EhFusedWideArgs \{(.*?)\};", src, re.S).group(1)
    decls = re.findall(r"([\w ]+?\*?) ?(\w+)(\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body))
    assert [name for _, name, _ in decls] == [name for name, _ in fw._Args._fields_]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float, "int64_t": ctypes.c_int64,
             "EhOptimizer": fe._Optimizer}
    for (ctype, name, array), (_, mirror) in zip(decls, fw._Args._fields_):
        base = mirror._type_ if array else mirror
        want = ctypes.c_void_p if "*" in ctype else kinds[ctype.strip()]
        assert base is want, name
    for kernel in ("norm_stats", "gather", "forward", "head", "moments", "bwd_weight", "bwd_data",
                   "norm_grad", "update", "tc", "transpose"):
        assert f"eh_wide_{kernel}_kernel" in src
    # the tensor-core products in 3xTF32, the file's own
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in src
    assert "cvt.rna.tf32.f32" in src
    # sums in a fixed order: no atomics at all; no library product
    assert "atomicAdd(" not in src and "cublas" not in src.lower() and "cutlass" not in src.lower()
    assert re.findall(r"atomic\w*\(", src) == []


def test_kernel_arguments_pack_the_plan():
    tm = et.construct_hybrid_model(**_spec(hidden=(128, 64), act="swish"), device="cpu")
    plan = fw.plan_fused_wide(tm, ("adam", 0.01), _ll(et, "mae", agg="mean"))
    a = fw._Args.from_buffer_copy(plan.args_bytes)
    assert plan.n_params == a.n_params == 4 + 128 * 3 + 64 * 129 + 65 + 1
    assert list(a.dims[:4]) == [2, 128, 64, 1] and a.norm_mode == 1 and a.optimizer.rule == 1
    assert list(a.p_off_w[:3]) == [4, 388, 8644] and a.p_off_g == plan.n_params - 1
    assert a.loss_kind == 1 and list(a.acts[:3]) == [4, 4, 0]
    assert a.optimizer.one_minus_b1 == np.float32(1.0 - 0.9) and plan.agg_scale == 1.0
    packed = plan.pack(tm)
    assert packed.params.numel() == plan.n_params and packed.bn.numel() == 4
    twin = et.construct_hybrid_model(**_spec(hidden=(128, 64), act="swish"), device="cpu")
    plan.unpack(packed, twin)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k])


def test_interop_carries_a_five_layer_tower():
    spec = _spec(hidden=(40, 24, 16, 12, 8), act="swish")
    jm = eh.construct_hybrid_model(**spec)
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = et.construct_hybrid_model(**spec, device="cpu")
    et.load_jax_params(tm, params, state)
    got_p, got_s = et.export_jax_params(tm)
    assert jax.tree.structure(got_p) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).normal(size=(7, 2)).astype(np.float32)
    want = jm.nn.apply(params["nn"], state["nn"], jnp.asarray(x))
    want = want[0] if isinstance(want, tuple) else want
    np.testing.assert_allclose(tm.nn(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss", ["mse", "mae"])
def test_train_matches_jax_on_a_small_wide_model(loss):
    """The slice as a whole: ``train()`` with ``use_kernel=True`` on a model
    too wide for kernel 2 against the JAX ``train()`` from the same
    parameters, unshuffled: per-epoch metrics, best epoch, parameters."""
    spec = _spec(hidden=(128, 64), act="swish")
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
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)
    assert int(tr.opt_state["t"][0]) == 6 * 4
