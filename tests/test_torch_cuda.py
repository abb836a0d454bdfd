"""The CUDA kernels on a GPU, against their plain PyTorch versions: the
fused forward (kernel 1), the fused training epoch (kernel 2), the wide
fused epoch (kernel 3), the fused LSTM epoch (kernel 4), the fused
multi-site epoch (kernel 5) and the multi-site primitives.

Imports no JAX, so it runs where only PyTorch with CUDA is installed. On a
machine without a GPU every test skips. On a GPU, without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance, kernel 1: max |kernel - plain| <= 1e-5 * max(1, |plain|),
float32: the kernel uses CUDA's expf / powf / tanhf / rsqrtf and its own
summation order, against torch's transcendentals and GEMM. Kernel 2, after
at most 3 epochs: 1e-4 * max(1, |plain|) on parameters, moments, BatchNorm
statistics and loss, since the per-step differences compound along the
chain of steps. Kernel 5 the same, after at most 3 epochs of site batches
(its sums over a site's time steps and over thread blocks run in another
order than torch's); the primitives' gather and update exactly. Kernel 4 the
same as kernel 2, after at most 4 epochs: each step is a chain of ``T`` cells
forward and ``T`` backward on CUDA's expf / tanhf against torch's. Kernel 3
the same on models of a few thousand parameters, after at most 2 epochs; on
the 700,417-parameter tower its gradient is held through one sgd step, since
Adam turns the rounding of a near-zero gradient into a visible move (see
``chip_smoke.py``). Kernel 3's tensor-core product alone: within 1e-4 *
max(1, |ref|) of a float64 product (3xTF32 keeps about float32's accuracy;
measured worst 4.5e-5 relative at K = 1,024 on an H100).

Kernel 2 is also held on MultiNN models (a network per neural parameter,
``BRANCH_SPECS``) and on a model with globals only; kernel 3 on a MultiNN
model whose branches are past kernel 2's widths, in float32 and in its bf16
build, at K = 1 and on its member axis at K = 4. Kernel 4's cluster-split
form (``csrc/fused_lstm_split.cu``) the same as kernel 4, after at most 4
epochs, at hidden sizes 72 to 256 with up to 64 features; past LSTM(72) by
sgd, since adam's first steps move a gradient element that cancels to
rounding level by a visible share of the learning rate.

The halt word: a call of each of kernels 2-5 with the word set returns its
inputs bit for bit and a loss of 0, and with the word clear the bits of a
call without one; a deferred ``train()`` on kernel 2 with an early stop
equals the eager one bit for bit, its dispatch window under
``torch.cuda.set_sync_debug_mode("error")``.

Every training kernel is also held, under each optimizer rule besides adam
and plain sgd (``RULES``), against its plain version at the same tolerance
on parameters and every slot of the opt state, with the same bits on a
second run; and so under every training loss it takes: kernel 2 under mae,
nseLoss, rmse, pearsonLoss, kgeLoss, pbkgeLoss and the traced pinball and
huber (``TRACED_LOSSES``), kernels 3 and 4 under the traced losses, kernel 5
under them and rmse.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.data.sequences import split_into_sequences
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
from easyhybrid_tpu_torch.ops import fused_lstm_split as fs
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.ops import fused_multisite as fm
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.ops import multisite_primitives as mp
from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cols, device, seed=0, **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=[16, 16], activation="swish",
        scale_nn_outputs=True, input_batchnorm="static",
    )
    spec.update(kw)
    m = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed))
    et.fit_input_norm(m, et.prepare_data(m, cols))
    m.to(device)
    data = et.prepare_data(m, cols, drop_missing_rows=False)
    x = torch.tensor(data.x, device=device)
    forcing = {k: torch.tensor(v, device=device) for k, v in data.forcing.items()}
    return m, x, forcing


def _assert_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k].cpu(), ref[k].cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(r)), k
        fin = ~torch.isnan(r)
        assert bool(((g[fin] - r[fin]).abs() <= TOL * r[fin].abs().clamp_min(1)).all()), k


def test_quick_start_kernel_matches_plain(cuda):
    cols = et.rbq10_columns(5000, seed=3)
    cols["sw_pot"][::97] = np.nan  # NaN predictor rows
    m, x, forcing = _model(cols, cuda)
    fn = et.make_fused_forward(m, batch_size=1024)
    before = ff.launch_fused_forward.launches
    got = fn(x, forcing)
    torch.cuda.synchronize()
    assert ff.launch_fused_forward.launches - before == 1  # one launch covers every chunk
    _assert_close(got, fn.reference(x, forcing))
    assert torch.isnan(got["reco"][::97].cpu()).all()


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("hidden,width", [([16, 16], 16), ([24, 32], 32), ([64, 48], 64)])
def test_one_launch_gives_the_bits_of_a_launch_per_chunk(cuda, n, hidden, width):
    """Rows are independent: one launch over every chunk, one launch per
    chunk of 1,024 rows and one launch per 7 rows give the same bits, NaN
    predictor rows included, within TOL of the plain version."""
    cols = et.rbq10_columns(n, seed=n)
    cols["sw_pot"][::13] = np.nan
    m, x, forcing = _model(cols, cuda, hidden_layers=hidden, activation="swish")
    fn = et.make_fused_forward(m, batch_size=1024)
    assert fn.plan.width == width
    whole = fn(x, forcing)
    names = list(whole)
    for step in (1024, 7):
        parts = {k: torch.empty_like(v) for k, v in whole.items()}
        for start in range(0, n, step):
            sl = slice(start, min(start + step, n))
            ff.launch_fused_forward(fn.plan, x[sl], {k: c[sl] for k, c in forcing.items()},
                                    {k: parts[k][sl] for k in names})
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(whole[k]), _bits(parts[k])) for k in names)
    _assert_close(whole, fn.reference(x, forcing))


@pytest.mark.parametrize("act", sorted(et.ACTIVATIONS))
@pytest.mark.parametrize("norm", [False, "static"])
def test_activations_match_plain(cuda, act, norm):
    m, x, forcing = _model(et.rbq10_columns(777, seed=2), cuda, hidden_layers=[12, 5],
                           activation=act, input_batchnorm=norm)
    fn = et.make_fused_forward(m, batch_size=256)
    _assert_close(fn(x, forcing), fn.reference(x, forcing))


@pytest.mark.parametrize("hidden,width", [([8], 16), ([24, 32], 32), ([64, 48, 20], 64)])
def test_each_compiled_width_matches_plain(cuda, hidden, width):
    m, x, forcing = _model(et.rbq10_columns(1000, seed=4), cuda, hidden_layers=hidden,
                           activation="tanh")
    fn = et.make_fused_forward(m)
    assert fn.plan.width == width
    _assert_close(fn(x, forcing), fn.reference(x, forcing))


def test_predict_takes_the_kernel(cuda):
    cols = et.rbq10_columns(3000, seed=5)
    m, x, forcing = _model(cols, cuda)
    fn = et.make_inference_fn(m, batch_size=1024)
    assert fn.engine == "cuda_fused_forward"
    before = ff.launch_fused_forward.launches
    out = fn(cols)
    assert ff.launch_fused_forward.launches - before == 1  # one launch for the three chunks
    m.eval()
    with torch.no_grad():
        plain = m(x, forcing)
    _assert_close({k: torch.from_numpy(v) for k, v in out.items()},
                  {"reco": plain["reco"], "rb": plain["parameters"]["rb"]})
    fused = et.make_fused_forward(m, batch_size=1024)
    direct = fused(x, forcing)  # the same kernel on the same rows: the same bits
    for k, v in out.items():
        assert torch.equal(torch.from_numpy(v).view(torch.int32), _bits(direct[k]))


@pytest.mark.parametrize("batch_size", [1, 1024, 131_072])
def test_predict_keys_shapes_and_copies(cuda, batch_size):
    """The fused engine's ``predict``: the torch engine's keys and shapes at
    every batch size, one copy in per input array and one copy out per
    output a call."""
    cols = et.rbq10_columns(3000, seed=8)
    m, _, _ = _model(cols, cuda)
    fused = et.make_inference_fn(m, batch_size=batch_size)
    plain = et.make_inference_fn(m, batch_size=batch_size, use_kernel=False)
    assert (fused.engine, plain.engine) == ("cuda_fused_forward", "torch")
    fused(cols)  # the library is built and loaded
    from torch.profiler import ProfilerActivity, profile

    # the profiler now and then drops a trace's device records: a trace that
    # lacks the call's own kernel launch is a dropped trace, not a missing copy
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = fused(cols)
        keys = {e.key: e.count for e in prof.key_averages()}
        if any("eh_fused_forward_kernel" in k for k in keys):
            break
    else:
        pytest.fail(f"the profiler dropped the trace three times: no eh_fused_forward_kernel "
                    f"launch among its records {sorted(keys)}")
    copies = {k: c for k, c in keys.items() if "Memcpy" in k}
    assert sum(c for k, c in copies.items() if "HtoD" in k) == 2, copies  # x, ta
    assert sum(c for k, c in copies.items() if "DtoH" in k) == 2, copies  # reco, rb
    want = plain(cols)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
    _assert_close({k: torch.from_numpy(v) for k, v in got.items()},
                  {k: torch.from_numpy(v) for k, v in want.items()})


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    m, x, forcing = _model(et.rbq10_columns(100, seed=6), cuda)
    fn = et.make_fused_forward(m)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.cat([x, x], 1)[:, ::2], forcing)
    with pytest.raises(ValueError, match="ta"):
        fn(x, {"ta": forcing["ta"].cpu()})
    cpu_model, _, _ = _model(et.rbq10_columns(100, seed=6), "cpu")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        et.make_fused_forward(cpu_model)(x, forcing)


# --------------------------------------------------------------------------
# kernel 2: the fused training epoch
# --------------------------------------------------------------------------

EPOCH_TOL = 1e-4
# every optimizer rule of the training kernels besides adam and plain sgd
RULES = [("adamw", 0.01), ("sgd", 0.05, 0.9), ("sgd", 0.05, 0.9, 1.0), ("rmsprop", 0.01),
         ("adagrad", 0.05), ("lion", 0.001), ("adamax", 0.01), ("nadam", 0.01),
         ("adadelta", 1.0), ("radam", 0.01), ("amsgrad", 0.01), ("lamb", 0.01)]


# the traced elementwise losses of the loss cases, by a name that ids the case
TRACED_LOSSES = {"pinball": lambda: et.pinball(0.9),
                 "huber_sum": lambda: et.huber(1.0, normalize="sum")}


def _loss(name):
    return TRACED_LOSSES[name]() if name in TRACED_LOSSES else name


def _outputs(run):
    """A fused run's parameters, every opt-state slot and its loss."""
    packed, state, loss = run
    return [packed.params, *fe.opt_slots(state).values(), loss.reshape(1)]
# a multi-site model with two per-site globals: the network gives the form's tref
TWO_GLOBALS = dict(parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0),
                               "tref": (15.0, 10.0, 20.0)},
                   neural_param_names=["tref"], global_param_names=["rb", "Q10"])


def _epoch_case(device, *, hidden=(16, 16), act="swish", norm=True, opt=("adam", 0.01),
                shuffle=True, epochs=1, batch=256, n=2000, seed=0, nan_frac=0.0, mask_first=False,
                mechanistic=et.rbq10, loss="mse", agg="sum", spec=None, l2=None):
    """Kernel 2 against its plain version on the quick-start's model, or on
    the model of ``spec`` (a full model spec, on RbQ10 rows with a second
    target nee); ``l2``: the scale of a weight-L2 ``extra_loss``."""
    cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    if mask_first:
        cols["reco"][:batch] = np.nan
    if spec is None:
        spec = dict(
            predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
            mechanistic_model=mechanistic,
            parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
            neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
            activation=act, scale_nn_outputs=True, input_batchnorm=norm,
        )
        data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                          forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    else:
        cols["nee"] = (cols["reco"] - 5.0 * (1.0 - np.exp(-0.1 * cols["ta"]))).astype(np.float32)
        data = None
    m = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed))
    if data is None:
        data = et.prepare_data(m, cols)
    et.fit_input_norm(m, data)
    m.to(device)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), device)
    ll = et.LoggingLoss(training_loss=_loss(loss), loss_types=("mse",), agg=agg,
                        extra_loss=None if l2 is None else et.l2_extra_loss(l2))
    fn = et.make_fused_epoch(m, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device=device).manual_seed(seed))
    packed = fn.plan.pack(m)
    before = fe.launch_fused_epoch.launches
    got = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    torch.cuda.synchronize()
    assert fe.launch_fused_epoch.launches - before == 1
    again = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    ref = fn.reference(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    for g, a, r in zip([got[0].bn, *_outputs(got)], [again[0].bn, *_outputs(again)],
                       [ref[0].bn, *_outputs(ref)]):
        assert torch.equal(g, a)  # every sum has a fixed order: the same bits twice
        g, r = g.cpu(), r.cpu()
        assert torch.isfinite(g).all()
        assert bool(((g - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    assert torch.equal(got[1]["t"].cpu(), ref[1]["t"].cpu())
    return got


@pytest.mark.parametrize("kw", [
    dict(epochs=3),
    dict(hidden=(8,), act="tanh", norm="static", opt=("sgd", 0.05), shuffle=False, n=1000, batch=128),
    dict(hidden=(32, 24), act="tanh"),
    dict(hidden=(64, 48), act="selu", norm=False, shuffle="batches", batch=300),
    dict(nan_frac=0.3, epochs=2),
    dict(shuffle=False, mask_first=True, n=1024, batch=128),
], ids=str)
def test_epoch_kernel_matches_plain(cuda, kw):
    _epoch_case(cuda, **kw)


@pytest.mark.parametrize("kw", [
    dict(l2=0.5, epochs=2),
    dict(l2=0.5, agg="mean", norm="static", nan_frac=0.3, epochs=2),
    dict(l2=1e-2, opt=("lamb", 0.01), hidden=(32, 24)),
    dict(l2=0.5, agg="mean", spec=dict(
        predictors={"rb": ["sw_pot", "dsw_pot"], "Q10": ["ta"]}, forcing=["ta"],
        targets=["reco"], mechanistic_model=et.rbq10,
        parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb", "Q10"], hidden_layers=[12, 8], activation="tanh",
        scale_nn_outputs=True, input_batchnorm=True)),
], ids=["sum", "mean, static norm, NaN targets", "lamb", "MultiNN, mean"])
def test_epoch_kernel_matches_plain_with_the_weight_l2(cuda, kw):
    """The declarative weight-L2 extra_loss on kernel 2 (its MultiNN build
    too): the penalty's value in the loss, its gradient before the rule."""
    got = _epoch_case(cuda, **kw)
    assert torch.isfinite(got[2]).all()


def _rbq10_untagged(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def _clamped(*, ta, rb, Q10):
    e = torch.clamp(0.1 * (ta - 15.0), min=-1.5, max=1.5)
    return {"reco": torch.where(ta > 0.0, rb * Q10 ** e, rb * torch.exp(0.05 * ta))}


TRACED = [_rbq10_untagged, _clamped]


@pytest.mark.parametrize("mech", TRACED, ids=lambda f: f.__name__)
def test_traced_forms_run_the_forward_kernel(cuda, mech):
    """A mechanistic function without a tag: its traced form, built into
    kernel 1, against the plain version."""
    m, x, forcing = _model(et.rbq10_columns(3000, seed=4), cuda, mechanistic_model=mech)
    fn = et.make_fused_forward(m, batch_size=1024)
    assert fn.plan.form.header is not None
    before = ff.launch_fused_forward.launches
    got = fn(x, forcing)
    torch.cuda.synchronize()
    assert ff.launch_fused_forward.launches - before == 1
    _assert_close(got, fn.reference(x, forcing))


@pytest.mark.parametrize("mech", TRACED, ids=lambda f: f.__name__)
def test_traced_forms_run_the_epoch_kernel(cuda, mech):
    _epoch_case(cuda, mechanistic=mech, epochs=2, nan_frac=0.2)


@pytest.mark.parametrize("loss", ["mae", "nseLoss", "rmse", "pearsonLoss", "kgeLoss", "pbkgeLoss",
                                  "pinball", "huber_sum"])
def test_epoch_kernel_matches_plain_under_every_loss(cuda, loss):
    """Every training loss of the JAX kernel, NaN targets, agg mean; the
    statistic losses and rmse with their moments exchanged inside the step.
    kgeLoss and pbkgeLoss are cones at their minimum, where Adam amplifies
    rounding (chip_smoke.py's phase 22): one epoch of 8 steps."""
    _epoch_case(cuda, loss=loss, agg="mean", nan_frac=0.2,
                epochs=1 if loss in ("kgeLoss", "pbkgeLoss") else 2)


@pytest.mark.parametrize("loss", ["rmse", "kgeLoss", "pearsonLoss", "nseLoss"])
def test_epoch_kernel_takes_the_batch_moments_where_tiles_are_walked(cuda, loss):
    # a batch of 3,000 rows: the two-pass losses' moments from a pass of their own
    _epoch_case(cuda, loss=loss, hidden=(64, 48), act="selu", norm="static", batch=3000, n=9000)


@pytest.mark.parametrize("loss", ["kgeLoss", "rmse"])
def test_epoch_kernel_statistic_losses_on_a_masked_first_batch(cuda, loss):
    # no valid target: the NaN gradient of a batch without moments takes no step
    got = _epoch_case(cuda, loss=loss, shuffle=False, mask_first=True, n=1024, batch=128)
    assert int(got[1]["t"][0]) == 7


@pytest.mark.parametrize("act", sorted(et.ACTIVATIONS))
def test_epoch_kernel_activations_match_plain(cuda, act):
    _epoch_case(cuda, hidden=(12, 5), act=act, norm="static", n=777, batch=100)


@pytest.mark.parametrize("kw,cluster,tiles,stages", [
    (dict(batch=31, n=100), 1, 1, 2),  # less than a warp
    (dict(batch=33, n=100), 1, 1, 2),
    (dict(batch=513, n=1100), 4, 1, 2),  # one row more than two blocks of 256 hold
    (dict(batch=1000, n=2100, nan_frac=0.3, epochs=2), 4, 1, 2),  # a ragged last batch in a cluster
    (dict(batch=512, n=1536, epochs=3), 2, 1, 2),  # the prefetch crosses epoch boundaries
    (dict(hidden=(64, 48), act="selu", norm="static", batch=3000, n=9000), 8, 3, 0),  # tiles
    (dict(hidden=(64, 64, 64), act="tanh", batch=64, n=200), 2, 1, 2),  # little room beside the state
    (dict(hidden=(61, 61, 44, 61, 13), act="tanh", batch=128, n=512, epochs=2), 1, 2, 0),  # moments
    # in device memory: the padded rows leave no room for them beside 32 residual rows
], ids=str)
def test_epoch_kernel_geometry_edges_match_plain(cuda, kw, cluster, tiles, stages):
    got = _epoch_case(cuda, **kw)
    del got
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=list(kw.get("hidden", (16, 16))), activation=kw.get("act", "swish"),
        scale_nn_outputs=True, input_batchnorm=kw.get("norm", True), device="cpu")
    g = fe.plan_fused_epoch(m, ("adam", 0.01), et.LoggingLoss()).geometry(kw["batch"])
    assert (g.cluster, g.tiles, g.stages) == (cluster, tiles, stages)


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_epoch_kernel_matches_plain_under_every_rule(cuda, opt):
    # two blocks of a cluster, each updating its replica; 8 steps (radam
    # rectifies from step 6)
    _epoch_case(cuda, opt=opt, epochs=2, batch=512, n=2000)


@pytest.mark.parametrize("opt", [("amsgrad", 0.01), ("lamb", 0.01), ("rmsprop", 0.01)], ids=str)
def test_epoch_kernel_rules_with_the_slots_in_device_memory(cuda, opt):
    # the padded rows leave no room for the slots beside 32 residual rows
    _epoch_case(cuda, opt=opt, hidden=(61, 61, 44, 61, 13), act="tanh", batch=128, n=512, epochs=2)


def _nee(*, ta, rb, gpp_max, Q10):
    reco = rb * Q10 ** (0.1 * (ta - 15.0))
    return {"nee": reco - gpp_max * (1.0 - torch.exp(-0.1 * ta))}


# MultiNN models (a network per neural parameter) and a model with globals only
BRANCH_SPECS = {
    "two_branches_static": dict(
        predictors={"rb": ["sw_pot", "dsw_pot"], "gpp_max": ["sw_pot"]}, forcing=["ta"],
        targets=["nee"], mechanistic_model=_nee,
        parameters={"rb": (3.0, 0.0, 13.0), "gpp_max": (5.0, 0.0, 20.0), "Q10": (2.0, 1.0, 4.0)},
        global_param_names=["Q10"], hidden_layers={"rb": [16, 16], "gpp_max": [8]},
        activation="swish", scale_nn_outputs=True, input_batchnorm="static"),
    "two_branches_trainable_bn": dict(
        predictors={"rb": ["sw_pot"], "gpp_max": ["dsw_pot", "ta"]}, forcing=["ta"],
        targets=["nee"], mechanistic_model=_nee,
        parameters={"rb": (3.0, 0.0, 13.0), "gpp_max": (5.0, 0.0, 20.0), "Q10": (2.0, 1.0, 4.0)},
        global_param_names=["Q10"], hidden_layers=[32, 16], activation="tanh",
        scale_nn_outputs=True, input_batchnorm=True),
    "globals_only": dict(
        predictors=[], forcing=["ta"], targets=["reco"], mechanistic_model=et.rbq10,
        parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}, neural_param_names=[],
        global_param_names=["rb", "Q10"]),
}


@pytest.mark.parametrize("name", sorted(BRANCH_SPECS))
@pytest.mark.parametrize("batch", [256, 1000])
def test_epoch_kernel_runs_every_branch(cuda, name, batch):
    """Kernel 2 on the JAX kernel's branch view: each branch's forward and
    backward from its own columns and slots, in one block and in a cluster."""
    _epoch_case(cuda, spec=BRANCH_SPECS[name], epochs=2, batch=batch, nan_frac=0.1)


def test_first_masked_batch_counts_no_step(cuda):
    got = _epoch_case(cuda, shuffle=False, mask_first=True, n=1024, batch=128)
    assert int(got[1]["t"][0]) == 7


def test_train_takes_the_epoch_kernel(cuda):
    cols = et.rbq10_columns(2000, seed=8)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm=True,
        generator=torch.Generator().manual_seed(0), device=cuda)
    before = fe.launch_fused_epoch.launches
    r = et.train(m, cols, nepochs=6, eval_every=2, batchsize=256, show_progress=False)
    assert r.epoch_path == "cuda_fused_epoch" and "exactness gate passed" in r.engine_reason
    assert fe.launch_fused_epoch.launches - before == 3 + 2  # three blocks + the gate's two runs
    assert next(m.parameters()).is_cuda  # never moved off the card


def test_epoch_wrapper_rejects_mixed_devices(cuda):
    cols = et.rbq10_columns(300, seed=9)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[8], device="cpu")
    data = et.prepare_data(m, cols)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, 64), cuda)
    fn = et.make_fused_epoch(m, "adam", et.LoggingLoss(), shuffle=False)
    packed = fn.plan.pack(m)  # on the CPU, the data on the card
    with pytest.raises(ValueError, match="parameters are on cpu"):
        fn(packed, fe.init_fused_opt_state(packed), tensors)


# --------------------------------------------------------------------------
# kernel 5: the fused multi-site epoch, and the multi-site primitives
# --------------------------------------------------------------------------

def _multisite_case(device, *, S=300, N=8, batch=None, hidden=(16, 16), act="swish",
                    norm="static", opt=("adam", 0.01), loss="mse", agg="sum", shuffle=False,
                    epochs=2, nan_frac=0.1, mask_batch=None, seed=0, target=None, **spec_kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(spec_kw)
    base = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed))
    m = et.MultiSiteHybridModel(base, S)
    assert base.device == m.device == torch.device("cuda", torch.cuda.current_device())
    data = et.gen_multisite_arrays(S, N, seed=seed, nan_frac=nan_frac, site_idx=True)
    if mask_batch is not None:
        data.y["reco"][mask_batch * batch:(mask_batch + 1) * batch] = np.nan
    et.fit_input_norm(m, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch or S), device)
    ll = et.LoggingLoss(training_loss=_loss(loss), loss_types=("mse",), agg=agg)
    aim = {} if target is None else dict(target_blocks=target)  # another number of blocks
    fn = et.make_fused_multisite_epoch(m, opt, ll, shuffle=shuffle, epochs_per_call=epochs, **aim)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device=device).manual_seed(seed))
    packed = fn.plan.pack(m)
    before = fm.launch_fused_multisite.launches
    got = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    torch.cuda.synchronize()
    again = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    assert fm.launch_fused_multisite.launches - before == 2  # one launcher call a run
    ref = fn.reference(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    for g, r in zip(_outputs(got), _outputs(ref)):
        assert torch.isfinite(g).all()
        assert bool(((g - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    assert torch.equal(got[1]["t"], ref[1]["t"])
    # sums in a fixed order: the same inputs give the same bits
    for a, b in zip(_outputs(got), _outputs(again)):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("kw", [
    dict(S=2000, N=64, epochs=3),                                   # the main path's widths
    dict(S=150, N=7),
    dict(batch=128, shuffle=True, epochs=3),                        # ragged last batch
    dict(batch=128, shuffle="batches", epochs=3),
    dict(batch=128, shuffle=False, epochs=3),
    dict(opt=("sgd", 0.05), loss="mae", agg="mean"),
    dict(loss="nseLoss", batch=128, shuffle=True),
    dict(norm=False, nan_frac=0.0),
    dict(hidden=(64, 48), act="selu", N=9),
    dict(neural_param_names=["Q10"], global_param_names=["rb"]),   # per-site rb
    dict(batch=128, mask_batch=1, nan_frac=0.0),
    dict(N=200, S=40),                                              # a site of 200 rows
    dict(N=1000, S=30, epochs=2),                                   # a site over four tiles
    dict(N=1, S=700),
    dict(N=1, S=700, **TWO_GLOBALS),                                # 512 globals, 256 threads
    dict(N=1, S=20, **TWO_GLOBALS),                                 # 40 globals, 32 threads
    dict(N=3, S=500, batch=128, shuffle=True),
    dict(N=63, S=300),
    dict(N=65, S=301, batch=100, shuffle="batches"),                # a ragged last block
    dict(S=3000, N=64, epochs=1, target=8 * 132),                   # 750 blocks, beyond 528
], ids=str)
def test_multisite_kernel_matches_plain_and_repeats_bitwise(cuda, kw):
    _multisite_case(cuda, **kw)


@pytest.mark.parametrize("kw", [
    dict(loss="rmse", S=2000, N=64),                                # one target, one batch
    dict(loss="rmse", batch=128, shuffle=True, epochs=3),           # a factor a minibatch
    dict(loss="pinball", S=2000, N=64),
    dict(loss="huber_sum", batch=128, shuffle="batches", agg="mean", epochs=3),
], ids=str)
def test_multisite_kernel_matches_plain_under_the_new_losses(cuda, kw):
    _multisite_case(cuda, **kw)


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_multisite_kernel_matches_plain_under_every_rule(cuda, opt):
    # minibatched sites, 9 steps; lamb's per-site leaves span every block
    _multisite_case(cuda, opt=opt, batch=128, shuffle=True, epochs=3)


@pytest.mark.parametrize("act", sorted(et.ACTIVATIONS))
def test_multisite_kernel_activations_match_plain(cuda, act):
    _multisite_case(cuda, hidden=(12, 5), act=act, S=100, N=6, epochs=1)


def test_masked_site_batch_counts_no_step(cuda):
    got = _multisite_case(cuda, batch=128, mask_batch=0, nan_frac=0.0, epochs=2)
    assert int(got[1]["t"][0]) == 2 * 2  # 3 batches an epoch, the first without a target


def test_train_takes_the_multisite_kernel(cuda):
    base = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    m = et.MultiSiteHybridModel(base, 400)
    data = et.gen_multisite_arrays(400, 16, seed=1, nan_frac=0.1)
    before = fm.launch_fused_multisite.launches
    prims = mp.launch_primitive.launches
    r = et.train(m, data, nepochs=6, eval_every=2, batchsize=128, show_progress=False)
    assert r.epoch_path == "cuda_fused_multisite" and "exactness gate passed" in r.engine_reason
    assert fm.launch_fused_multisite.launches - before == 3 + 2  # three blocks + the gate's two
    assert mp.launch_primitive.launches > prims  # the per-site target counts
    assert m.device.type == "cuda" and r.params["globals.Q10"].shape == (400, 1)


def test_multisite_wrapper_rejects_mixed_devices(cuda):
    base = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[8], device="cpu")
    m = et.MultiSiteHybridModel(base, 50, device="cpu")
    tensors = epoch_tensors_to(et.build_epoch_tensors(et.gen_multisite_arrays(50, 4), 50), cuda)
    fn = et.make_fused_multisite_epoch(m, "adam", et.LoggingLoss(), shuffle=False)
    packed = fn.plan.pack(m)  # on the CPU, the data on the card
    with pytest.raises(ValueError, match="parameters are on cpu"):
        fn(packed, fe.init_fused_opt_state(packed), tensors)


def test_multisite_primitives_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    S, B, N = 1000, 300, 17
    vals = torch.rand(S, device=cuda, generator=g)
    idx = torch.randperm(S, device=cuda, generator=g)[:B].int()
    idx[::7] = -1
    x = torch.rand(B, N, device=cuda, generator=g)
    fresh = torch.rand(B, device=cuda, generator=g)
    before = mp.launch_primitive.launches
    # exact: the gather and the masked update
    assert torch.equal(mp.site_gather(vals, idx, N).cpu(), mp.site_gather(vals.cpu(), idx.cpu(), N))
    got, want = vals.clone(), vals.cpu().clone()
    mp.site_update(got, idx, fresh)
    mp.site_update(want, idx.cpu(), fresh.cpu())
    assert torch.equal(got.cpu(), want)
    # sums: another order than torch's, a few ulp
    torch.testing.assert_close(mp.site_reduce(x), x.sum(1), rtol=1e-6, atol=1e-6)
    acc, ref = torch.ones(S, device=cuda), torch.ones(S)
    mp.site_chain(vals, idx, x, acc)
    mp.site_chain(vals.cpu(), idx.cpu(), x.cpu(), ref)
    torch.testing.assert_close(acc.cpu(), ref, rtol=1e-6, atol=1e-6)
    parts = torch.rand(500, 338, device=cuda, generator=g)
    first, second = mp.block_sum(parts), mp.block_sum(parts)
    assert torch.equal(first, second)
    torch.testing.assert_close(first, parts.sum(0), rtol=1e-5, atol=1e-5)
    assert mp.launch_primitive.launches - before == 6
    mask = (torch.rand(B, N, device=cuda, generator=g) > 0.3).float()
    assert torch.equal(mp.site_reduce(mask), mask.sum(1))  # whole numbers: exact in any order
    with pytest.raises(ValueError, match="contiguous"):
        mp.site_reduce(x.T)


@pytest.mark.parametrize("n_obs", [1, 3, 63, 64, 65, 1000])
def test_row_sums_match_plain_at_odd_widths(cuda, n_obs):
    """``site_reduce`` and ``site_chain`` share a row among a group of lanes:
    widths below, at and above a group's reach, 16-byte loads or not."""
    g = torch.Generator(device=cuda).manual_seed(n_obs)
    S, B = 400, 301
    vals = torch.rand(S, device=cuda, generator=g)
    idx = torch.randperm(S, device=cuda, generator=g)[:B].int()
    idx[::7] = -1
    x = torch.rand(B, n_obs, device=cuda, generator=g)
    tol = dict(rtol=1e-6, atol=1e-5 * n_obs)
    torch.testing.assert_close(mp.site_reduce(x), x.sum(1), **tol)
    assert torch.equal(mp.site_reduce(x), mp.site_reduce(x))
    acc, ref = torch.ones(S, device=cuda), torch.ones(S)
    mp.site_chain(vals, idx, x, acc)
    mp.site_chain(vals.cpu(), idx.cpu(), x.cpu(), ref)
    torch.testing.assert_close(acc.cpu(), ref, **tol)
    mask = (x > 0.3).float()
    assert torch.equal(mp.site_reduce(mask), mask.sum(1))  # whole numbers: exact in any order
    off = x.reshape(-1)[1:1 + (B - 1) * n_obs].view(B - 1, n_obs)  # a base off the 16-byte grid
    torch.testing.assert_close(mp.site_reduce(off), off.sum(1), **tol)


# --------------------------------------------------------------------------
# kernel 4: the fused LSTM epoch
# --------------------------------------------------------------------------

def _lstm_case(device, *, hidden=16, steps=10, out_steps=1, batch=128, norm="static",
               opt=("adam", 0.01), loss="nseLoss", agg="sum", shuffle=True, epochs=2, n=1500,
               nan_frac=0.0, mask_first=0, seed=0, cluster=0):
    cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    cols["reco"][:mask_first] = np.nan
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm=norm,
        generator=torch.Generator().manual_seed(seed))
    assert m.device.type == "cuda"  # built without device=
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    data = split_into_sequences(rows, input_window=steps, output_window=out_steps,
                                lead_time=0)
    et.fit_input_norm(m, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), device)
    ll = et.LoggingLoss(training_loss=_loss(loss), loss_types=("mse",), agg=agg)
    fn = et.make_fused_lstm_epoch(m, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    if cluster:  # a geometry the plan picks for another batch
        fn.plan = dataclasses.replace(fn.plan, cluster=cluster)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device=device).manual_seed(seed))
    packed = fn.plan.pack(m)
    before = fl.launch_fused_lstm.launches
    got = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    torch.cuda.synchronize()
    assert fl.launch_fused_lstm.launches - before == 1
    again = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    ref = fn.reference(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    for g, r in zip(_outputs(got), _outputs(ref)):
        assert torch.isfinite(g).all()
        assert bool(((g - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    assert torch.equal(got[1]["t"], ref[1]["t"]) and torch.equal(got[0].bn, packed.bn)
    # sums in a fixed order, no atomics: the same inputs give the same bits
    for a, b in zip(_outputs(got), _outputs(again)):
        assert torch.equal(a, b)
    return got, fn


@pytest.mark.parametrize("kw", [
    dict(epochs=4),                                                  # the main path's shape
    dict(hidden=8, steps=6, out_steps=2, norm=False, opt=("sgd", 0.05), loss="mae",
         shuffle=False, n=600),
    dict(nan_frac=0.3, batch=100, loss="mse"),                       # ragged last batch
    dict(shuffle="batches", loss="mse", agg="mean", out_steps=10),   # every step has a target
    dict(steps=32), dict(steps=64, n=600),                           # fewer windows a block
    dict(hidden=32, loss="mse"), dict(hidden=64, n=400, epochs=1),   # each compiled hidden size
    dict(hidden=5, steps=3, batch=7, n=60),
    dict(batch=512, norm=False, loss="mse", n=4000, epochs=1),       # the JAX bench's shape
    dict(batch=1000, loss="mse", n=3000, epochs=1),                  # more than a cluster holds
    dict(hidden=4, steps=300, out_steps=300, norm=False, loss="mse", n=700, epochs=1),  # 3 of 4
], ids=str)
def test_lstm_kernel_matches_plain_and_repeats_bitwise(cuda, kw):
    _lstm_case(cuda, **kw)


@pytest.mark.parametrize("kw", [
    dict(loss="pinball", epochs=4),                                   # the main path's shape
    dict(loss="huber_sum", nan_frac=0.3, batch=100, out_steps=2, agg="mean"),
], ids=str)
def test_lstm_kernel_matches_plain_under_a_traced_loss(cuda, kw):
    _lstm_case(cuda, **kw)


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_lstm_kernel_matches_plain_under_every_rule(cuda, opt):
    # a cluster of blocks, each updating its slice (lamb's leaves straddle
    # them); 8 steps
    _lstm_case(cuda, opt=opt, loss="mse", batch=64, n=300, epochs=2, cluster=4)


def test_lstm_tiles_follow_the_window(cuda):
    windows = []
    for steps in (10, 32, 64):
        _, fn = _lstm_case(cuda, steps=steps, n=300, epochs=1)
        assert fn.plan.sizes.fits_one_block(steps, 1, fn.plan.width)  # the envelope
        g = fn.plan.geometry(128, steps, 1)
        assert g.cluster * g.windows * g.tiles >= 128
        windows.append(g.windows)
    assert windows == [16, 16, 8]  # a block holds fewer windows as the window grows


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_lstm_every_cluster_size_matches_plain_and_repeats_bitwise(cuda, cluster):
    """Every geometry the plan can pick at the main shape: one block walking
    eight tiles, 2 to 8 blocks, and the non-portable cluster of 16."""
    _, fn = _lstm_case(cuda, cluster=cluster, epochs=2)
    g = fn.plan.geometry(128, 10, 1)
    assert g.cluster == cluster and g.tiles == {1: 8, 2: 4, 4: 2}.get(cluster, 1)


def test_lstm_masked_batches_count_no_step(cuda):
    got, _ = _lstm_case(cuda, shuffle=False, mask_first=2 * 128 + 9, n=1033, epochs=2)
    assert int(got[1]["t"][0]) == 2 * (8 - 2)  # 1,024 windows in 8 batches, two without a target


def test_lstm_argument_struct_matches_its_mirror(cuda):
    assert _build.load_library().eh_fused_lstm_args_size() == ctypes.sizeof(fl._Args)


def test_train_takes_the_lstm_kernel(cuda):
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": 16},
        scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    before = fl.launch_fused_lstm.launches
    r = et.train(m, et.rbq10_columns(1200, seed=7), nepochs=6, eval_every=2, batchsize=128,
                 optimizer=("adam", 0.01), training_loss="nseLoss", loss_types=["nseLoss", "mse"],
                 show_progress=False,
                 sequence_kwargs=dict(input_window=10, output_window=1, lead_time=0))
    assert r.epoch_path == "cuda_fused_lstm" and "exactness gate passed" in r.engine_reason
    assert fl.launch_fused_lstm.launches - before == 3 + 2  # three blocks + the gate's two runs
    assert m.device.type == "cuda" and np.isfinite(r.val_pred_columns["reco_pred"]).all()
    assert set(r.val_pred_columns) == {"sample", "step", "reco_pred"}


def test_lstm_wrapper_rejects_mixed_devices(cuda):
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": 4},
        device="cpu")
    cols = et.rbq10_columns(200, seed=9)
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    tensors = epoch_tensors_to(et.build_epoch_tensors(
        split_into_sequences(rows, input_window=5, output_window=1), 64), cuda)
    fn = et.make_fused_lstm_epoch(m, "adam", et.LoggingLoss(), shuffle=False)
    packed = fn.plan.pack(m)  # on the CPU, the data on the card
    with pytest.raises(ValueError, match="parameters are on cpu"):
        fn(packed, fe.init_fused_opt_state(packed), tensors)


# --------------------------------------------------------------------------
# kernel 4's cluster-split form: the LSTMs one block cannot hold
# --------------------------------------------------------------------------

def _split_case(device, *, hidden=72, features=2, steps=10, out_steps=1, batch=128,
                norm="static", opt=("adam", 0.01), loss="nseLoss", agg="sum", shuffle=True,
                epochs=2, n=600, nan_frac=0.0, mask_first=0, seed=0, cluster=0):
    """The split form against its plain version, and a second run of it
    against the first, bit for bit; ``features`` predictors, the example's
    two and standard normal columns beyond them."""
    cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    cols["reco"][:mask_first] = np.nan
    rng = np.random.default_rng(seed)
    extra = [rng.normal(size=n).astype(np.float32) for _ in range(features - 2)]
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"] + [f"p{i}" for i in range(features - 2)],
        forcing=["ta"], targets=["reco"], mechanistic_model=et.rbq10,
        parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm=norm,
        generator=torch.Generator().manual_seed(seed))
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"], *extra], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    data = split_into_sequences(rows, input_window=steps, output_window=out_steps, lead_time=0)
    et.fit_input_norm(m, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), device)
    ll = et.LoggingLoss(training_loss=_loss(loss), loss_types=("mse",), agg=agg)
    assert fe.fused_engine(m, tensors).epoch_path == "cuda_fused_lstm_split"
    fn = et.make_fused_lstm_split_epoch(m, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    if cluster:  # another cluster than the plan's
        fn.plan = dataclasses.replace(fn.plan, cluster=cluster)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device=device).manual_seed(seed))
    packed = fn.plan.pack(m)
    before = fs.launch_fused_lstm_split.launches
    got = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    torch.cuda.synchronize()
    assert fs.launch_fused_lstm_split.launches - before == 1
    again = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    ref = fn.reference(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    for g, r in zip(_outputs(got), _outputs(ref)):
        assert torch.isfinite(g).all()
        assert bool(((g - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    assert torch.equal(got[1]["t"], ref[1]["t"]) and torch.equal(got[0].bn, packed.bn)
    for a, b in zip(_outputs(got), _outputs(again)):  # rank-ordered sums: the same bits
        assert torch.equal(a, b)
    return got, fn


# past LSTM(72) a gradient element can cancel to rounding level over its
# (window, step) pairs, and adam's first steps move it by a visible share of
# the learning rate whatever its size: sgd holds those shapes by their gradient
SGD = ("sgd", 0.05)


@pytest.mark.parametrize("kw", [
    dict(epochs=4),                                                   # LSTM(72), 10 steps
    dict(hidden=128, steps=32, n=400, opt=SGD),                       # past one block's
    dict(hidden=256, steps=32, n=300, epochs=1, opt=SGD),             # the main path's shape
    dict(hidden=256, features=64, steps=32, batch=33, n=120, epochs=1, opt=SGD),
    dict(hidden=64, features=64, steps=16, n=400, opt=SGD),           # 64 features
    dict(hidden=72, features=64, batch=1, n=30, epochs=1, loss="mse", opt=SGD),  # a window a batch
    dict(hidden=128, features=64, batch=1000, n=1100, epochs=1, opt=SGD),  # 16 tiles
    dict(hidden=100, steps=6, out_steps=6, norm=False, opt=("sgd", 0.001), loss="mse",
         shuffle=False, nan_frac=0.3),
    dict(shuffle="batches", agg="mean", out_steps=3, nan_frac=0.3, loss="mse"),
], ids=str)
def test_lstm_split_kernel_matches_plain_and_repeats_bitwise(cuda, kw):
    _split_case(cuda, **kw)


@pytest.mark.parametrize("loss", ["mse", "mae", "rmse", "pearsonLoss", "kgeLoss", "pbkgeLoss",
                                  "pinball"])
def test_lstm_split_kernel_matches_plain_under_every_loss(cuda, loss):
    _split_case(cuda, loss=loss, out_steps=2, nan_frac=0.2, batch=64, n=300)


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_lstm_split_kernel_matches_plain_under_every_rule(cuda, opt):
    # lamb's leaves over the blocks' own rows and block 0's shared parameters
    _split_case(cuda, opt=opt, loss="mse", batch=64, n=300, epochs=2)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_lstm_split_every_cluster_size_matches_plain(cuda, cluster):
    _, fn = _split_case(cuda, hidden=72, features=3, cluster=cluster, n=300)
    assert fn.plan.geometry(128).cluster == cluster


def test_lstm_split_masked_batches_count_no_step(cuda):
    got, _ = _split_case(cuda, shuffle=False, mask_first=2 * 128 + 9, n=1033, epochs=2,
                         loss="kgeLoss")
    assert int(got[1]["t"][0]) == 2 * (8 - 2)  # 1,024 windows in 8 batches, two without a target


def test_lstm_split_argument_struct_matches_its_mirror(cuda):
    lib = _build.load_library()
    assert lib.eh_fused_lstm_split_args_size() == ctypes.sizeof(fs._SplitArgs)


def test_lstm_split_halted_launch_changes_nothing(cuda):
    _, fn = _split_case(cuda, epochs=1, n=300)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": 72},
        scale_nn_outputs=True, input_batchnorm="static")
    cols = et.rbq10_columns(300, seed=0)
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    data = split_into_sequences(rows, input_window=10, output_window=1)
    et.fit_input_norm(m, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, 128), cuda)
    packed = fn.plan.pack(m)
    opt0 = fe.init_fused_opt_state(packed)
    perms = perms_for_epochs(fn.shuffle, tensors, fn.epochs,
                             generator=torch.Generator(device=cuda).manual_seed(1))
    halt = torch.ones((1,), dtype=torch.int32, device=cuda)
    p, o, loss = fn(packed, opt0, tensors, perms=perms, halt=halt)
    assert torch.equal(p.params, packed.params) and float(loss) == 0.0
    assert all(torch.equal(o[k], opt0[k]) for k in opt0)
    free = fn(packed, opt0, tensors, perms=perms, halt=torch.zeros_like(halt))
    plain = fn(packed, opt0, tensors, perms=perms)
    assert torch.equal(free[0].params, plain[0].params) and bool(loss == 0.0)


def test_train_takes_the_lstm_split_kernel(cuda):
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": 128},
        scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    before = fs.launch_fused_lstm_split.launches
    r = et.train(m, et.rbq10_columns(1200, seed=7), nepochs=6, eval_every=2, batchsize=128,
                 optimizer=("adam", 0.01), training_loss="nseLoss", loss_types=["nseLoss", "mse"],
                 show_progress=False,
                 sequence_kwargs=dict(input_window=32, output_window=1, lead_time=0))
    assert r.epoch_path == "cuda_fused_lstm_split" and "exactness gate passed" in r.engine_reason
    assert fs.launch_fused_lstm_split.launches - before == 3 + 2  # three blocks + the gate's two
    assert np.isfinite(r.val_pred_columns["reco_pred"]).all()


# --------------------------------------------------------------------------
# kernel 3: the wide fused epoch
# --------------------------------------------------------------------------

def _wide_case(device, *, hidden=(128, 64), act="swish", norm="static", opt=("adam", 0.01),
               loss="mse", agg="sum", shuffle=True, epochs=2, n=1000, batch=256, nan_frac=0.0,
               mask_first=0, seed=0, l2=None):
    cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    cols["reco"][:mask_first] = np.nan
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
        generator=torch.Generator().manual_seed(seed))
    assert m.device.type == "cuda"  # built without device=
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    et.fit_input_norm(m, et.prepare_data(m, cols))
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), device)
    ll = et.LoggingLoss(training_loss=_loss(loss), loss_types=("mse",), agg=agg,
                        extra_loss=None if l2 is None else et.l2_extra_loss(l2))
    fn = et.make_fused_wide_epoch(m, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device=device).manual_seed(seed))
    packed = fn.plan.pack(m)
    before = fw.launch_fused_wide.launches
    got = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    torch.cuda.synchronize()
    assert fw.launch_fused_wide.launches - before == 1
    again = fn(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    ref = fn.reference(packed, fe.init_fused_opt_state(packed, opt), tensors, perms=perms)
    assert torch.equal(got[1]["t"], ref[1]["t"])
    if norm is True:  # the running statistics' EMA, from the batches alone
        assert not torch.equal(got[0].bn, packed.bn)
        assert bool(((got[0].bn - ref[0].bn).abs() <= EPOCH_TOL * ref[0].bn.abs().clamp_min(1)).all())
    else:
        assert torch.equal(got[0].bn, packed.bn)
    # sums in a fixed order, no atomics: the same inputs give the same bits
    for a, b in zip(_outputs(got) + [got[0].bn], _outputs(again) + [again[0].bn]):
        assert torch.equal(a, b)
    return packed, got, ref, fn


def _assert_wide_close(got, ref):
    for g, r in zip(_outputs(got), _outputs(ref)):
        assert torch.isfinite(g).all()
        assert bool(((g - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(hidden=(100, 37), act="tanh", n=777, batch=100),              # no multiple of the tile
    # a small step: on raw predictors sgd at 0.05 diverges and float32 itself is the limit
    dict(norm=False, opt=("sgd", 1e-3), loss="mae", shuffle=False),
    dict(nan_frac=0.3, batch=300, agg="mean"),                         # ragged last batch
    dict(hidden=(65,), act="gelu", shuffle="batches", n=2000, batch=300),
    dict(hidden=(300, 200, 100), n=600, batch=64, epochs=1),           # several tiles each way
    dict(hidden=(5,), n=40, batch=7),
], ids=str)
def test_wide_kernel_matches_plain_and_repeats_bitwise(cuda, kw):
    _, got, ref, _ = _wide_case(cuda, **kw)
    _assert_wide_close(got, ref)


@pytest.mark.parametrize("kw", [
    dict(loss="pinball"),
    dict(loss="huber_sum", nan_frac=0.3, batch=300, agg="mean"),      # ragged last batch
], ids=str)
def test_wide_kernel_matches_plain_under_a_traced_loss(cuda, kw):
    _, got, ref, _ = _wide_case(cuda, **kw)
    _assert_wide_close(got, ref)


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_wide_kernel_matches_plain_under_every_rule(cuda, opt):
    # tensor-core and FMA layers, lamb's leaves over many update blocks; 6 steps
    _, got, ref, _ = _wide_case(cuda, opt=opt, hidden=(128, 64), n=800, batch=256, epochs=2)
    _assert_wide_close(got, ref)


@pytest.mark.parametrize("act", sorted(et.ACTIVATIONS))
def test_wide_kernel_activations_match_plain(cuda, act):
    _, got, ref, _ = _wide_case(cuda, hidden=(70, 33), act=act, n=500, batch=128, epochs=1)
    _assert_wide_close(got, ref)


def test_wide_masked_batch_counts_no_step(cuda):
    _, got, ref, _ = _wide_case(cuda, shuffle=False, mask_first=128, n=1024, batch=128, epochs=1)
    assert int(got[1]["t"][0]) == 7  # 8 batches, the first without a target
    _assert_wide_close(got, ref)


@pytest.mark.parametrize("kw", [
    dict(norm=True),
    # several tiles each way; adam at 1e-3: at 0.01 one rounding-level element of layer 1's W
    # moves by a share of lr, and the float32 plain version itself ends 4.8e-4 from float64
    # there (tools/dev_fused_wide_gpu.py --drift --drift-bn)
    dict(norm=True, hidden=(300, 200, 100), n=600, batch=64, epochs=1, opt=("adam", 1e-3)),
    *[dict(loss=loss, nan_frac=0.3, batch=300, agg="mean")               # ragged last batch
      for loss in ("nseLoss", "rmse", "pearsonLoss", "kgeLoss", "pbkgeLoss")],
    dict(norm=True, loss="kgeLoss", n=1200, batch=600),                   # three head blocks
    dict(norm=True, loss="rmse", opt=("sgd", 1e-3), shuffle="batches", n=1000, batch=500),
], ids=str)
def test_wide_kernel_matches_plain_under_batchnorm_and_the_moment_losses(cuda, kw):
    _, got, ref, fn = _wide_case(cuda, **kw)
    assert fn.plan.loss == kw.get("loss", "mse")
    _assert_wide_close(got, ref)


def test_wide_masked_batch_under_a_statistic_loss_takes_no_step(cuda):
    _, got, ref, _ = _wide_case(cuda, norm=True, loss="kgeLoss", shuffle=False, mask_first=128,
                                n=1024, batch=128, epochs=1)
    assert int(got[1]["t"][0]) == 7  # 8 batches, the first without a target
    _assert_wide_close(got, ref)


@pytest.mark.parametrize("kw", [
    dict(l2=0.5),
    dict(l2=0.5, agg="mean", nan_frac=0.3, batch=300),                   # ragged last batch
    dict(l2=1e-2, norm=True, hidden=(300, 200, 100), n=600, batch=64, epochs=1,
         opt=("adam", 1e-3)),                                             # the tutorial's form
    dict(l2=1e-2, opt=("lamb", 0.01), n=800),                             # lamb's two passes
    dict(l2=0.5, hidden=(80,), loss="kgeLoss", agg="mean"),               # FMA layers only
], ids=str)
def test_wide_kernel_matches_plain_with_the_weight_l2(cuda, kw):
    """The declarative weight-L2 extra_loss on kernel 3: the gradient term in
    the update, the value from the update's sums of squares a step ahead."""
    _, got, ref, fn = _wide_case(cuda, **kw)
    assert fn.plan.l2 is not None
    _assert_wide_close(got, ref)


def _wide_members(cuda, *, kind, k=3, norm="static", hidden=(128, 64), batch=256, epochs=2,
                  loss="mse", bf16=False):
    """A kernel-3 member launch's inputs on the card: k members at 1,200
    rows, batch ``batch``; a learning-rate sweep over shared data and one
    permutation (a duplicate member), a seed ensemble of their own
    permutations, or folds with a fold's rows and norm each."""
    from easyhybrid_tpu_torch.training import population as pop

    cols = et.rbq10_columns(1200, seed=4, nan_frac=0.1)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation="swish", scale_nn_outputs=True, input_batchnorm=norm, device=cuda,
        compute_dtype=torch.bfloat16 if bf16 else None)
    ll = et.LoggingLoss(training_loss=loss, loss_types=("mse",))
    sweep, folds = kind == "sweep", kind == "folds"
    specs = [("adam", {"learning_rate": lr}) for lr in (1e-3, 3e-3, 1e-3)[:k]] if sweep else None
    fn = et.make_fused_wide_epoch(m, ("adam", 1e-3), ll, shuffle=True, epochs_per_call=epochs)
    prepared = et.prepare_data(m, cols)
    splits = ([prepared.take(np.arange(i, prepared.n_samples, k)[: prepared.n_samples // k])
               for i in range(k)] if folds else [et.split_data(cols, m)[0]])
    inits = [pop.init_member_params(m, 0 if sweep else s) for s in range(k)]
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = []
    for i in range(k):
        et.fit_input_norm(m, splits[i % len(splits)])
        buffers.append({n: b.detach().clone() for n, b in m.named_buffers()})
    buffers = {n: torch.stack([b[n] for b in buffers]) for n in buffers[0]}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(m), params, buffers)
    opt = pop._stacked_opt_state(packed, ("adam", 1e-3), k)
    tensors = [epoch_tensors_to(et.build_epoch_tensors(s, batch), cuda) for s in splits]
    data = fn.member_data(tensors if folds else tensors[0])
    rows = fn.member_rows(data, k, per_member_data=folds,
                          generator=torch.Generator(device=cuda).manual_seed(1),
                          shared_perms=sweep)
    return fn, packed, opt, data, rows, specs, tensors


@pytest.mark.parametrize("kw", [
    dict(kind="sweep"),
    dict(kind="ensemble", norm=True, hidden=(300, 100), batch=64, epochs=1),  # trainable norm
    dict(kind="folds", loss="kgeLoss"),
    dict(kind="ensemble", hidden=(80,), loss="rmse"),                         # FMA layers only
    dict(kind="sweep", bf16=True),
], ids=str)
def test_wide_member_launch_matches_plain_and_each_member_alone(cuda, kw):
    """K members in one call of kernel 3 within 1e-4 * max(1, |plain|) of the
    member axis's plain version, every member bit for bit a call of it alone
    (train()'s call at its spec, rows and data), the same bits twice, and
    the member self-check. A bf16 build's members are held to their calls
    alone and their second run only (against the plain version the bf16
    builds' one-ulp criterion holds them, tests/test_torch_bf16.py)."""
    from easyhybrid_tpu_torch.training import population as pop

    fn, packed, opt, data, rows, specs, tensors = _wide_members(cuda, **kw)
    before = fw.launch_fused_wide.launches
    got = fn.members(packed, opt, data, rows, specs=specs)
    torch.cuda.synchronize()
    assert fw.launch_fused_wide.launches - before == 1
    again = fn.members(packed, opt, data, rows, specs=specs)
    ref = fw.fused_wide_members_reference(fn.plan, packed, opt, data, rows, specs=specs)
    for a, b, r in zip((got[0].params, got[0].bn, *got[1].values(), got[2]),
                       (again[0].params, again[0].bn, *again[1].values(), again[2]),
                       (ref[0].params, ref[0].bn, *ref[1].values(), ref[2])):
        assert torch.equal(a, b)
        if not kw.get("bf16"):
            a, r = a.float(), r.float()
            assert bool(((a - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    for i in range(packed.params.shape[0]):
        p, o, loss = fn.alone(fe.FusedParams(packed.params[i], packed.bn[i]),
                              {k: v[i] for k, v in opt.items()}, data,
                              rows[i] if rows.dim() == 3 else rows,
                              None if specs is None else specs[i])
        assert torch.equal(p.params, got[0].params[i]) and torch.equal(p.bn, got[0].bn[i])
        assert all(torch.equal(o[k], got[1][k][i]) for k in o)
        assert torch.equal(loss[0], got[2][i])
    if kw["kind"] == "sweep":  # the duplicate member
        assert torch.equal(got[0].params[0], got[0].params[2])
    assert pop.member_selfcheck(fn, packed, opt, tensors if kw["kind"] == "folds" else tensors[0],
                                specs=specs, per_member_data=kw["kind"] == "folds",
                                shared_perms=kw["kind"] == "sweep") is None


def _wide_branches(cuda, *, k, bf16):
    """Kernel 3 on a MultiNN model whose branches are past kernel 2's widths
    (rb over sw_pot and dsw_pot [96, 40], gpp_max over sw_pot [72], a global
    Q10, static norm) in batches of 256: the fused epoch (under bf16 one sgd
    step at 1e-3 over the first 256 rows, else adam for 2 shuffled epochs of
    1,200 rows) and, for ``k`` > 1, ``k`` members of a seed ensemble, each
    its own permutation."""
    from easyhybrid_tpu_torch.training import population as pop

    cols = et.rbq10_columns(1200, seed=6, nan_frac=0.1)
    cols["nee"] = (cols["reco"] - 5.0 * (1.0 - np.exp(-0.1 * cols["ta"]))).astype(np.float32)
    m = et.construct_hybrid_model(
        **{**BRANCH_SPECS["two_branches_static"], "hidden_layers": {"rb": [96, 40], "gpp_max": [72]}},
        generator=torch.Generator().manual_seed(0), device=cuda,
        compute_dtype=torch.bfloat16 if bf16 else None)
    data = et.prepare_data(m, cols)
    et.fit_input_norm(m, data)
    if bf16:
        data = data.take(np.arange(256))
    opt = ("sgd", 1e-3) if bf16 else ("adam", 0.01)
    fn = et.make_fused_wide_epoch(m, opt, et.LoggingLoss(), shuffle=not bf16,
                                  epochs_per_call=1 if bf16 else 2)
    assert len(fn.plan.nets) == 2 and fn.plan.bf16 == bf16
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, 256), cuda)
    if k == 1:
        packed = fn.plan.pack(m)
        perms = perms_for_epochs(fn.shuffle, tensors, fn.epochs,
                                 generator=torch.Generator(device=cuda).manual_seed(1))
        return fn, packed, fe.init_fused_opt_state(packed, opt), tensors, perms
    inits = [pop.init_member_params(m, s) for s in range(k)]
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = {n: torch.stack([b.detach().clone()] * k) for n, b in m.named_buffers()}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(m), params, buffers)
    data = fn.member_data(tensors)
    rows = fn.member_rows(data, k, per_member_data=False,
                          generator=torch.Generator(device=cuda).manual_seed(1), shared_perms=False)
    return fn, packed, pop._stacked_opt_state(packed, opt, k), data, rows


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_wide_kernel_runs_every_branch(cuda, k, bf16):
    """Kernel 3 on the JAX kernel's branch view against its plain version
    and against itself: float32 after 2 epochs of adam within 1e-4 * max(1,
    |plain|) at K = 1, and each of K = 4 members by the Adam runs' criterion
    (``chip_smoke.adam_misses``: at most 1% of the elements beyond that, none
    more than 2 lr apart; adam's first steps turn a gradient element that
    cancels to about 0 into a step of lr either way); the bf16 build by the
    gradient one sgd step at 1e-3 implies, within 1e-4 * max(1, |g|) or one
    bf16 ulp beyond it on at most 0.1% of the elements
    (``chip_smoke.bf16_beyond``); the same bits twice; K = 4 members each bit
    for bit its call alone."""
    import chip_smoke as cs

    if k == 1:
        fn, packed, opt, tensors, perms = _wide_branches(cuda, k=1, bf16=bf16)
        before = fw.launch_fused_wide.launches
        got = fn(packed, opt, tensors, perms=perms)
        torch.cuda.synchronize()
        assert fw.launch_fused_wide.launches - before == 1
        again = fn(packed, opt, tensors, perms=perms)
        ref = fn.reference(packed, opt, tensors, perms=perms)
        flat = lambda r: (r[0].params, r[0].bn, *r[1].values(), r[2].reshape(1))  # noqa: E731
    else:
        fn, packed, opt, data, rows = _wide_branches(cuda, k=k, bf16=bf16)
        got = fn.members(packed, opt, data, rows)
        again = fn.members(packed, opt, data, rows)
        ref = fw.fused_wide_members_reference(fn.plan, packed, opt, data, rows)
        flat = lambda r: (r[0].params, r[0].bn, *r[1].values(), r[2])  # noqa: E731
        for i in range(k):
            p, o, loss = fn.alone(fe.FusedParams(packed.params[i], packed.bn[i]),
                                  {n: v[i] for n, v in opt.items()}, data,
                                  rows[i] if rows.dim() == 3 else rows)
            assert torch.equal(p.params, got[0].params[i]) and torch.equal(loss[0], got[2][i])
            assert all(torch.equal(o[n], got[1][n][i]) for n in o)
    for a, b in zip(flat(got), flat(again)):
        assert torch.equal(a, b)
    if not bf16 and k > 1:
        for i in range(k):
            note, misses, _ = cs.adam_misses(cs.member_fields(got, i), cs.member_fields(ref, i),
                                             0.01)
            assert not misses, f"member {i}: {note}: {misses}"
        return
    if not bf16:
        for a, r in zip(flat(got), flat(ref)):
            a, r = a.float(), r.float()
            assert torch.isfinite(a).all()
            assert bool(((a - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
        return
    g_got, g_ref = (packed.params - got[0].params) / 1e-3, (packed.params - ref[0].params) / 1e-3
    out, far, _ = cs.bf16_beyond(g_got, g_ref, 1e-4)
    assert out <= 1e-3 * g_ref.numel() and far == 0
    loss, ref_loss = got[2].float(), ref[2].float()
    assert bool(((loss - ref_loss).abs() <= 1e-4 * ref_loss.abs().clamp_min(1)).all())


def test_a_one_member_wide_call_is_trains_call(cuda):
    """A member call of one member (no member rows) gives train()'s call's
    bits, and the argument struct carries the member axis's strides."""
    fn, packed, opt, data, rows, _, _ = _wide_members(cuda, kind="ensemble", k=2)
    one = fe.FusedParams(packed.params[:1].contiguous(), packed.bn[:1].contiguous())
    one_opt = {k: v[:1].contiguous() for k, v in opt.items()}
    got = fn.members(one, one_opt, data, rows[:1].contiguous())
    p, o, loss = fn.alone(fe.FusedParams(packed.params[0], packed.bn[0]),
                          {k: v[0] for k, v in opt.items()}, data, rows[0])
    assert torch.equal(got[0].params[0], p.params) and torch.equal(got[2][0], loss[0])
    a = fw.wide_launch_args(fn.plan, packed, opt, data, rows, 2).args
    lay = fn.plan.layout(data.batch)
    assert (a.n_members, a.ws_stride, a.part_stride) == (2, lay.ws_floats, lay.part_floats)
    assert a.perm_stride == rows.shape[1] * rows.shape[2]


def test_population_train_takes_the_wide_member_axis(cuda):
    """A sweep, a bf16 seed ensemble and a fold split of a wide MLP through
    the entry points: kernel 3's member axis behind its gate and self-check,
    one launcher call per block for every member, no call waiting for the
    device between the first block and the fetch; a population whose
    members' workspaces exceed the card's share is refused with a reason."""
    from easyhybrid_tpu_torch.training import deferred

    cols = et.rbq10_columns(2000, seed=42)
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[128, 64],
        activation="swish", scale_nn_outputs=True, input_batchnorm="static")
    m = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(0))
    bf = et.construct_hybrid_model(**spec, compute_dtype=torch.bfloat16,
                                   generator=torch.Generator().manual_seed(0))
    deferred.SYNC_DEBUG_MODE = "error"
    try:
        sweep = et.population_train(m, cols, hyper={"learning_rate": [0.003, 0.01, 0.03, 0.01]},
                                    nepochs=10, batchsize=256, eval_every=5, seed=11)
        ens = et.population_train(bf, cols, seeds=[0, 1, 2], nepochs=10, batchsize=256,
                                  eval_every=5)
        cv = et.population_cross_validate(m, cols, k=3, nepochs=10, batchsize=256, eval_every=5)
    finally:
        deferred.SYNC_DEBUG_MODE = 0
    for r, calls in ((sweep, 2), (ens, 2), (cv, 2)):
        assert r.epoch_path.endswith("_fused"), r.engine_reason
        assert "member self-check passed" in r.engine_reason
        assert r.kernel_launches == calls and np.isfinite(r.best_losses).all()
    assert all(torch.equal(v[1], v[3]) for v in sweep.params.values())
    tensors = epoch_tensors_to(et.build_epoch_tensors(et.split_data(cols, m)[0], 256), cuda)
    ll = et.LoggingLoss()
    assert fw.fused_wide_unsupported_reason(m, "adam", ll, tensors) is None
    too_many = fw.fused_wide_unsupported_reason(m, "adam", ll, tensors, memory_bytes=10 ** 7,
                                                members=64)
    assert too_many is not None and "64 members' steps" in too_many


def test_wide_tower_gradient_matches_plain(cuda):
    """The tower at full width: the gradient that one sgd step at lr 1e-3
    over 1,024 rows implies, on every one of its elements."""
    packed, got, ref, fn = _wide_case(cuda, hidden=(1024, 512, 256, 128, 64), opt=("sgd", 1e-3),
                                      shuffle=False, epochs=1, n=1024, batch=1024)
    assert fn.plan.n_params == 700_422
    g_got, g_ref = (packed.params - got[0].params) / 1e-3, (packed.params - ref[0].params) / 1e-3
    assert float(g_ref.abs().max()) > 1e-2
    assert bool(((g_got - g_ref).abs() <= EPOCH_TOL * g_ref.abs().clamp_min(1)).all())


# kernel 3's tensor-core product alone (3xTF32 wgmma, the pieces of the inner
# dimension summed in a cluster) against a float64 product: the tower's
# forward, data and weight-gradient shapes at batch 64 and 1,024, and widths
# that are no multiple of the instruction tile
WIDE_PRODUCTS = sorted({
    shape
    for batch in (64, 1024)
    for din, dout in ((1024, 512), (512, 256), (256, 128), (128, 64))
    for shape in ((batch, dout, din), (batch, din, dout), (dout, din, batch))
} | {(64, 33, 65), (1024, 100, 33), (64, 65, 100), (1024, 37, 100), (33, 65, 1024),
     (100, 33, 64)})


@pytest.mark.parametrize("m,n,k", WIDE_PRODUCTS, ids=str)
def test_wide_tensor_core_product_matches_float64(cuda, m, n, k):
    """Within 1e-4 max(1, |ref|) of the float64 product in the plan's
    geometry and in both tile shapes with one piece and with the most."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + n * 5 + k)
    a = torch.randn(m, k, device=cuda, generator=g)
    b = torch.randn(n, k, device=cuda, generator=g)
    ref = a.double() @ b.double().T
    depth = -(-k // 32)
    geometries = [None]
    for bm in (64, 128):
        for pieces in {1, max(p for p in (1, 2, 4, 8) if p <= depth)}:
            split_k = -(-depth // pieces) * 32
            if -(-k // split_k) == pieces:
                geometries.append(fw.Product(fw.TENSOR_CORES, bm, 64, pieces, split_k))
    for geo in geometries:
        got = fw._wide_product(a, b, geo)
        torch.cuda.synchronize()
        assert got.shape == (m, n) and torch.isfinite(got).all()
        assert bool(((got.double() - ref).abs() <= 1e-4 * ref.abs().clamp_min(1)).all()), geo


def test_wide_argument_struct_matches_its_mirror(cuda):
    assert _build.load_library().eh_fused_wide_args_size() == ctypes.sizeof(fw._Args)


def test_train_takes_the_wide_kernel_and_the_others_keep_theirs(cuda):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], activation="swish",
        scale_nn_outputs=True, input_batchnorm="static")
    cols = et.rbq10_columns(1200, seed=7)
    kw = dict(nepochs=6, eval_every=2, batchsize=128, optimizer=("adam", 0.01), show_progress=False)
    m = et.construct_hybrid_model(hidden_layers=[128, 64], **spec,
                                  generator=torch.Generator().manual_seed(0))
    before = fw.launch_fused_wide.launches
    r = et.train(m, cols, **kw)
    assert r.epoch_path == "cuda_fused_wide" and "exactness gate passed" in r.engine_reason
    assert fw.launch_fused_wide.launches - before == 3 + 2  # three blocks + the gate's two runs
    assert m.device.type == "cuda" and np.isfinite(r.val_pred_columns["reco_pred"]).all()
    small = et.construct_hybrid_model(hidden_layers=[16, 16], **spec,
                                      generator=torch.Generator().manual_seed(0))
    assert et.train(small, cols, **kw).epoch_path == "cuda_fused_epoch"
    off = et.train(et.construct_hybrid_model(hidden_layers=[128, 64], **spec), cols,
                   use_kernel=False, **kw)
    assert off.epoch_path == "torch"
    # a trainable norm and the moment losses take kernel 3 too
    for loss in ("mse", "nseLoss", "kgeLoss"):
        bn = et.construct_hybrid_model(hidden_layers=[128, 64], **{**spec, "input_batchnorm": True},
                                       generator=torch.Generator().manual_seed(0))
        r = et.train(bn, cols, training_loss=loss, loss_types=["mse"], **kw)
        assert r.epoch_path == "cuda_fused_wide" and "exactness gate passed" in r.engine_reason
        assert np.isfinite(r.val_pred_columns["reco_pred"]).all()


def test_wide_wrapper_rejects_mixed_devices(cuda):
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[128], device="cpu")
    data = et.prepare_data(m, et.rbq10_columns(200, seed=9))
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, 64), cuda)
    fn = et.make_fused_wide_epoch(m, "adam", et.LoggingLoss(), shuffle=False)
    packed = fn.plan.pack(m)  # on the CPU, the data on the card
    with pytest.raises(ValueError, match="parameters are on cpu"):
        fn(packed, fe.init_fused_opt_state(packed), tensors)


# --------------------------------------------------------------------------
# the halt word of kernels 2-5 and the deferred loop
# --------------------------------------------------------------------------

def _halt_case(device, kind):
    """``(fn, packed, tensors, perms, opt)``: a small run of kernel 2 (the
    quick-start, trainable BN; or its multi-network build on a MultiNN model
    of two networks under adamw and nseLoss, as ExpoHybrid's), 3 ([128, 64]),
    4 (LSTM(16), 10-step windows) or 5 (300 sites x 8, minibatched)."""
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], activation="swish",
        scale_nn_outputs=True, input_batchnorm="static")
    ll = et.LoggingLoss(loss_types=("mse",))
    opt = ("adam", 0.01)
    gen = torch.Generator().manual_seed(0)
    if kind == "kernel 2, two networks":
        opt = ("adamw", 0.01)
        m = et.construct_hybrid_model(**BRANCH_SPECS["two_branches_static"], generator=gen)
        cols = et.rbq10_columns(1500, seed=0)
        cols["nee"] = (cols["reco"] - 5.0 * (1.0 - np.exp(-0.1 * cols["ta"]))).astype(np.float32)
        rows = et.prepare_data(m, cols)
        et.fit_input_norm(m, rows)
        tensors = epoch_tensors_to(et.build_epoch_tensors(rows, 128), device)
        fn = et.make_fused_epoch(m, opt, et.LoggingLoss(training_loss="nseLoss",
                                                        loss_types=("nseLoss",)),
                                 shuffle=True, epochs_per_call=2)
    elif kind == "kernel 5":
        m = et.MultiSiteHybridModel(
            et.construct_hybrid_model(**spec, hidden_layers=[16, 16], generator=gen), 300)
        data = et.gen_multisite_arrays(300, 8, seed=0, nan_frac=0.1, site_idx=True)
        et.fit_input_norm(m, data)
        tensors = epoch_tensors_to(et.build_epoch_tensors(data, 128), device)
        fn = et.make_fused_multisite_epoch(m, opt, ll, shuffle=True, epochs_per_call=2)
    else:
        cols = et.rbq10_columns(1500, seed=0)
        rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                          forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
        if kind == "kernel 4":
            lstm_spec = {k: v for k, v in spec.items() if k != "activation"}
            m = et.construct_hybrid_model(**lstm_spec, hidden_layers={"lstm": 16}, generator=gen)
            rows = split_into_sequences(rows, input_window=10, output_window=1, lead_time=0)
            make = et.make_fused_lstm_epoch
        else:
            hidden = [128, 64] if kind == "kernel 3" else [16, 16]
            m = et.construct_hybrid_model(**{**spec, "input_batchnorm": kind == "kernel 2"},
                                          hidden_layers=hidden, generator=gen)
            make = et.make_fused_wide_epoch if kind == "kernel 3" else et.make_fused_epoch
        et.fit_input_norm(m, rows)
        tensors = epoch_tensors_to(et.build_epoch_tensors(rows, 128), device)
        fn = make(m, opt, ll, shuffle=True, epochs_per_call=2)
    perms = perms_for_epochs(True, tensors, 2, generator=torch.Generator(device=device).manual_seed(0))
    return fn, fn.plan.pack(m), tensors, perms, opt


@pytest.mark.parametrize("kind", ["kernel 2", "kernel 2, two networks", "kernel 3", "kernel 4",
                                  "kernel 5"])
def test_a_halted_launch_returns_its_inputs(cuda, kind):
    """With the halt word set every kernel of the call returns at entry: the
    parameters, the BatchNorm statistics and every slot of the opt state
    (the step count too) come back bit for bit, and the loss is 0. With the
    word clear the call gives the bits of a call without one."""
    fn, packed, tensors, perms, opt = _halt_case(cuda, kind)
    state = fe.init_fused_opt_state(packed, opt)
    state["m"].normal_(generator=torch.Generator(device=cuda).manual_seed(1))  # slots not all zero
    halt = torch.ones((), dtype=torch.int32, device=cuda)
    got = fn(packed, state, tensors, perms=perms, halt=halt)
    torch.cuda.synchronize()
    assert torch.equal(got[0].params, packed.params) and torch.equal(got[0].bn, packed.bn)
    assert set(got[1]) == set(state)
    for k in state:
        assert torch.equal(got[1][k], state[k]), k
    assert float(got[2]) == 0.0
    plain = fn.reference(packed, state, tensors, perms=perms, halt=halt)
    assert torch.equal(plain[0].params, packed.params) and torch.equal(plain[1]["t"], state["t"])
    live = fn(packed, state, tensors, perms=perms, halt=torch.zeros_like(halt))
    free = fn(packed, state, tensors, perms=perms)
    assert int(live[1]["t"][0]) > int(state["t"][0])
    for a, b in zip([live[0].params, live[0].bn, *live[1].values()],
                    [free[0].params, free[0].bn, *free[1].values()]):
        assert torch.equal(a, b)


def test_train_deferred_equals_eager_on_kernel_2_with_an_early_stop(cuda):
    """The deferred loop against the eager one on kernel 2: an early stop at
    a large step, tracked and monitored parameters, gradient norms and the
    prediction history, bit for bit; no call waits for the device between
    the first block and the final fetch (``set_sync_debug_mode("error")``)."""
    from easyhybrid_tpu_torch.training import deferred

    cols = et.rbq10_columns(2000, seed=8)
    kw = dict(nepochs=40, batchsize=256, optimizer=("adam", 0.05), patience=3,
              tracked_params=["Q10"], monitor_names=["rb"], return_gradients=True,
              keep_history=True, random_seed=7)

    def run(show_progress):
        m = et.construct_hybrid_model(
            predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
            mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
            neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
            activation="swish", scale_nn_outputs=True, input_batchnorm=True,
            generator=torch.Generator().manual_seed(0))
        return et.train(m, cols, show_progress=show_progress, **kw)

    deferred.SYNC_DEBUG_MODE = "error"
    try:
        d = run(False)
    finally:
        deferred.SYNC_DEBUG_MODE = 0
    e = run(True)
    assert d.epoch_path == e.epoch_path == "cuda_fused_epoch"
    assert (d.loop_mode, e.loop_mode) == ("deferred", "eager")
    assert d.engine_reason.endswith("; zero-readback")
    assert len(d.val_history) < 41 and deferred.loop_record(d).stop_index == len(d.val_history) - 1
    assert d.train_history == e.train_history and d.val_history == e.val_history
    assert (d.best_epoch, d.best_loss) == (e.best_epoch, e.best_loss)
    assert d.tracked == e.tracked and d.monitored == e.monitored
    assert d.grad_history == e.grad_history
    for k in d.params:
        assert torch.equal(d.params[k], e.params[k]), k
    for k in d.state:
        assert torch.equal(d.state[k], e.state[k]), k
    for k in e.opt_state:
        assert torch.equal(d.opt_state[k], e.opt_state[k]), k
    for k in d.final_grads:
        assert torch.equal(d.final_grads[k], e.final_grads[k]), k
    for a, b in zip(d.history.snapshots, e.history.snapshots):
        assert np.array_equal(a.y_hat_val["reco"], b.y_hat_val["reco"])
        assert np.array_equal(a.y_hat_train["parameters"]["rb"], b.y_hat_train["parameters"]["rb"])
    np.testing.assert_array_equal(d.val_pred_columns["reco_pred"], e.val_pred_columns["reco_pred"])


# ---- kernel 2's member axis ------------------------------------------------------


def _member_launch(cuda, *, per_member_data, sweep, norm="static", k=3):
    """A member launch's inputs on the card: k members of the quick-start
    model ([16, 16] swish) at 1,500 rows' training split, batch 256, 2
    epochs; a sweep of learning rates (member rows) over shared data and
    one permutation, or members of their own permutations (and folds)."""
    from easyhybrid_tpu_torch.training import population as pop

    cols = et.rbq10_columns(1500, seed=4)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm=norm, device=cuda)
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    specs = [("adam", {"learning_rate": lr}) for lr in (0.001, 0.05, 0.001)[:k]] if sweep else None
    fn = et.make_fused_epoch(m, ("adam", 0.001), ll, shuffle=True, epochs_per_call=2)
    prepared = et.prepare_data(m, cols)
    splits = ([prepared.take(np.arange(i, prepared.n_samples, k)[: prepared.n_samples // k])
               for i in range(k)] if per_member_data else [et.split_data(cols, m)[0]])
    inits = [pop.init_member_params(m, 0 if sweep else s) for s in range(k)]  # a sweep: one init
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = []
    for i in range(k):
        et.fit_input_norm(m, splits[i % len(splits)])
        buffers.append({n: b.detach().clone() for n, b in m.named_buffers()})
    buffers = {n: torch.stack([b[n] for b in buffers]) for n in buffers[0]}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(m), params, buffers)
    opt = pop._stacked_opt_state(packed, ("adam", 0.001), k)
    tensors = [epoch_tensors_to(et.build_epoch_tensors(s, 256), cuda) for s in splits]
    data = fn.member_data(tensors if per_member_data else tensors[0])
    rows = fn.member_rows(data, k, per_member_data=per_member_data,
                          generator=torch.Generator(device=cuda).manual_seed(1),
                          shared_perms=sweep)
    return fn, packed, opt, data, rows, specs


@pytest.mark.parametrize("per_member_data,sweep,norm", [
    (False, True, "static"), (False, False, True), (True, False, "static")], ids=str)
def test_member_launch_matches_plain_and_each_member_alone(cuda, per_member_data, sweep, norm):
    """K members in one launch within 1e-4 * max(1, |plain|) of the member
    axis's plain version, every member bit for bit a launch of it alone
    (train()'s launch at its spec, rows and data), and a second run's bits."""
    fn, packed, opt, data, rows, specs = _member_launch(cuda, per_member_data=per_member_data,
                                                        sweep=sweep, norm=norm)
    before = fe.launch_fused_epoch.launches
    got = fn.members(packed, opt, data, rows, specs=specs)
    torch.cuda.synchronize()
    assert fe.launch_fused_epoch.launches - before == 1
    again = fn.members(packed, opt, data, rows, specs=specs)
    ref = fe.fused_members_reference(fn.plan, packed, opt, data, rows, specs=specs)
    for a, b, r in zip((got[0].params, got[0].bn, *got[1].values(), got[2]),
                       (again[0].params, again[0].bn, *again[1].values(), again[2]),
                       (ref[0].params, ref[0].bn, *ref[1].values(), ref[2])):
        assert torch.equal(a, b)
        a, r = a.float(), r.float()
        assert bool(((a - r).abs() <= 1e-4 * r.abs().clamp_min(1)).all())
    for i in range(packed.params.shape[0]):
        plan = fe.member_plan(fn.plan, None if specs is None else specs[i])
        p = fe.FusedParams(packed.params[i].clone(), packed.bn[i].clone())
        o = {k: v[i].clone() for k, v in opt.items()}
        loss = torch.zeros((1,), device=cuda)
        fe.launch_fused_epoch(plan, p, o, data, (rows[i] if rows.dim() == 3 else rows).contiguous(),
                              loss)
        assert torch.equal(p.params, got[0].params[i]) and torch.equal(p.bn, got[0].bn[i])
        assert all(torch.equal(o[k], got[1][k][i]) for k in o)
        assert torch.equal(loss[0], got[2][i])
    if sweep:  # the duplicate member
        assert torch.equal(got[0].params[0], got[0].params[2])


def test_population_train_takes_the_member_axis(cuda):
    """A sweep and a fold split through the entry points: the member axis
    behind its gate and self-check, one launch per block for every member,
    no call waiting for the device between the first block and the fetch."""
    from easyhybrid_tpu_torch.training import deferred

    cols = et.rbq10_columns(2000, seed=42)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    deferred.SYNC_DEBUG_MODE = "error"
    try:
        sweep = et.population_train(m, cols, hyper={"learning_rate": [0.003, 0.01, 0.03, 0.01]},
                                    nepochs=20, batchsize=256, eval_every=5, seed=11)
        cv = et.population_cross_validate(m, cols, k=3, nepochs=10, batchsize=256, eval_every=5)
    finally:
        deferred.SYNC_DEBUG_MODE = 0
    assert sweep.epoch_path == "population_vmap_fused", sweep.engine_reason
    assert "member self-check passed" in sweep.engine_reason
    assert sweep.kernel_launches == 4 and cv.kernel_launches == 2
    assert all(torch.equal(v[1], v[3]) for v in sweep.params.values())
    assert np.isfinite(sweep.best_losses).all() and sweep.val_history["mse"].shape == (4, 4)
    assert cv.epoch_path == "population_vmap_cv_fused", cv.engine_reason
    assert np.isfinite(cv.best_losses).all() and cv.best_losses.shape == (3,)
    torch_run = et.population_train(m, cols, hyper={"learning_rate": [0.003, 0.01]}, nepochs=5,
                                    batchsize=256, eval_every=5, use_kernel=False)
    assert torch_run.epoch_path == "population_vmap" and np.isfinite(torch_run.best_losses).all()
    assert torch_run.kernel_launches == 0


def test_a_refused_member_axis_runs_the_torch_engine_under_auto(cuda, monkeypatch):
    """With use_kernel="auto" a failed member self-check runs the torch
    engine and names the failure; with use_kernel=True it raises."""
    from easyhybrid_tpu_torch.training import population as pop

    monkeypatch.setattr(pop, "_VERDICTS", {})
    monkeypatch.setattr(pop, "member_selfcheck", lambda *a, **k: "member 2 differs in m")
    cols = et.rbq10_columns(600, seed=4)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    kw = dict(hyper={"learning_rate": [0.003, 0.01]}, nepochs=2, batchsize=128, eval_every=2)
    r = et.population_train(m, cols, **kw)
    assert (r.epoch_path, r.engine_reason, r.kernel_launches) == (
        "population_vmap", "member self-check failed: member 2 differs in m", 0)
    with pytest.raises(RuntimeError, match="member self-check failed: member 2 differs in m"):
        et.population_train(m, cols, use_kernel=True, **kw)


# ---- kernel 4's two-pass losses and member axis ----------------------------------


@pytest.mark.parametrize("kw", [
    dict(loss="rmse", epochs=4),                                      # the main path's shape
    dict(loss="pearsonLoss", epochs=4),
    dict(loss="kgeLoss", out_steps=2, nan_frac=0.2, n=1500),         # output window > 1
    dict(loss="pbkgeLoss", out_steps=3, nan_frac=0.3, batch=100, agg="mean", hidden=8),
    dict(loss="pearsonLoss", batch=1000, n=3000, epochs=1),           # tiles, the last partial
    dict(loss="rmse", batch=1000, n=3000, epochs=1, opt=("lamb", 0.01)),
    dict(loss="kgeLoss", batch=512, norm=False, n=4000, epochs=1),    # a cluster of 16
    dict(loss="rmse", cluster=16, epochs=2),
], ids=str)
def test_lstm_kernel_matches_plain_under_the_two_pass_losses(cuda, kw):
    _lstm_case(cuda, **kw)


@pytest.mark.parametrize("loss", ["pearsonLoss", "rmse"])
def test_lstm_two_pass_masked_batches_count_no_step(cuda, loss):
    got, _ = _lstm_case(cuda, loss=loss, shuffle=False, mask_first=2 * 128 + 9, n=1033, epochs=2)
    assert int(got[1]["t"][0]) == 2 * (8 - 2)  # no step on a batch without a valid target


def _lstm_members(cuda, *, k, loss, sweep, folds):
    """A kernel-4 member launch on the card: k members of LSTM(16) on
    10-step windows of 1,500 rows, batch 128, 2 epochs; a learning-rate sweep
    with one permutation, or members of their own permutations (and each
    its own windows)."""
    from easyhybrid_tpu_torch.training import population as pop

    cols = et.rbq10_columns(1500, seed=4)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": 16},
        scale_nn_outputs=True, input_batchnorm="static", device=cuda)
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    specs = [("adam", {"learning_rate": lr}) for lr in (0.003, 0.03, 0.003)[:k]] if sweep else None
    fn = et.make_fused_lstm_epoch(m, ("adam", 0.003), ll, shuffle=True, epochs_per_call=2)
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    windows = split_into_sequences(rows, input_window=10, output_window=1, lead_time=0)
    splits = ([windows.take(np.arange(i, windows.n_samples, k)[: windows.n_samples // k])
               for i in range(k)] if folds else [windows])
    inits = [pop.init_member_params(m, 0 if sweep else s) for s in range(k)]
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = []
    for i in range(k):
        et.fit_input_norm(m, splits[i % len(splits)])
        buffers.append({n: b.detach().clone() for n, b in m.named_buffers()})
    buffers = {n: torch.stack([b[n] for b in buffers]) for n in buffers[0]}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(m), params, buffers)
    opt = pop._stacked_opt_state(packed, ("adam", 0.003), k)
    tensors = [epoch_tensors_to(et.build_epoch_tensors(s, 128), cuda) for s in splits]
    data = fn.member_data(tensors if folds else tensors[0])
    idx = fn.member_rows(data, k, per_member_data=folds,
                         generator=torch.Generator(device=cuda).manual_seed(1), shared_perms=sweep)
    return fn, packed, opt, data, idx, specs


@pytest.mark.parametrize("loss,sweep,folds", [
    ("nseLoss", True, False), ("kgeLoss", False, False), ("rmse", False, True)], ids=str)
def test_lstm_member_launch_matches_plain_and_each_member_alone(cuda, loss, sweep, folds):
    """K members in one kernel-4 launch within 1e-4 * max(1, |plain|) of the
    member axis's plain version, every member bit for bit a launch of it
    alone, and a second run's bits."""
    fn, packed, opt, data, idx, specs = _lstm_members(cuda, k=3, loss=loss, sweep=sweep,
                                                      folds=folds)
    before = fl.launch_fused_lstm.launches
    got = fn.members(packed, opt, data, idx, specs=specs)
    torch.cuda.synchronize()
    assert fl.launch_fused_lstm.launches - before == 1
    again = fn.members(packed, opt, data, idx, specs=specs)
    ref = fl.fused_lstm_members_reference(fn.plan, packed, opt, data, idx, specs=specs)
    for a, b, r in zip((got[0].params, got[0].bn, *got[1].values(), got[2]),
                       (again[0].params, again[0].bn, *again[1].values(), again[2]),
                       (ref[0].params, ref[0].bn, *ref[1].values(), ref[2])):
        assert torch.equal(a, b)
        a, r = a.float(), r.float()
        assert bool(((a - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    for i in range(3):
        p, o, loss_i = fn.alone(fe.FusedParams(packed.params[i], packed.bn[i]),
                                {k: v[i] for k, v in opt.items()}, data,
                                idx[i] if idx.dim() == 3 else idx,
                                None if specs is None else specs[i])
        assert torch.equal(p.params, got[0].params[i]) and torch.equal(p.bn, got[0].bn[i])
        assert all(torch.equal(o[k], got[1][k][i]) for k in o)
        assert torch.equal(loss_i[0], got[2][i])
    if sweep:  # the duplicate member
        assert torch.equal(got[0].params[0], got[0].params[2])


def test_population_train_takes_the_lstm_member_axis(cuda):
    """An LSTM sweep under kgeLoss and a fold split through the entry points:
    kernel 4's member axis behind its gate and self-check, one launch per
    block for every member, nothing waiting for the device in the loop."""
    from easyhybrid_tpu_torch.training import deferred

    cols = et.rbq10_columns(1500, seed=7)
    m = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": 16},
        scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    seq = dict(sequence_kwargs=dict(input_window=10, output_window=1, lead_time=0))
    deferred.SYNC_DEBUG_MODE = "error"
    try:
        sweep = et.population_train(m, cols, hyper={"learning_rate": [0.003, 0.01, 0.03, 0.01]},
                                    nepochs=10, batchsize=128, eval_every=5, seed=11,
                                    training_loss="kgeLoss", **seq)
        cv = et.population_cross_validate(m, cols, k=3, nepochs=10, batchsize=128, eval_every=5,
                                          training_loss="rmse", **seq)
    finally:
        deferred.SYNC_DEBUG_MODE = 0
    assert sweep.epoch_path == "population_vmap_fused", sweep.engine_reason
    assert "member self-check passed" in sweep.engine_reason
    assert sweep.kernel_launches == 2 and cv.kernel_launches == 2
    assert all(torch.equal(v[1], v[3]) for v in sweep.params.values())
    assert np.isfinite(sweep.best_losses).all() and sweep.val_history["kgeLoss"].shape == (2, 4)
    assert cv.epoch_path == "population_vmap_cv_fused", cv.engine_reason
    assert np.isfinite(cv.best_losses).all() and cv.best_losses.shape == (3,)


# ---- kernel 5's member axis ------------------------------------------------------


def _multisite_members(device, *, k=3, S=300, N=8, batch=128, shuffle=True, opt=("adam", 0.01),
                       loss="mse", masked=False, twin=False, **spec_kw):
    """A member call's inputs on the card: k members of a multi-site model
    drawn from seeds 0..k-1 over one data set, 2 epochs, each member with
    its own permutations (with ``twin``, the last member a copy of the first,
    its permutations too)."""
    from easyhybrid_tpu_torch.training import population as pop

    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm="static")
    spec.update(spec_kw)
    m = et.MultiSiteHybridModel(et.construct_hybrid_model(**spec, device=device), S)
    data = et.gen_multisite_arrays(S, N, seed=0, nan_frac=0.1, site_idx=True)
    if masked:
        data.y["reco"][batch:2 * batch] = np.nan  # every target of the second site batch
    et.fit_input_norm(m, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch or S), device)
    ll = et.LoggingLoss(training_loss=_loss(loss), loss_types=("mse",))
    fn = et.make_fused_multisite_epoch(m, opt, ll, shuffle=shuffle, epochs_per_call=2)
    seeds = list(range(k - 1)) + [0] if twin else list(range(k))
    inits = [pop.init_member_params(m, s) for s in seeds]
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = {n: b.detach().expand((k,) + tuple(b.shape)).clone() for n, b in m.named_buffers()}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(m), params, buffers)
    opt_state = pop._stacked_opt_state(packed, opt, k)
    shaped = fn.member_data(tensors)
    gen = torch.Generator(device=device).manual_seed(1)
    perms = [perms_for_epochs(shuffle, tensors, 2, generator=gen) for _ in range(k)]
    if twin and perms[0] is not None:
        perms[-1] = perms[0]
    rows = fn.member_rows(shaped, k, perms=None if perms[0] is None else torch.stack(perms))
    return fn, packed, opt_state, shaped, rows, tensors, perms


@pytest.mark.parametrize("kw", [
    dict(S=2000, N=64, batch=None),                  # one site batch: one index for all
    dict(shuffle=True, twin=True),
    dict(shuffle="batches", masked=True),            # the members' valid steps in other orders
    dict(shuffle=False, loss="rmse"),
    dict(opt=("lamb", 0.01), twin=True),             # per-member lamb parts
    dict(opt=("amsgrad", 0.01)),
    dict(S=40, N=1, batch=10, **TWO_GLOBALS),        # more of a tile's globals than threads
], ids=str)
def test_multisite_member_launch_matches_plain_and_each_member_alone(cuda, kw):
    """K members in one launcher call within 1e-4 * max(1, |plain|) of the
    member axis's plain version, every member bit for bit a call of it alone
    (train()'s call from its state on its permutations), a duplicate member
    its twin's bits, and a second run the first's."""
    fn, packed, opt, data, rows, tensors, perms = _multisite_members(cuda, **kw)
    before = fm.launch_fused_multisite.launches
    got = fn.members(packed, opt, data, rows)
    torch.cuda.synchronize()
    assert fm.launch_fused_multisite.launches - before == 1
    again = fn.members(packed, opt, data, rows)
    scale, valid = fm.member_scales(fn.plan, data, rows, same_batches=fn._same_batches(data))
    ref = fm.fused_multisite_members_reference(fn.plan, packed, opt, data, rows, scale, valid)
    for a, b, r in zip((got[0].params, *got[1].values(), got[2]),
                       (again[0].params, *again[1].values(), again[2]),
                       (ref[0].params, *ref[1].values(), ref[2])):
        assert torch.equal(a, b)
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all()
        assert bool(((a - r).abs() <= EPOCH_TOL * r.abs().clamp_min(1)).all())
    for i in range(packed.params.shape[0]):
        p = fe.FusedParams(packed.params[i].clone(), packed.bn[i].clone())
        o = {k: v[i].clone() for k, v in opt.items()}
        alone = fn(p, o, tensors, perms=perms[i])
        assert torch.equal(alone[0].params, got[0].params[i])
        assert all(torch.equal(alone[1][k], got[1][k][i]) for k in o)
        assert torch.equal(alone[2], got[2][i])
    if kw.get("twin"):
        assert torch.equal(got[0].params[0], got[0].params[-1])
        assert all(torch.equal(v[0], v[-1]) for v in got[1].values())


def test_a_one_member_multisite_launch_is_trains_launch(cuda):
    fn, packed, opt, data, rows, tensors, perms = _multisite_members(cuda, k=1, S=2000, N=64,
                                                                     batch=500)
    got = fn.members(packed, opt, data, rows)
    p = fe.FusedParams(packed.params[0].clone(), packed.bn[0].clone())
    alone = fn(p, {k: v[0].clone() for k, v in opt.items()}, tensors, perms=perms[0])
    assert torch.equal(alone[0].params, got[0].params[0])
    assert all(torch.equal(alone[1][k], got[1][k][0]) for k in opt)
    assert torch.equal(alone[2], got[2][0])


def test_population_train_takes_the_multisite_member_axis(cuda):
    """A seed ensemble of a multi-site model through the entry point: kernel
    5's member axis behind its gate and self-check, one launcher call per
    block for every member, no call waiting for the device between the
    first block and the fetch; then ensemble_predict on the card."""
    from easyhybrid_tpu_torch.training import deferred

    S, N = 200, 16
    cols = et.rbq10_columns(S * N, seed=7)
    cols["site"] = np.repeat(np.arange(S), N)
    base = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
        activation="swish", scale_nn_outputs=True, input_batchnorm="static",
        generator=torch.Generator().manual_seed(0))
    m = et.MultiSiteHybridModel(base, n_sites=S)
    data = et.prepare_multisite_data(base, cols, "site")
    deferred.SYNC_DEBUG_MODE = "error"
    try:
        before = fm.launch_fused_multisite.launches
        ens = et.population_train(m, data, seeds=[0, 1, 2], nepochs=10, batchsize=64,
                                  eval_every=5, split_data_at=0.8, seed=5)
        launches = fm.launch_fused_multisite.launches - before
    finally:
        deferred.SYNC_DEBUG_MODE = 0
    assert ens.epoch_path == "population_vmap_fused", ens.engine_reason
    assert ens.engine_reason.startswith("multisite kernel: exactness gate")
    assert ens.kernel_launches == 2 and launches >= 2
    assert np.isfinite(ens.best_losses).all() and ens.params["globals.Q10"].shape == (3, S, 1)
    out = et.ensemble_predict(m, ens, data)
    assert out["reco"].shape == (S, N) and out["reco_std"].shape == (S, N)
    assert np.isfinite(out["reco"][~np.isnan(out["reco"])]).all()


# ---------------------------------------------------------------------------
# compute_dtype=bfloat16: the bf16 builds of kernels 1-3 (-DEH_BF16)
# ---------------------------------------------------------------------------

def _bf16_model(device, hidden, norm="static", seed=0):
    return et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation="swish", scale_nn_outputs=True, input_batchnorm=norm,
        compute_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(seed), device=device)


def test_bf16_forward_matches_plain(cuda):
    """Kernel 1's bf16 build: every row within TOL of its plain version but
    rows where an activation ties at a bf16 rounding boundary (a float32
    sum in another order rounds it to the other neighbour), each within TOL
    plus one bf16 ulp on every hidden activation carried through the model
    (``chip_smoke.bf16_rows_held``, which also bounds their share)."""
    import chip_smoke as cs

    cols = et.rbq10_columns(5000, seed=3)
    cols["sw_pot"][::97] = np.nan
    m = _bf16_model(cuda, (16, 16))
    et.fit_input_norm(m, et.prepare_data(m, cols))
    data = et.prepare_data(m, cols, drop_missing_rows=False)
    x = torch.tensor(data.x, device=cuda)
    forcing = {k: torch.tensor(v, device=cuda) for k, v in data.forcing.items()}
    fn = et.make_fused_forward(m, batch_size=1024)
    assert fn.plan.bf16
    got, ref = fn(x, forcing), fn.reference(x, forcing)
    cs.bf16_rows_held("kernel 1's bf16 build", got, ref, m, x, forcing)
    assert all(torch.equal(_bits(got[k]), _bits(fn(x, forcing)[k])) for k in got)


@pytest.mark.parametrize("wide,norm", [(False, "static"), (False, True), (True, "static"),
                                       (True, True)], ids=str)
def test_bf16_training_gradient_matches_plain(cuda, wide, norm):
    """Kernel 2's and kernel 3's bf16 builds, the gradient one sgd step at
    1e-3 implies: within 1e-4 max(1, |g|), or one bf16 ulp beyond it on at
    most 0.1% of the elements (``chip_smoke.bf16_beyond``); the same bits on
    a second run."""
    import chip_smoke as cs

    cols = et.rbq10_columns(512, seed=5)
    m = _bf16_model(cuda, (128, 64) if wide else (16, 16), norm)
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    et.fit_input_norm(m, et.prepare_data(m, cols))
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, 512), cuda)
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    make = et.make_fused_wide_epoch if wide else et.make_fused_epoch
    fn = make(m, ("sgd", 1e-3), ll, shuffle=False)
    assert fn.plan.bf16
    p0 = fn.plan.pack(m)
    got = fn(p0, fe.init_fused_opt_state(p0), tensors)
    again = fn(p0, fe.init_fused_opt_state(p0), tensors)
    ref = fn.reference(p0, fe.init_fused_opt_state(p0), tensors)
    assert torch.equal(_bits(got[0].params), _bits(again[0].params))
    g_got, g_ref = (p0.params - got[0].params) / 1e-3, (p0.params - ref[0].params) / 1e-3
    out, far, _ = cs.bf16_beyond(g_got, g_ref, 1e-4)
    assert out <= 1e-3 * g_ref.numel() and far == 0
    assert abs(float(got[2]) - float(ref[2])) <= 1e-4 * max(1.0, abs(float(ref[2])))
