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

Every training kernel is also held, under each optimizer rule besides adam
and plain sgd (``RULES``), against its plain version at the same tolerance
on parameters and every slot of the opt state, with the same bits on a
second run.
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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = fused(cols)
    copies = {e.key: e.count for e in prof.key_averages() if "Memcpy" in e.key}
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


def _outputs(run):
    """A fused run's parameters, every opt-state slot and its loss."""
    packed, state, loss = run
    return [packed.params, *fe.opt_slots(state).values(), loss.reshape(1)]
# a multi-site model with two per-site globals: the network gives the form's tref
TWO_GLOBALS = dict(parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0),
                               "tref": (15.0, 10.0, 20.0)},
                   neural_param_names=["tref"], global_param_names=["rb", "Q10"])


def _epoch_case(device, *, hidden=(16, 16), act="swish", norm=True, opt=("adam", 0.01),
                shuffle=True, epochs=1, batch=256, n=2000, seed=0, nan_frac=0.0, mask_first=False):
    cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    if mask_first:
        cols["reco"][:batch] = np.nan
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
    )
    m = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed))
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    et.fit_input_norm(m, data)
    m.to(device)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), device)
    fn = et.make_fused_epoch(m, opt, et.LoggingLoss(), shuffle=shuffle, epochs_per_call=epochs)
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
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
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
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
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


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_lstm_kernel_matches_plain_under_every_rule(cuda, opt):
    # a cluster of blocks, each updating its slice (lamb's leaves straddle
    # them); 8 steps
    _lstm_case(cuda, opt=opt, loss="mse", batch=64, n=300, epochs=2, cluster=4)


def test_lstm_tiles_follow_the_window(cuda):
    windows = []
    for steps, rows in ((10, 64), (32, 32), (64, 16)):
        _, fn = _lstm_case(cuda, steps=steps, n=300, epochs=1)
        assert fn.plan.sizes.tile_rows(steps, 1) == rows  # the envelope
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
# kernel 3: the wide fused epoch
# --------------------------------------------------------------------------

def _wide_case(device, *, hidden=(128, 64), act="swish", norm="static", opt=("adam", 0.01),
               loss="mse", agg="sum", shuffle=True, epochs=2, n=1000, batch=256, nan_frac=0.0,
               mask_first=0, seed=0):
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
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
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
    assert torch.equal(got[1]["t"], ref[1]["t"]) and torch.equal(got[0].bn, packed.bn)
    # sums in a fixed order, no atomics: the same inputs give the same bits
    for a, b in zip(_outputs(got), _outputs(again)):
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
