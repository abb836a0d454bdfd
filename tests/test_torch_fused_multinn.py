"""Kernel 2's plain version (``fused_epoch_reference``) on the JAX kernel's
branch view: MultiNN models (one single-output MLP per neural parameter,
each over its own predictor columns) and a model with globals only (no
branch), against the JAX package's fused epoch kernel in interpret mode and
against the port's torch epoch; the branch layout, the envelope and its
reasons, the engine choice, the exactness gate, and the ctypes mirror of
``struct EhNet``.

Tolerances, float32, as tests/test_torch_fused_epoch.py: atol 2e-6 after one
epoch and 1e-5 after more, loss rtol 1e-5, every optimizer slot compared."""

import copy
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
from easyhybrid_tpu.ops.fused_epoch import supports_fused_epoch as jax_supports
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer

from test_torch_fused_epoch import (CU_SOURCE, assert_model_matches, assert_slots_match,
                                    assert_torch_slots_match, jax_perms)
from test_torch_kernel_forms import expo_columns

RBQ10_PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}


def nee_torch(*, ta, rb, gpp_max, Q10):
    reco = rb * Q10 ** (0.1 * (ta - 15.0))
    return {"nee": reco - gpp_max * (1.0 - torch.exp(-0.1 * ta))}


def nee_jnp(*, ta, rb, gpp_max, Q10):
    reco = rb * Q10 ** (0.1 * (ta - 15.0))
    return {"nee": reco - gpp_max * (1.0 - jnp.exp(-0.1 * ta))}


def reco_q(*, ta, rb, q, Q10):
    return {"reco": rb * Q10 ** (0.1 * (ta - 15.0)) + 0.1 * q}


def expo_model(*, ta, rb, k):
    """examples/expo_hybrid.py's exponential model."""
    return {"reco": rb * np.e ** (k * ta)}


def rbq10(*, ta, rb, Q10):
    return {"reco": rb * Q10 ** (0.1 * (ta - 15.0))}


# tests/test_fused.py:398-414: two branches sharing sw_pot, a global Q10
TWO_BRANCH = dict(
    predictors={"rb": ["sw_pot", "dsw_pot"], "gpp_max": ["sw_pot"]}, forcing=["ta"],
    targets=["nee"], parameters={**RBQ10_PARAMS, "gpp_max": (5.0, 0.0, 20.0)},
    global_param_names=["Q10"], hidden_layers=[8], activation="tanh", scale_nn_outputs=True,
    input_batchnorm="static")
# tests/test_fused.py:736-760: trainable BatchNorm in each branch
BN_BRANCH = dict(
    predictors={"rb": ["sw_pot"], "q": ["dsw_pot"]}, forcing=["ta"], targets=["reco"],
    parameters={**RBQ10_PARAMS, "q": (1.0, 0.0, 5.0)}, neural_param_names=["rb", "q"],
    global_param_names=["Q10"], hidden_layers=[6], activation="tanh", scale_nn_outputs=True,
    input_batchnorm=True)
# examples/expo_hybrid.py's spec; its keys (rb, k) are not in sorted order
EXPO = dict(
    predictors={"rb": ["sw_pot"], "k": ["moisture"]}, forcing=["ta"], targets=["reco"],
    parameters={"rb": (2.0, 0.0, 8.0), "k": (0.05, 0.0, 0.2)}, global_param_names=[],
    hidden_layers=[16, 16], activation="swish", scale_nn_outputs=True, input_batchnorm="static")
# branches of their own depth, widths and activation, no norm
MIXED = dict(
    predictors={"rb": ["sw_pot", "dsw_pot"], "gpp_max": ["ta"]}, forcing=["ta"], targets=["nee"],
    parameters={**RBQ10_PARAMS, "gpp_max": (5.0, 0.0, 20.0)}, global_param_names=["Q10"],
    hidden_layers={"rb": [12, 5], "gpp_max": [7]},
    activation={"rb": "swish", "gpp_max": "softplus"}, scale_nn_outputs=True)
# globals only: no predictors, no network
GLOBALS_ONLY = dict(
    predictors=[], forcing=["ta"], targets=["reco"], parameters=RBQ10_PARAMS,
    neural_param_names=[], global_param_names=["rb", "Q10"])

SPECS = {"two_branch": (TWO_BRANCH, nee_jnp, nee_torch), "bn_branch": (BN_BRANCH, reco_q, reco_q),
         "expo": (EXPO, expo_model, expo_model), "mixed": (MIXED, nee_jnp, nee_torch),
         "globals_only": (GLOBALS_ONLY, rbq10, rbq10)}


def columns(name, n, seed):
    if name == "expo":
        return expo_columns(n, seed=seed)
    cols = et.rbq10_columns(n, seed=seed)
    cols["nee"] = (cols["reco"] - 5.0 * (1.0 - np.exp(-0.1 * cols["ta"]))).astype(np.float32)
    return cols


def setup(name, n=512, batch=128, seed=13):
    """The same model in both packages from the JAX parameters (the static
    norm fitted per branch), the JAX and the port's epoch tensors."""
    spec, jax_fn, torch_fn = SPECS[name]
    jm = eh.construct_hybrid_model(**spec, mechanistic_model=jax_fn)
    tm = et.construct_hybrid_model(**spec, mechanistic_model=torch_fn, device="cpu")
    data = et.prepare_data(tm, columns(name, n, seed))
    params, state = jm.init(jax.random.PRNGKey(0))
    state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    jt = jax.device_put(jax_epoch_tensors(
        eh.prepare_data(jm, ((data.x, data.forcing), data.y)), batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


CASES = [
    # model, optimizer, training loss, shuffle, epochs
    ("two_branch", ("adam", 0.01), "mse", False, 1),
    ("bn_branch", ("adam", 0.01), "mse", True, 2),
    ("expo", ("adamw", 0.01), "nseLoss", True, 1),
    ("mixed", ("sgd", 0.05, 0.9), "mae", "batches", 2),
    ("globals_only", ("adam", 0.05), "mse", True, 1),
    ("two_branch", ("lamb", 0.01), "rmse", True, 1),
]


@pytest.mark.parametrize("name,opt,loss,shuffle,epochs", CASES, ids=str)
def test_reference_matches_jax_fused_epoch(name, opt, loss, shuffle, epochs):
    jm, params, state, jt, tm, tt = setup(name)
    jll = eh.LoggingLoss(training_loss=loss, loss_types=(loss,))
    assert jax_supports(jm, opt, jll)
    key = jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)

    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    fn = et.make_fused_epoch(tm, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, got_loss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                          perms=jax_perms(shuffle, key, epochs, nb, batch))
    atol = 2e-6 if epochs == 1 else 1e-5
    assert_model_matches(tm, jp, js, atol)
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(jos["t"][0])
    assert_slots_match(fn.plan, tm, os_, jos, atol)


@pytest.mark.parametrize("name,opt,loss,shuffle,epochs", CASES, ids=str)
def test_reference_matches_the_torch_epoch(name, opt, loss, shuffle, epochs):
    *_, tm, tt = setup(name)
    twin = copy.deepcopy(tm)
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    perms = tepoch.perms_for_epochs(shuffle, tt, epochs, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_epoch(tm, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    p0 = fn.plan.pack(tm)
    packed, os_, loss_ = fn(p0, fe.init_fused_opt_state(p0, opt), tt, perms=perms)
    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, ll, optim, shuffle=shuffle, epochs_per_call=epochs)
    state, tloss = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    atol = 2e-6 if epochs == 1 else 1e-5
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(packed.bn.numpy(), want.bn.numpy(), atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(float(loss_), float(tloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])
    assert_torch_slots_match(fn.plan, opt, os_, state, atol)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_gate_passes_on_the_plain_version(name):
    *_, tm, tt = setup(name)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), et.LoggingLoss(), tt,
                                         epochs_per_call=2, shuffle=True)
    assert ok and worst < 1e-4
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k])


def test_gate_fails_on_a_corrupted_branch_gradient(monkeypatch):
    """A fault in one branch's backward alone is caught."""
    *_, tm, tt = setup("expo")
    real = fe.reference_backward

    def corrupted(plan, p, fwd, dn):
        grads = real(plan, p, fwd, dn)
        grads[-1] = grads[-1] * 1.5  # the last branch's output bias
        return grads

    monkeypatch.setattr(fe, "reference_backward", corrupted)
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), et.LoggingLoss(), tt)
    assert not ok and worst > 0.1


def test_branch_layout_of_one_network_is_kernel_2s():
    """One network: the packed, padded and residual offsets kernel 2 had
    before it took branches (the quick-start's, written out)."""
    lay = fe.branch_layout((("nn", (2, 16, 16, 1), ("swish",) * 3),), True, 1)
    (net,) = lay.nets
    assert list(net.p_w) == [4, 52, 324] and list(net.p_b) == [36, 308, 340] and lay.p_g == 341
    assert list(net.pp_w) == [4, 84, 356] and lay.pp_g == 373 and lay.n_padded == 376
    assert (lay.r_xhat, lay.r_d0, net.r_h, net.r_d) == (0, 2, (4, 22, 54), (6, 38, 70))
    for dims, norm, g in [((2, 16, 16, 1), True, 1), ((3, 61, 7, 2), False, 3), ((1, 1), False, 1)]:
        lay = fe.branch_layout((("nn", dims, ()),), norm, g)
        f = dims[0]
        assert (lay.r_xhat, lay.r_d0, lay.nets[0].r_h[0]) == ((0, f, 2 * f) if norm else (0, 0, 0))
        assert lay.res_floats == ((3 * f if norm else f) + sum(dims[1:]) + sum(dims[1:-1]) + g)


def test_branch_layout_of_a_multinn_model():
    """The norm's scales of every column, then their biases, then each
    branch's layers in the model's order, then the globals: each leaf a
    segment of its own in packed order, columns side by side, outputs in
    neural order."""
    tm = et.construct_hybrid_model(**TWO_BRANCH, mechanistic_model=nee_torch, device="cpu")
    plan = fe.plan_fused_epoch(tm, ("lamb", 0.01), et.LoggingLoss())
    names = [name for name, _, _ in plan.segments]
    assert names[:4] == ["nns.rb.norm.scale", "nns.gpp_max.norm.scale", "nns.rb.norm.bias",
                         "nns.gpp_max.norm.bias"]
    assert names[4] == "nns.rb.layers.0.weight" and names[-1] == "globals.Q10"
    assert names.index("nns.gpp_max.layers.0.weight") == 4 + 4
    offsets = [off for _, off, _ in plan.segments]
    assert offsets == sorted(offsets) and plan.n_params == sum(
        int(np.prod(shape)) for _, _, shape in plan.segments)
    lay = plan.branch_layout
    assert [(n.col, n.out, n.dims) for n in lay.nets] == [(0, 0, (2, 8, 1)), (2, 1, (1, 8, 1))]
    assert lay.n_features == 3 and lay.n_neural == 1 + 1 and plan.tile_floats == lay.res_floats + 5
    o = fe.optimizer_struct(plan)
    assert o.n_leaves == 4 + 8 + 1 and o.leaf_end[o.n_leaves - 1] == plan.n_params
    # the packed parameters and statistics go back where they came from
    packed = plan.pack(tm)
    assert packed.bn.numel() == 6
    twin = copy.deepcopy(tm)
    for t in list(twin.parameters()) + list(twin.buffers()):
        t.data.zero_()
    plan.unpack(packed, twin)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k


def test_kernel_arguments_describe_every_branch():
    tm = et.construct_hybrid_model(**MIXED, mechanistic_model=nee_torch, device="cpu")
    plan = fe.plan_fused_epoch(tm, ("adam", 0.01), et.LoggingLoss())
    a = fe._Args.from_buffer_copy(plan.args_bytes)
    lay = plan.branch_layout
    assert a.n_nets == 2 and a.n_features == 3 and a.n_neural == 2 and a.norm_mode == 0
    for i, net in enumerate(lay.nets):
        n = a.nets[i]
        assert n.n_layers == len(net.dims) - 1 and list(n.dims[: len(net.dims)]) == list(net.dims)
        assert (n.col, n.out) == (net.col, net.out)
        assert list(n.pp_off_w[: n.n_layers]) == list(net.pp_w)
        assert list(n.r_off_d[: n.n_layers]) == list(net.r_d)
        assert n.r_off_out == a.r_off_out + net.out and n.r_off_d0 == a.r_off_d0 + net.col
    assert [ff._ACT_IDS[x] for x in lay.nets[1].acts] == list(a.nets[1].acts[:2])
    assert a.n_unit_table == plan.n_unit_table == fe.branch_gradient_units(
        [n.dims for n in lay.nets], False, 1)
    gl = fe.plan_fused_epoch(et.construct_hybrid_model(**GLOBALS_ONLY, mechanistic_model=rbq10,
                                                       device="cpu"), "adam", et.LoggingLoss())
    a = fe._Args.from_buffer_copy(gl.args_bytes)
    assert a.n_nets == 0 and a.n_features == 0 and a.n_params == 2 and a.n_unit_table == 1


def test_net_struct_and_its_mirror_agree():
    src = CU_SOURCE.with_name("eh_device.cuh").read_text()
    body = re.search(r"struct EhNet \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body))
    assert fields == [name for name, _ in fe._Net._fields_]
    assert int(re.search(r"#define EH_MAX_NETS (\d+)", src).group(1)) == fe.MAX_NETS


def test_envelope_admits_the_branch_view():
    ll = et.LoggingLoss()
    for name, (spec, _, fn) in SPECS.items():
        tm = et.construct_hybrid_model(**spec, mechanistic_model=fn, device="cpu")
        assert fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), ll) is None, name
        assert fe.fused_engine(tm).epoch_path == "cuda_fused_epoch"
    # kernel 1 keeps its SingleNN-only envelope (the JAX kernel 1's)
    multi = et.construct_hybrid_model(**EXPO, mechanistic_model=expo_model, device="cpu")
    assert "not a SingleNNHybridModel" in ff.fused_forward_unsupported_reason(multi)
    glob = et.construct_hybrid_model(**GLOBALS_ONLY, mechanistic_model=rbq10, device="cpu")
    assert "no neural network" in ff.fused_forward_unsupported_reason(glob)


def _lstm_branch(*, ta, rb, Q10):
    return {"reco": rb * Q10 ** (0.1 * (ta - 15.0))}


@pytest.mark.parametrize("overrides,reason", [
    (dict(hidden_layers={"rb": [8], "k": [65]}), "branch 'k': layer widths"),
    (dict(activation={"rb": "tanh", "k": torch.tanh}), "branch 'k': activation"),
    (dict(hidden_layers={"lstm": 8}), "branch 'rb': the network is a LSTMNet"),
    (dict(hidden_layers=[64] * 4), "shared memory"),
    (dict(predictors={f"p{i}": ["sw_pot"] for i in range(9)},
          parameters={f"p{i}": (1.0, 0.0, 2.0) for i in range(9)}), "cap of 8"),
])
def test_envelope_reasons_name_the_branch(overrides, reason):
    spec = {**EXPO, **overrides}
    fn = expo_model
    if "parameters" in overrides:
        def fn(*, ta, p0, p1, p2, p3, p4, p5, p6, p7, p8):  # noqa: E306 - nine branches
            return {"reco": p0 * ta + p1 + p2 + p3 + p4 + p5 + p6 + p7 + p8}
    tm = et.construct_hybrid_model(**spec, mechanistic_model=fn, device="cpu")
    got = fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), et.LoggingLoss())
    assert got is not None and reason in got


def test_a_multinn_model_too_large_for_kernel_2_names_queue_b():
    """Branches within kernel 3's widths but beyond kernel 2's: the wide
    engine, whose envelope takes MultiNN branches, so train() runs kernel 3
    (its plain version on the CPU) behind the gate."""
    tm = et.construct_hybrid_model(**{**EXPO, "hidden_layers": [128, 64]},
                                   mechanistic_model=expo_model, device="cpu")
    engine = fe.fused_engine(tm)
    assert engine.epoch_path == "cuda_fused_wide"
    assert engine.unsupported_reason(tm, ("adam", 0.01), et.LoggingLoss(), None) is None
    r = et.train(tm, expo_columns(200, seed=1), nepochs=1, batchsize=64, use_kernel=True,
                 show_progress=False)
    assert r.epoch_path == "cuda_fused_wide" and "exactness gate passed" in r.engine_reason


@pytest.mark.parametrize("name", ["expo", "globals_only"])
def test_train_takes_kernel_2s_plain_version(name):
    """``train(use_kernel=True)`` on the CPU runs kernel 2's plain version
    behind the gate, one call an epoch, and ends as the torch engine does."""
    spec, _, fn = SPECS[name]
    cols = columns(name, 600, 3)
    kw = dict(nepochs=3, batchsize=128, optimizer=("adamw", 0.01), training_loss="nseLoss",
              loss_types=["nseLoss", "mse"], show_progress=False)
    runs = {}
    for use in (True, False):
        tm = et.construct_hybrid_model(**spec, mechanistic_model=fn, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
        runs[use] = et.train(tm, cols, use_kernel=use, **kw)
    assert runs[True].epoch_path == "cuda_fused_epoch"
    assert "exactness gate passed" in runs[True].engine_reason
    assert runs[False].epoch_path == "torch"
    np.testing.assert_allclose(runs[True].best_loss, runs[False].best_loss, rtol=1e-4)
    for k, v in runs[False].params.items():
        np.testing.assert_allclose(runs[True].params[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4)


def test_source_names_the_branch_loop():
    """The kernel runs each network's forward and backward in a loop of the
    branch count, and reads every network's fields from its EhNet. It is
    built twice: fused_epoch.cu for one network (a compile-time count, the
    parent's code), fused_epoch_multinn.cu for any number, with a launcher
    of its own; a plan of one network launches the first."""
    from easyhybrid_tpu_torch.ops import _build

    src = CU_SOURCE.read_text()
    assert src.count("for (int b = 0; b < ehe_n_nets<MULTI>(a); ++b)") >= 3
    assert "return MULTI ? a.n_nets : 1;" in src
    assert "ehe_row_forward<W, 1, true, BF16>(net, Pm, h, res, ld, 0, PW);" in src
    assert "ehe_row_backward<W, BF16>(net, Pm, res, ld, PW);" in src
    multi = CU_SOURCE.with_name("fused_epoch_multinn.cu").read_text()
    assert "#define EHE_MULTI_NETS" in multi and '#include "fused_epoch.cu"' in multi
    assert _build.LAUNCHERS["fused_epoch_multinn.cu"][0] == "eh_fused_epoch_multinn"
    assert Path(CU_SOURCE).with_name("fused_multisite.cu").read_text().count("EhNet") == 0
    ll = et.LoggingLoss()
    for name, want in (("expo", "fused_epoch_multinn.cu"), ("globals_only", "fused_epoch_multinn.cu")):
        spec, _, fn = SPECS[name]
        plan = fe.plan_fused_epoch(et.construct_hybrid_model(**spec, mechanistic_model=fn,
                                                             device="cpu"), "adam", ll)
        assert fe.kernel_source(plan) == want
    quick = et.construct_hybrid_model(**{**EXPO, "predictors": ["sw_pot", "moisture"],
                                         "neural_param_names": ["rb", "k"]},
                                      mechanistic_model=expo_model, device="cpu")
    assert fe.kernel_source(fe.plan_fused_epoch(quick, "adam", ll)) == "fused_epoch.cu"


@pytest.mark.parametrize("source", ["fused_epoch.cu", "fused_epoch_multinn.cu"])
def test_each_build_exports_the_launcher_the_wrapper_declares(source):
    """The C names each build of kernel 2 exports, from the preprocessor's
    expansion of the source's entry-point macros (g++ -E on the macro block
    and the two ``extern "C"`` lines): the launcher ``_build.LAUNCHERS``
    names and its ``_args_size``, which the wrapper calls."""
    from easyhybrid_tpu_torch.ops import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to run the preprocessor with")
    src = CU_SOURCE.read_text()
    block = src[src.index("#ifdef EHE_MULTI_NETS"):src.index("#define EHE_CAT(a, b)")]
    block += "#define EHE_CAT(a, b) EHE_CAT2(a, b)\n"
    block += "\n".join(line for line in src.splitlines() if line.startswith('extern "C" int'))
    if source == "fused_epoch_multinn.cu":
        block = "#define EHE_MULTI_NETS\n" + block
    out = subprocess.run([gxx, "-E", "-P", "-x", "c++", "-"], input=block, capture_output=True,
                         text=True, check=True).stdout
    names = re.findall(r'extern "C" int (\w+)\(', out)
    entry = _build.LAUNCHERS[source][0]
    assert names == [entry + "_args_size", entry]
