"""Kernel 3 on the JAX kernel's branch view: MultiNN models (one
single-output MLP per neural parameter, each over its own predictor
columns) in the wide fused epoch. Its plain version (``fused_wide_reference``,
what the wrapper computes on CPU tensors), with the plan built directly as
the other kernel-3 tests build it, against the JAX package's fused epoch
kernel in interpret mode (as tests/test_torch_fused_multinn.py holds kernel
2's); its member axis's plain version against the JAX package's population;
``train()`` on a MultiNN model past kernel 2's widths against the torch
engine; the branch layout, the argument struct and its ctypes mirror, the
workspace over branches and members, and the envelope's reasons.

Tolerances, float32, as tests/test_torch_fused_epoch.py: atol 2e-6 after one
epoch and 1e-5 after more, loss rtol 1e-5, every optimizer slot compared.
The bf16 build's case after two epochs of sgd 0.05, as tests/test_torch_bf16.py
holds kernels 2 and 3: the loss rtol 1e-4 and the parameters atol 5e-5 (JAX's
own bf16 test's), on all but 0.5% of their elements, which stay within 2e-4:
where the two packages' float32 sums fall on either side of a bf16 rounding
boundary a weight gradient flips one bf16 ulp (tests/test_fused.py:1376-1381),
and its step carries the flip into the parameter (measured: 9.8e-5 on one
element of 480). The population's as
tests/test_torch_population_wide.py: ``1e-4 * max(1, |ref|)``; ``train()``
against the torch engine as tests/test_torch_fused_multinn.py holds kernel
2's: atol 1e-5 with rtol 1e-4."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
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
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training import population as pop

from test_torch_fused_epoch import assert_model_matches, assert_slots_match, jax_perms
from test_torch_fused_multinn import expo_model
from test_torch_fused_wide import CU_SOURCE
from test_torch_kernel_forms import expo_columns
from test_torch_population import _carry_jax_inits, assert_population_matches

# examples/expo_hybrid.py's model with branches of their own depth: rb over
# sw_pot, k over moisture
HIDDEN = {"rb": [24, 20], "k": [16]}


def _spec(norm="static", hidden=None, **kw):
    spec = dict(
        predictors={"rb": ["sw_pot"], "k": ["moisture"]}, forcing=["ta"], targets=["reco"],
        parameters={"rb": (2.0, 0.0, 8.0), "k": (0.05, 0.0, 0.2)}, global_param_names=[],
        hidden_layers=hidden or HIDDEN, activation="swish", scale_nn_outputs=True,
        input_batchnorm=norm)
    spec.update(kw)
    return spec


def _ll(pkg, loss, l2=False):
    extra = {"extra_loss": pkg.l2_extra_loss(1e-2)} if l2 else {}
    return pkg.LoggingLoss(training_loss=loss, loss_types=(loss,), **extra)


def setup(norm="static", n=512, batch=128, seed=13, bf16=False, **kw):
    """The same model in both packages from the JAX parameters (a static
    norm fitted), the JAX and the port's epoch tensors."""
    spec = _spec(norm, **kw)
    dt = {"compute_dtype": jnp.bfloat16} if bf16 else {}
    jm = eh.construct_hybrid_model(**spec, mechanistic_model=expo_model, **dt)
    tm = et.construct_hybrid_model(**spec, mechanistic_model=expo_model, device="cpu",
                                   **({"compute_dtype": torch.bfloat16} if bf16 else {}))
    data = et.prepare_data(tm, expo_columns(n, seed=seed))
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    jt = jax.device_put(jax_epoch_tensors(
        eh.prepare_data(jm, ((data.x, data.forcing), data.y)), batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


def _run_both(norm, loss, opt, shuffle, epochs, l2=False, bf16=False):
    """The JAX kernel and kernel 3's plain version from the same parameters
    and permutations: ``(tm, jax params, jax state, jax opt state, fn, opt
    state, loss, jax loss)``."""
    jm, params, state, jt, tm, tt = setup(norm, bf16=bf16)
    jll = _ll(eh, loss, l2)
    assert jax_supports(jm, opt, jll)
    key = jax.random.PRNGKey(5)
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)
    fn = fw.make_fused_wide_epoch(tm, opt, _ll(et, loss, l2), shuffle=shuffle,
                                  epochs_per_call=epochs)
    assert len(fn.plan.nets) == 2 and fn.plan.bf16 == bf16 and (fn.plan.l2 is not None) == l2
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, got_loss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                          perms=jax_perms(shuffle, key, epochs, nb, batch))
    assert not torch.equal(fn.plan.pack(tm).params, p0.params)
    assert int(os_["t"][0]) == int(jos["t"][0]) == epochs * nb
    return tm, jp, js, jos, fn, os_, got_loss, jloss


CASES = [
    # norm, loss, optimizer, shuffle, epochs, weight-L2 penalty
    ("static", "mse", ("sgd", 0.05), True, 1, False),
    (False, "nseLoss", ("adamw", 0.01), True, 2, False),
    (True, "rmse", ("adamw", 0.01), "batches", 1, False),
    ("static", "kgeLoss", ("lamb", 0.01), True, 1, False),
    (True, "mse", ("lamb", 0.01), False, 2, False),
    (False, "kgeLoss", ("sgd", 0.05, 0.9), True, 2, False),
    ("static", "mse", ("adamw", 0.01), True, 1, True),
    (True, "nseLoss", ("sgd", 0.05), True, 2, True),
]


@pytest.mark.parametrize("norm,loss,opt,shuffle,epochs,l2", CASES, ids=str)
def test_reference_matches_the_jax_fused_epoch(norm, loss, opt, shuffle, epochs, l2):
    """Parameters, running statistics, every slot, step count and loss after
    one or two epochs with the JAX permutations injected."""
    tm, jp, js, jos, fn, os_, got_loss, jloss = _run_both(norm, loss, opt, shuffle, epochs, l2)
    atol = 2e-6 if epochs == 1 else 1e-5
    assert_model_matches(tm, jp, js, atol)
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert_slots_match(fn.plan, tm, os_, jos, atol)


@pytest.mark.parametrize("norm", ["static", True], ids=str)
def test_bf16_reference_matches_the_jax_bf16_epoch(norm):
    tm, jp, _, _, _, _, got_loss, jloss = _run_both(norm, "mse", ("sgd", 0.05), True, 2,
                                                    bf16=True)
    got, _ = et.export_jax_params(tm)
    diff = np.concatenate([np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
                           for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp))])
    assert diff.max() <= 2e-4 and np.mean(diff > 5e-5) <= 5e-3, (diff.max(), np.sum(diff > 5e-5))
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-4)


# ---------------------------------------------------------------------------
# the member axis and train()
# ---------------------------------------------------------------------------

WIDE = {"rb": [72], "k": [16]}  # a branch wider than kernel 2's 64: kernel 3's model


def test_member_axis_plain_version_matches_the_jax_population(monkeypatch):
    """A learning-rate sweep of a MultiNN model past kernel 2's widths on
    kernel 3's member axis (its plain version) against the JAX package's
    XLA population, unshuffled."""
    spec = _spec(hidden=WIDE)
    jm = eh.construct_hybrid_model(**spec, mechanistic_model=expo_model)
    tm = et.construct_hybrid_model(**spec, mechanistic_model=expo_model, device="cpu")
    _carry_jax_inits(monkeypatch, jm)
    cols = expo_columns(300, seed=5)
    kw = dict(hyper={"learning_rate": [0.01, 0.003, 0.01]}, nepochs=4, batchsize=64,
              eval_every=2, seed=3, data_seed=0, shuffle_each_epoch=False,
              training_loss="nseLoss", loss_types=["nseLoss", "mse"])
    want = eh.population_train(jm, pd.DataFrame(cols), **kw)
    got = et.population_train(tm, cols, **kw, use_kernel=True)
    assert want.epoch_path == "population_vmap"
    assert got.epoch_path == "population_vmap_fused", got.engine_reason
    assert fe.fused_engine(tm).epoch_path == "cuda_fused_wide"
    assert_population_matches(tm, got, want)
    assert all(torch.equal(v[0], v[2]) for v in got.params.values())


@pytest.mark.parametrize("norm", ["static", True], ids=str)
def test_members_equal_their_calls_alone(norm):
    """Each member of a MultiNN member call equals its call alone bit for
    bit (its own spec, permutation and running statistics), and the member
    self-check passes."""
    _, _, _, _, tm, tt = setup(norm, hidden=WIDE, n=400)
    fn = fw.make_fused_wide_epoch(tm, ("adam", 0.01), _ll(et, "kgeLoss"), shuffle=True,
                                  epochs_per_call=2)
    k = 3
    packed = fn.plan.pack(tm)
    packed = fe.FusedParams(packed.params.expand(k, -1).clone(), packed.bn.expand(k, -1).clone())
    packed.params[1] += 0.01
    opt = pop._stacked_opt_state(packed, ("adam", 0.01), k)
    data = fn.member_data(tt)
    rows = fn.member_rows(data, k, per_member_data=False,
                          generator=torch.Generator().manual_seed(1), shared_perms=False)
    specs = [("adam", {"learning_rate": lr}) for lr in (0.003, 0.03, 0.01)]
    got = fn.members(packed, opt, data, rows, specs=specs)
    for i in range(k):
        p, o, loss = fn.alone(fe.FusedParams(packed.params[i], packed.bn[i]),
                              {n: v[i] for n, v in opt.items()}, data, rows[i], specs[i])
        assert torch.equal(p.params, got[0].params[i]) and torch.equal(p.bn, got[0].bn[i])
        assert all(torch.equal(o[n], got[1][n][i]) for n in o)
        assert torch.equal(loss[0], got[2][i])
    assert not torch.equal(got[0].params[0], got[0].params[2])
    assert pop.member_selfcheck(fn, packed, opt, tt, specs=specs, per_member_data=False,
                                shared_perms=False) is None


def test_train_takes_kernel_3s_plain_version():
    """``train(use_kernel=True)`` on a MultiNN model past kernel 2's widths
    runs kernel 3's plain version on the CPU behind the gate, one call an
    epoch, and ends as the torch engine does."""
    cols = expo_columns(600, seed=3)
    kw = dict(nepochs=3, batchsize=128, optimizer=("adamw", 0.01), training_loss="nseLoss",
              loss_types=["nseLoss", "mse"], show_progress=False)
    runs = {}
    for use in (True, False):
        tm = et.construct_hybrid_model(**_spec(hidden=WIDE), mechanistic_model=expo_model,
                                       device="cpu", generator=torch.Generator().manual_seed(0))
        runs[use] = et.train(tm, cols, use_kernel=use, **kw)
    assert runs[True].epoch_path == "cuda_fused_wide"
    assert "exactness gate passed" in runs[True].engine_reason
    assert runs[False].epoch_path == "torch"
    np.testing.assert_allclose(runs[True].best_loss, runs[False].best_loss, rtol=1e-4)
    for k, v in runs[False].params.items():
        np.testing.assert_allclose(runs[True].params[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# layout, arguments, workspace, envelope
# ---------------------------------------------------------------------------

def test_branch_layout_and_the_argument_struct():
    """Kernel 2's packed layout (norm scales of every column, their biases,
    each branch's layers, the globals); every branch's layers in one list
    with its branch, its widths at ``dims[net_first + b]``, its columns and
    outputs; one network's struct as before the branches."""
    tm = et.construct_hybrid_model(**_spec(True), mechanistic_model=expo_model, device="cpu")
    plan = fw.plan_fused_wide(tm, ("lamb", 0.01), _ll(et, "mse"))
    ref = fe.plan_fused_epoch(tm, ("lamb", 0.01), _ll(et, "mse"))
    assert plan.segments == ref.segments and plan.n_params == ref.n_params
    assert plan.branch_layout == ref.branch_layout and plan.n_features == 2
    assert fe.optimizer_struct(plan).n_leaves == fe.optimizer_struct(ref).n_leaves == 4 + 10
    a = fw._Args.from_buffer_copy(plan.args_bytes)
    assert (a.n_nets, a.n_layers, a.n_features, a.n_neural) == (2, 5, 2, 2)
    assert list(a.layer_net[:5]) == [0, 0, 0, 1, 1]
    assert (list(a.net_first[:2]), list(a.net_layers[:2])) == ([0, 3], [3, 2])
    assert (list(a.net_col[:2]), list(a.net_out[:2])) == ([0, 1], [0, 1])
    assert list(a.dims[:7]) == [1, 24, 20, 1, 1, 16, 1]
    lay = plan.branch_layout
    assert list(a.p_off_w[:5]) == list(lay.nets[0].p_w) + list(lay.nets[1].p_w)
    assert list(a.p_off_b[:5]) == list(lay.nets[0].p_b) + list(lay.nets[1].p_b)
    assert list(a.acts[:5]) == [ff._ACT_IDS["swish"]] * 2 + [0] + [ff._ACT_IDS["swish"], 0]
    assert a.p_off_g == plan.n_params
    packed = plan.pack(tm)
    assert packed.bn.numel() == 4
    twin = et.construct_hybrid_model(**_spec(True), mechanistic_model=expo_model, device="cpu")
    plan.unpack(packed, twin)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    # one network: the widths, offsets and flat fields of the parent's struct
    single = et.construct_hybrid_model(
        predictors=["sw_pot", "moisture"], forcing=["ta"], targets=["reco"],
        parameters={"rb": (2.0, 0.0, 8.0), "k": (0.05, 0.0, 0.2)}, neural_param_names=["rb", "k"],
        global_param_names=[], hidden_layers=[72, 16], activation="swish",
        mechanistic_model=expo_model, device="cpu")
    one = fw._Args.from_buffer_copy(fw.plan_fused_wide(single, "adam", _ll(et, "mse")).args_bytes)
    assert (one.n_nets, one.n_layers, one.n_features, one.n_neural) == (1, 3, 2, 2)
    assert list(one.dims[:4]) == [2, 72, 16, 2] and list(one.layer_net[:3]) == [0, 0, 0]


def test_kernel_source_and_ctypes_mirror_agree_on_the_branches():
    src = CU_SOURCE.read_text()
    defines = dict(re.findall(r"#define (EHW?_\w+) (\d+)", src))
    assert int(defines["EHW_MAX_LAYERS"]) == fw.MAX_WIDE_LAYERS == fe.MAX_LEAVES // 2
    body = re.search(r"struct EhFusedWideArgs \{(.*?)\};", src, re.S).group(1)
    decls = dict((name, arr) for _, name, arr in
                 re.findall(r"([\w ]+?\*?) ?(\w+)(\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body)))
    sizes = {"EHW_MAX_LAYERS": fw.MAX_WIDE_LAYERS, "EH_MAX_NETS": fe.MAX_NETS}
    fields = dict(fw._Args._fields_)
    for name in ("layer_net", "net_first", "net_layers", "net_col", "net_out", "dims", "tc",
                 "ws_off_a", "part_off", "wgt_bn"):
        n = eval(decls[name][1:-1], {}, sizes)  # noqa: S307 - the source's own constants
        assert fields[name]._length_ == n, name
    assert ctypes.sizeof(fw._Args) < 4096  # a kernel's parameters within the classic limit
    # the branch walk: the forward over the list, the backward a branch at a time
    assert "for (int b = 0; b < a.n_nets; ++b) {  // each branch from its last layer" in src
    assert "p.lda = first ? F : din;" in src and "p.ldo = first ? F : din;" in src


@pytest.mark.parametrize("hidden,norm,targets,members", [
    ({"rb": [24, 20], "k": [16]}, "static", 1, 1),
    ({"rb": [72], "k": [130, 40]}, True, 1, 3),
    ({"rb": [16], "k": [16]}, False, 2, 2),
], ids=str)
def test_the_workspace_counts_every_branch_and_member(hidden, norm, targets, members):
    """The layout over branches: the input's columns of every branch, each
    layer's activations and copies, each layer's partial tiles; one
    network's is kernel 3's before the branches. The envelope checks
    ``members`` of it against the card's share."""
    nets = tuple((1,) + tuple(h) + (1,) for h in hidden.values())
    batch, f, has_norm = 96, len(nets), norm is not False
    lay = fw.wide_layout(nets, has_norm, batch, norm is True, targets, False)
    geo = [g for dims in nets for g in fw.wide_geometry(dims, batch)]
    pairs = fw.layer_dims(nets)
    assert lay.geometry == tuple(geo) and len(lay.ws_a) == len(lay.part_off) == len(pairs)
    ws = batch * f * (3 if has_norm else 1) + sum(2 * batch * dout for _, dout in pairs)
    ws += sum(batch * (din + dout) + din * dout for (din, dout), g in zip(pairs, geo)
              if g.route == fw.TENSOR_CORES)
    assert lay.ws_floats == ws + (2 * f if norm is True else 0)
    parts = sum(g.weight.splits * dout * (din + 1) for (din, dout), g in zip(pairs, geo))
    assert lay.part_floats == parts + (lay.norm_splits * 2 * f if has_norm else 0)
    for dims in nets:  # one network: a tuple of widths or a tuple of one
        assert fw.wide_layout((dims,), False, batch) == fw.wide_layout(dims, False, batch)
    spec = _spec(norm, hidden=hidden)
    if targets == 2:
        spec.update(targets=["reco", "reco2"])
    tm = et.construct_hybrid_model(**spec, device="cpu", mechanistic_model=(
        expo_model if targets == 1 else
        lambda *, ta, rb, k: {"reco": rb * np.e ** (k * ta), "reco2": rb + k}))
    cols = expo_columns(300, seed=2)
    cols["reco2"] = cols["reco"]
    tt = tepoch.epoch_tensors_to(et.build_epoch_tensors(et.prepare_data(tm, cols), batch), "cpu")
    ll = _ll(et, "mse")
    need = members * lay.nbytes
    memory = int(need / fw.WORKSPACE_SHARE) + 1
    assert fw.fused_wide_unsupported_reason(tm, "adam", ll, tt, memory_bytes=memory,
                                            members=members) is None
    got = fw.fused_wide_unsupported_reason(tm, "adam", ll, tt, memory_bytes=memory - 8,
                                           members=members)
    assert got is not None and f"take {need} bytes" in got


def _nine(*, ta, p0, p1, p2, p3, p4, p5, p6, p7, p8):
    return {"reco": p0 * ta + p1 + p2 + p3 + p4 + p5 + p6 + p7 + p8}


def _branches(n, hidden):
    return dict(predictors={f"p{i}": ["sw_pot"] for i in range(n)},
                parameters={f"p{i}": (1.0, 0.0, 2.0) for i in range(n)},
                neural_param_names=[f"p{i}" for i in range(n)], hidden_layers=hidden)


@pytest.mark.parametrize("overrides,reason", [
    (dict(hidden_layers={"rb": [8], "k": [fw.MAX_WIDE_WIDTH + 1]}), "branch 'k': layer widths"),
    (dict(hidden_layers={"rb": [8], "k": [8] * 8}), "branch 'k': 9 layers exceed"),
    (dict(activation={"rb": "tanh", "k": torch.tanh}), "branch 'k': activation"),
    (dict(hidden_layers={"lstm": 8}), "branch 'rb': the network is a LSTMNet"),
    (dict(_branches(9, [8]), mechanistic_model=_nine), "9 MultiNN branches exceed"),
    (dict(_branches(7, [8, 8, 8]), mechanistic_model=lambda *, ta, p0, p1, p2, p3, p4, p5, p6:
          {"reco": p0 * ta + p1 + p2 + p3 + p4 + p5 + p6}), "70 parameter leaves exceed"),
])
def test_envelope_reasons_name_the_branch(overrides, reason):
    spec = {**_spec(), "mechanistic_model": expo_model, **overrides}
    tm = et.construct_hybrid_model(**spec, device="cpu")
    got = fw.fused_wide_unsupported_reason(tm, ("adam", 0.01), _ll(et, "mse"))
    assert got is not None and reason in got, got


def test_expo_hybrid_past_kernel_2_takes_kernel_3():
    """examples/expo_hybrid.py's model with hidden_layers=[128, 128] and with
    the GPU tutorial's tower: the wide engine, inside its envelope."""
    for hidden in ([128, 128], [1024, 512, 256, 128, 64]):
        tm = et.construct_hybrid_model(**_spec(hidden=hidden), mechanistic_model=expo_model,
                                       device="cpu")
        assert fe.fused_engine(tm).epoch_path == "cuda_fused_wide"
        ll = _ll(et, "nseLoss")
        assert fw.fused_wide_unsupported_reason(tm, ("adamw", 0.01), ll) is None
        plan = fw.plan_fused_wide(tm, ("adamw", 0.01), ll)
        assert [dims for _, dims, _ in plan.nets] == [(1, *hidden, 1)] * 2
