"""Kernel 5's plain version (``fused_multisite_reference``, what the wrapper
computes on CPU tensors) against the JAX package's multi-site kernel in
interpret mode and against the port's torch epoch; the envelope and its
reasons; the site index and the loss scales; ``train()`` behind the gate;
the ctypes mirror of the CUDA argument struct; and the plain versions of
the multi-site primitives.

Tolerances, float32, after 3 epochs: atol 5e-5 / rtol 5e-4 on parameters and
rtol 2e-4 on the loss against the JAX kernel (what tests/test_fused_multisite.py
allows between that kernel and the XLA epoch); atol 1e-5 against the port's
own torch epoch, which sums in the same order up to the batch reductions."""

import copy
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
from easyhybrid_tpu.data.prepare import HybridData as JaxHybridData
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_multisite import make_fused_multisite_epoch as jax_fused_multisite
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu_torch.config.train_config import TrainConfig
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.ops import fused_multisite as fm
from easyhybrid_tpu_torch.ops import multisite_primitives as mp
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from test_torch_fused_epoch import RULES, assert_slots_match, assert_torch_slots_match
from easyhybrid_tpu_torch.training.train import _select_engine

CU_SOURCE = Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_multisite.cu"


def _rbq10(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def _rbq10_branching(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 if ta > tref else rb}  # control flow: the tracer refuses it


def spec(hidden=(8, 8), norm=False, act="swish", **kw):
    out = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
    )
    out.update(kw)
    return out


def torch_model(S, **kw):
    base = et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu", **spec(**kw))
    return et.MultiSiteHybridModel(base, S, device="cpu")


def setup(S=200, N=10, batch=None, nan_frac=0.1, data=None, **kw):
    """JAX model, parameters, state and tensors; the port's model with the
    same parameters and its tensors."""
    jm = eh.MultiSiteHybridModel(eh.construct_hybrid_model(mechanistic_model=_rbq10, **spec(**kw)),
                                 n_sites=S, share_nn=True)
    params, state = jm.init(jax.random.PRNGKey(3))
    tm = torch_model(S, **kw)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    if data is None:
        data = et.gen_multisite_arrays(S, N, seed=0, nan_frac=nan_frac, site_idx=batch is not None)
    jdata = JaxHybridData(x=data.x, forcing=dict(data.forcing), y=dict(data.y))
    jt = jax.tree.map(jnp.asarray, jax_epoch_tensors(jdata, batch or S))
    tt = tepoch.epoch_tensors_to(et.build_epoch_tensors(data, batch or S), "cpu")
    return jm, params, state, jt, tm, tt


def jax_perms(shuffle, key, epochs, nb, batch):
    """The site permutations the JAX kernel and the JAX epoch draw for ``key``."""
    if not shuffle or nb == 1:
        return None
    n = nb * batch if shuffle is True else nb
    keys = [key] if epochs == 1 else list(jax.random.split(key, epochs))
    return np.stack([np.asarray(jax_permutation(k, n)) for k in keys])


def logging_pair(loss, agg):
    return (eh.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg),
            et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg))


def masked_second_batch():
    data = et.gen_multisite_arrays(256, 8, seed=0, site_idx=True)
    data.y["reco"][128:] = np.nan  # every target of the second site batch
    return dict(S=256, N=8, batch=128, data=data)


# two per-site globals (rb, Q10; the network gives tref): at one observation a
# site a tile holds more of its sites' globals than it has rows
TWO_GLOBALS = dict(parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0),
                               "tref": (15.0, 10.0, 20.0)},
                   neural_param_names=["tref"], global_param_names=["rb", "Q10"])

CASES = [
    # setup kwargs, optimizer, loss, agg, shuffle
    (dict(), ("adam", 0.01), "mse", "sum", False),
    (dict(), ("sgd", 0.05), "mae", "mean", False),
    (dict(), ("adam", 0.01), "nseLoss", "sum", False),
    (dict(S=150, N=7), ("adam", 0.01), "mse", "sum", False),
    (dict(S=300, N=8, batch=128), ("adam", 0.01), "mse", "mean", False),
    (dict(S=300, N=8, batch=128), ("adam", 0.01), "mse", "sum", True),
    (dict(S=300, N=8, batch=128), ("adam", 0.01), "mae", "sum", "batches"),
    (dict(S=256, N=8, batch=128), ("sgd", 0.05), "nseLoss", "sum", True),
    ("masked", ("adam", 0.01), "mse", "sum", False),
    (dict(S=20, N=1, **TWO_GLOBALS), ("adam", 0.01), "mse", "sum", False),
    (dict(S=40, N=1, batch=10, **TWO_GLOBALS), ("adam", 0.01), "mse", "sum", True),
]
# one case per optimizer rule besides adam and plain sgd, one site batch or
# three minibatches in turn (9 steps: radam rectifies from step 6; lamb's
# per-site leaves then hold sites outside the batch)
RULE_CASES = [(dict() if i % 2 == 0 and opt[0] != "radam" else dict(S=300, N=8, batch=128),
               opt, "mse", "sum", i % 2 == 1) for i, opt in enumerate(RULES)]


@pytest.mark.parametrize("kw,opt,loss,agg,shuffle", CASES + RULE_CASES, ids=str)
def test_reference_matches_the_jax_kernel_in_interpret_mode(kw, opt, loss, agg, shuffle):
    epochs = 3
    masked = kw == "masked"
    jm, params, state, jt, tm, tt = setup(**(masked_second_batch() if masked else kw))
    jll, tll = logging_pair(loss, agg)
    key = jax.random.PRNGKey(7)
    jfn = jax_fused_multisite(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs,
                              interpret=True)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.copy, params), jax_init_opt(params, opt), state, jt,
                            key)

    assert et.supports_fused_multisite(tm, opt, tll, tt, shuffle=shuffle)
    fn = et.make_fused_multisite_epoch(tm, opt, tll, shuffle=shuffle, epochs_per_call=epochs)
    nb, sb = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                       perms=jax_perms(shuffle, key, epochs, nb, sb))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-4)
    assert int(os_["t"][0]) == int(jos["t"][0]) == epochs * (1 if masked else nb)
    assert_slots_match(fn.plan, tm, os_, jos, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("kw,opt,loss,agg,shuffle", CASES + RULE_CASES, ids=str)
def test_reference_matches_the_torch_epoch(kw, opt, loss, agg, shuffle):
    epochs = 3
    masked = kw == "masked"
    *_, tm, tt = setup(norm="static", **(masked_second_batch() if masked else kw))
    tm.nn.norm.mean.copy_(torch.tensor([0.4, 0.6]))
    tm.nn.norm.var.copy_(torch.tensor([0.09, 0.07]))
    twin = copy.deepcopy(tm)
    _, tll = logging_pair(loss, agg)
    perms = tepoch.perms_for_epochs(shuffle, tt, epochs, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_multisite_epoch(tm, opt, tll, shuffle=shuffle, epochs_per_call=epochs)
    p0 = fn.plan.pack(tm)
    packed, os_, loss_f = fn(p0, fe.init_fused_opt_state(p0, opt), tt, perms=perms)
    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, tll, optim, shuffle=shuffle, epochs_per_call=epochs)
    state, loss_t = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss_f), float(loss_t), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])
    assert torch.equal(packed.bn, p0.bn)  # static statistics are not trained
    assert_torch_slots_match(fn.plan, opt, os_, state, atol=1e-5, rtol=1e-4)


def test_sites_outside_the_data_still_take_every_adam_step():
    """The gate's slice holds 2 of 3 site batches: the third batch's sites see
    a zero gradient in every step, on both sides."""
    *_, tm, tt = setup(S=300, N=6, batch=100)
    for p in tm.globals.parameters():
        p.data += torch.linspace(-0.5, 0.5, 300)[:, None]
    sub = fe._head(tt, 2)
    tll = et.LoggingLoss()
    fn = et.make_fused_multisite_epoch(tm, ("adam", 0.01), tll, shuffle=False, epochs_per_call=2)
    p0 = fn.plan.pack(tm)
    m0 = fe.init_fused_opt_state(p0)
    m0["m"] += 0.01  # moments that a zero-gradient step decays and applies
    packed, os_, _ = fn(p0, m0, sub)
    tail = slice(fn.plan.n_params - 100, fn.plan.n_params)
    assert not torch.equal(packed.params[tail], p0.params[tail])
    np.testing.assert_allclose(os_["m"][tail].numpy(), 0.01 * 0.9 ** 4, rtol=1e-6)
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), tll, tt, epochs_per_call=2)
    assert ok and worst < 1e-4


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

def test_envelope_verdicts_follow_the_jax_package():
    """The verdicts of test_multisite_supports_envelope and
    test_multisite_minibatch_envelope, for what this kernel holds so far."""
    tm = torch_model(64)
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    adam = ("adam", 0.01)
    one = tepoch.epoch_tensors_to(et.build_epoch_tensors(
        et.gen_multisite_arrays(64, 4, site_idx=False), 64), "cpu")
    small = tepoch.epoch_tensors_to(et.build_epoch_tensors(
        et.gen_multisite_arrays(64, 4, site_idx=True), 32), "cpu")
    assert et.supports_fused_multisite(tm, adam, ll, one)
    assert et.supports_fused_multisite(tm, adam, ll, one, shuffle=True)  # one batch: any mode
    assert et.supports_fused_multisite(tm, adam, ll, small)
    assert et.supports_fused_multisite(tm, adam, ll, small, shuffle=True)
    assert et.supports_fused_multisite(tm, adam, ll, small, shuffle="batches")
    assert not et.supports_fused_multisite(tm, adam, ll, small, shuffle="per_shard")
    for loss in ("nseLoss", "mae"):
        assert et.supports_fused_multisite(tm, adam, et.LoggingLoss(training_loss=loss), one)
    assert not et.supports_fused_multisite(tm, adam, et.LoggingLoss(training_loss="pearsonLoss"), one)
    assert not et.supports_fused_multisite(tm.base, adam, ll, one)  # kernel 2's job
    assert not et.supports_fused_multisite(tm, "lbfgs", ll, one)
    # a site order other than the identity: refused
    flipped = small._replace(forcing={**small.forcing,
                                      "_site_idx": small.forcing["_site_idx"].flip(0, 1)})
    assert not et.supports_fused_multisite(tm, adam, ll, flipped)
    assert "identity" in fm.fused_multisite_unsupported_reason(tm, adam, ll, flipped)


@pytest.mark.parametrize("overrides,optimizer,logging,reason", [
    ({}, "noisy_sgd", et.LoggingLoss(), "noisy_sgd"),
    ({}, ("radam", {"learning_rate": 0.01, "threshold": 3.0}), et.LoggingLoss(),
     "threshold 3.0 < 4"),
    # rmse (one target) and a traced elementwise loss are the kernel's since
    # they came to kernel 5; a statistic loss and an untraceable elementwise
    # loss are not
    ({}, "adam", et.LoggingLoss(training_loss="kgeLoss"), "mse, mae, nseLoss, rmse"),
    ({}, "adam", et.LoggingLoss(training_loss=et.ElementwiseLoss(
        lambda yh, y: torch.sin(yh - y), name="sine")), "training loss 'sine' has no kernel form"),
    ({}, "adam", et.LoggingLoss(extra_loss=et.l2_extra_loss()), "extra_loss"),
    ({}, "adam", et.LoggingLoss(agg=lambda xs: xs[0]), "agg"),
    ({"norm": True}, "adam", et.LoggingLoss(), "trainable input BatchNorm"),
    ({"hidden": (65,)}, "adam", et.LoggingLoss(), "cap of 64"),
    ({"branching": True}, "adam", et.LoggingLoss(), "kernel form"),
    ({"hidden": (64,) * 8}, "adam", et.LoggingLoss(), "9 layers exceed"),
], ids=lambda v: v if isinstance(v, str) else "")  # the reason names the case in every worker
def test_envelope_reasons(overrides, optimizer, logging, reason):
    overrides = dict(overrides)
    mech = _rbq10_branching if overrides.pop("branching", False) else et.rbq10
    base = et.construct_hybrid_model(mechanistic_model=mech, device="cpu", **spec(**overrides))
    tm = et.MultiSiteHybridModel(base, 16, device="cpu")
    got = fm.fused_multisite_unsupported_reason(tm, optimizer, logging)
    assert got is not None and reason in got
    assert not et.supports_fused_multisite(tm, optimizer, logging)
    with pytest.raises(ValueError, match="not supported by the fused multisite kernel"):
        et.make_fused_multisite_epoch(tm, optimizer, logging)


def test_engine_reason_names_the_shuffle_flag_in_the_jax_wording():
    *_, tm, tt = setup(S=64, N=4, batch=32)
    cfg = TrainConfig(shuffle_each_epoch="per_shard", use_kernel=True)
    fused, reason = _select_engine(tm, cfg, et.LoggingLoss(), tt, 1)
    assert not fused
    assert reason == ("minibatched multisite with shuffle_each_epoch='per_shard': the fused "
                      "multisite kernel supports shuffle_each_epoch in (True, False, 'batches')")
    cfg = TrainConfig(optimizer=("radam", {"learning_rate": 0.01, "threshold": 3.0}),
                      use_kernel=True)
    fused, reason = _select_engine(tm, cfg, et.LoggingLoss(), tt, 1)
    assert not fused and "(supports_fused_multisite): radam with threshold 3.0 < 4" in reason
    fused, reason = _select_engine(tm, TrainConfig(), et.LoggingLoss(), tt, 1)
    assert not fused and "not cuda" in reason


# --------------------------------------------------------------------------
# site index, loss scales, primitives
# --------------------------------------------------------------------------

def test_site_index_marks_padding_and_follows_the_permutations():
    *_, tm, tt = setup(S=10, N=3, batch=4)  # 3 batches, 2 padding slots
    fn = et.make_fused_multisite_epoch(tm, "adam", et.LoggingLoss(), shuffle=True, epochs_per_call=2)
    data = fm.multisite_data(fn.plan, tt)
    assert data.x.shape == (12, 3, 2) and data.live.tolist() == [True] * 10 + [False] * 2
    ident = fm.site_index(False, None, data, 2)
    assert ident.dtype == torch.int32 and ident.shape == (2, 3, 4)
    assert ident[1].reshape(-1).tolist() == list(range(10)) + [-1, -1]
    perm = torch.stack([torch.arange(11, -1, -1), torch.arange(12)])
    assert fm.site_index(True, perm, data, 2)[0].reshape(-1).tolist() == [-1, -1] + list(range(9, -1, -1))
    by_batch = fm.site_index("batches", torch.tensor([[2, 0, 1], [0, 1, 2]]), data, 2)
    assert by_batch[0].tolist() == [[8, 9, -1, -1], [0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("loss", ["mse", "mae", "nseLoss"])
def test_batch_scales_equal_the_loss_modules_normalisation(loss):
    from easyhybrid_tpu_torch.losses.metrics import loss_fn

    *_, tm, tt = setup(S=10, N=5, batch=4, nan_frac=0.3)
    tt.mask["reco"][1] = 0.0  # the second batch: no valid target
    ll = et.LoggingLoss(training_loss=loss, agg="mean")
    fn = et.make_fused_multisite_epoch(tm, "adam", ll, shuffle=False)
    data, index, scale, valid = fn.inputs(tt)
    assert scale.shape == (1, 3, 1) and valid.tolist() == [[1.0, 0.0, 1.0]]
    for b in (0, 2):
        y, m = tt.y["reco"][b], tt.mask["reco"][b]
        pred = y + 0.5  # any prediction: scale * sum(term) must be the loss
        term = (0.5 * m).abs().sum() if loss == "mae" else (0.25 * m).sum()
        np.testing.assert_allclose(float(scale[0, b, 0] * term), float(loss_fn(pred, y, m, loss)),
                                   rtol=1e-6)


def test_primitives_plain_versions():
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0])
    idx = torch.tensor([2, -1, 0], dtype=torch.int32)
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    assert mp.site_gather(vals, idx, 2).tolist() == [[3.0, 3.0], [0.0, 0.0], [1.0, 1.0]]
    assert mp.site_reduce(x).tolist() == [3.0, 7.0, 11.0]
    v = vals.clone()
    mp.site_update(v, idx, torch.tensor([9.0, 8.0, 7.0]))
    assert v.tolist() == [7.0, 2.0, 9.0, 4.0]
    acc = torch.ones(4)
    mp.site_chain(vals, idx, x, acc)
    assert acc.tolist() == [12.0, 1.0, 10.0, 1.0]
    assert mp.block_sum(x).tolist() == [9.0, 12.0]
    assert mp.launch_primitive.launches == 0  # CPU tensors launch nothing


# --------------------------------------------------------------------------
# train(), the gate, the argument struct
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batchsize,shuffle", [(8, False), (3, True)])
def test_train_on_a_cpu_model_takes_the_plain_version_behind_the_gate(batchsize, shuffle):
    table = {k: [] for k in ("site", "sw_pot", "dsw_pot", "ta", "reco")}
    for s in range(8):
        cols = et.rbq10_columns(50, seed=4 + s)
        table["site"].append(np.full(50, s))
        for k in ("sw_pot", "dsw_pot", "ta", "reco"):
            table[k].append(cols[k])
    table = {k: np.concatenate(v) for k, v in table.items()}
    tm = torch_model(8, norm="static")
    data = et.prepare_multisite_data(tm.base, table, "site")
    res = et.train(tm, data, nepochs=4, eval_every=2, batchsize=batchsize, split_data_at=0.75,
                   shuffle_each_epoch=shuffle, show_progress=False, use_kernel=True)
    assert res.epoch_path == "cuda_fused_multisite"
    assert "exactness gate passed" in res.engine_reason and np.isfinite(res.best_loss)
    assert res.params["globals.Q10"].shape == (8, 1) and int(res.opt_state["t"][0]) == 4 * (
        1 if batchsize == 8 else 2)
    assert res.val_pred_columns["reco_pred"].shape == (2 * 50,)
    assert fm.launch_fused_multisite.launches == 0
    off = et.train(torch_model(8), data, nepochs=1, show_progress=False, use_kernel=False)
    assert off.epoch_path == "torch" and "use_kernel disabled" in off.engine_reason


def test_gate_fails_on_a_corrupted_site_gradient(monkeypatch):
    *_, tm, tt = setup(S=64, N=6)
    real = fm.multisite_reference_grads

    def corrupted(plan, *args):
        g, loss = real(plan, *args)
        g = g.clone()
        g[plan.offsets()["p_g"]:] *= 1.5  # the per-site leaf only
        return g, loss

    monkeypatch.setattr(fm, "multisite_reference_grads", corrupted)
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), et.LoggingLoss(), tt)
    assert not ok and worst > 0.03  # the gate's tolerance, under its per-leaf normalisation


def test_kernel_source_and_ctypes_mirror_agree():
    src = CU_SOURCE.read_text()
    assert '#include "eh_device.cuh"' in src
    body = re.search(r"struct EhFusedMultisiteArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body))
    assert fields == [name for name, _ in fm._Args._fields_]
    header = CU_SOURCE.with_name("eh_device.cuh").read_text()
    defines = dict(re.findall(r"#define (EH_MAX_\w+) (\d+)", header))
    assert int(defines["EH_MAX_TARGETS"]) == fe.MAX_TARGETS
    assert int(defines["EH_MAX_FORCING"]) == ff.MAX_FORCING
    assert "atomicAdd" not in re.sub(r"//[^\n]*", "", src)  # sums keep a fixed order
    assert ctypes.sizeof(fm._Args) % 8 == 0


def test_kernel_arguments_pack_the_plan():
    tm = torch_model(1000, hidden=(16, 16), norm="static")
    plan = fm.plan_fused_multisite(tm, ("adam", 0.01), et.LoggingLoss(training_loss="mae", agg="mean"))
    shared = 2 * 2 + 16 * 3 + 16 * 17 + 17
    assert plan.n_sites == 1000 and plan.n_params == shared + 1000 and plan.loss == "mae"
    a = fm._Args.from_buffer_copy(fm._static_args(plan))
    assert a.n_shared == shared and a.n_sites == 1000 and a.n_globals == 1 and a.loss_kind == 1
    assert list(a.dims[:4]) == [2, 16, 16, 1] and a.norm_mode == 1 and a.optimizer.rule == 1
    assert a.optimizer.one_minus_b2 == np.float32(1.0 - 0.999) and plan.tile_rows == 128
    # kernel 2's tile row: the residuals, the outputs, their scaling's derivative, ones
    assert a.r_off_g + 1 == plan.res_floats == a.r_off_out and a.r_off_one == a.r_off_dsc + 1
    assert a.res_floats == plan.tile_floats == plan.res_floats + 3 and a.p_off_g == shared
    assert list(a.pp_off_w[:3]) == [4, 4 + 16 * 4 + 16, 4 + 16 * 4 + 16 + 16 * 17]
    assert a.n_padded % 4 == 0 and a.n_padded >= a.pp_off_b[2] + 1 and a.n_forcing == 1
    packed = plan.pack(tm)
    assert packed.params.numel() == plan.n_params and packed.bn.numel() == 4
    leaves = plan.leaves(packed.params)
    assert leaves["globals.Q10"].shape == (1000,) and list(leaves)[-1] == "globals.Q10"
    twin = torch_model(1000, hidden=(16, 16), norm="static")
    plan.unpack(packed, twin)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k])


# --------------------------------------------------------------------------
# the gradient kernel's geometry
# --------------------------------------------------------------------------

def _plan(hidden=(16, 16), norm="static", S=10_000, **kw):
    return fm.plan_fused_multisite(torch_model(S, hidden=hidden, norm=norm, **kw), ("adam", 0.01),
                                   et.LoggingLoss())


@pytest.mark.parametrize("batch,n_obs,target,want", [
    # threads, tile_sites, site_tiles, sites_per_block, blocks
    (8000, 64, None, (256, 4, 1, 32, 250)),    # the main path: one wave of 8-tile blocks
    (10_000, 64, None, (256, 4, 1, 40, 250)),
    (2560, 64, None, (256, 4, 1, 12, 214)),    # minibatched sites
    (3000, 64, 8 * 132, (256, 4, 1, 4, 750)),  # more blocks aimed at: beyond the old cap of 528
    (100_000, 64, 8 * 132, (256, 4, 1, 96, 1042)),
    (301, 1, None, (256, 256, 1, 256, 2)),     # one observation a site: 256 sites a tile
    (301, 3, None, (256, 85, 1, 85, 4)),
    (301, 63, None, (256, 4, 1, 4, 76)),
    (301, 64, None, (256, 4, 1, 4, 76)),
    (301, 65, None, (224, 3, 1, 3, 101)),      # 195 rows: 224 threads
    (301, 1000, None, (256, 1, 4, 1, 301)),    # a site longer than a tile: four tiles
    (5000, 1000, None, (256, 1, 4, 19, 264)),
    (6, 300, None, (256, 1, 2, 1, 6)),
    (40, 8, None, (256, 32, 1, 32, 2)),        # a ragged last block
    (1, 1, None, (32, 1, 1, 1, 1)),
], ids=str)
def test_geometry_is_pinned(batch, n_obs, target, want):
    aim = {} if target is None else dict(target_blocks=target)
    geo = fm.multisite_geometry(_plan(), batch, n_obs, **aim)
    assert tuple(geo) == want
    # whole sites a block, every site in one block, no empty block
    assert geo.blocks * geo.sites_per_block >= batch > (geo.blocks - 1) * geo.sites_per_block
    if geo.site_tiles == 1:
        assert geo.tile_sites * n_obs <= geo.threads < geo.tile_sites * n_obs + 32
    else:
        assert geo.tile_sites == 1 and (geo.site_tiles - 1) * geo.threads < n_obs
        assert geo.site_tiles * geo.threads >= n_obs
    assert geo.threads % 32 == 0 and geo.threads <= 256
    assert fm._block_smem_bytes(_plan(), geo.threads, geo.tile_sites) <= fm.MAX_SMEM_BYTES


def test_geometry_takes_its_aim_as_arguments():
    """The blocks aimed at and the largest tile are arguments with the
    kernel's own defaults, not module state; an epoch passes its own."""
    plan = _plan()
    assert fm.multisite_geometry(plan, 8000, 64) == fm.multisite_geometry(
        plan, 8000, 64, target_blocks=fm._TARGET_BLOCKS, max_threads=fm._MAX_THREADS)
    assert tuple(fm.multisite_geometry(plan, 301, 200, max_threads=128)) == (128, 1, 2, 1, 301)
    assert fm.multisite_geometry(plan, 301, 1, max_threads=64).tile_sites == 64
    for bad in (0, 48, 288):
        with pytest.raises(ValueError, match="rows"):
            fm.multisite_geometry(plan, 301, 8, max_threads=bad)
    m = torch_model(300)
    fn = et.make_fused_multisite_epoch(m, ("adam", 0.01), et.LoggingLoss(), shuffle=False,
                                       target_blocks=8 * 132)
    tensors = tepoch.epoch_tensors_to(
        et.build_epoch_tensors(et.gen_multisite_arrays(300, 8, seed=0), 300), "cpu")
    assert fn.geometry(tensors) == fm.multisite_geometry(fn.plan, 300, 8, target_blocks=8 * 132)


def test_geometry_is_a_pure_function_and_shrinks_the_tile_for_wide_models():
    plan = _plan()
    assert fm.multisite_geometry(plan, 8000, 64) == fm.multisite_geometry(_plan(), 8000, 64)
    wide = _plan(hidden=(64,) * 4)
    geo = fm.multisite_geometry(wide, 1000, 64)
    assert geo.threads < 256 and fm._block_smem_bytes(wide, geo.threads, geo.tile_sites) <= (
        fm.MAX_SMEM_BYTES) < fm._block_smem_bytes(wide, geo.threads + 32, geo.tile_sites)
    with pytest.raises(ValueError, match="observations"):
        fm.multisite_geometry(plan, 10, 0)


def test_smem_formula_matches_the_source():
    """``_smem_floats`` against ``ehm_smem_floats``'s return expression,
    parsed from the source and evaluated on the same numbers."""
    src = CU_SOURCE.read_text()
    body = re.search(r"static size_t ehm_smem_floats\(.*?\{(.*?)\n\}", src, re.S).group(1)
    expr = re.search(r"return (.*?);", body, re.S).group(1).replace("(size_t)", "")
    expr = re.sub(r"a->(\w+)", r"a_\1", " ".join(expr.split())).replace("/", "//")
    rng = np.random.default_rng(0)
    for _ in range(50):
        f, p, g, k, t, nf = (int(rng.integers(lo, hi)) for lo, hi in
                             ((1, 65), (1, 9), (1, 9), (0, 5), (1, 5), (1, 9)))
        threads, tile_sites = 32 * int(rng.integers(1, 9)), int(rng.integers(1, 257))
        n_shared, n_padded, res, table = (int(rng.integers(10, 9000)), 4 * int(rng.integers(3, 2500)),
                                          int(rng.integers(4, 500)), int(rng.integers(0, 129)))
        names = dict(F=f, P=p, G=g, K=k, T=t, cols=f + nf + 2 * t, a_n_padded=n_padded,
                     a_n_shared=n_shared, a_threads=threads, a_n_unit_table=table,
                     a_res_floats=res, a_tile_sites=tile_sites)
        want = eval(expr, {"__builtins__": {}}, names)  # noqa: S307 - the repository's own source
        assert want == fm._smem_floats(
            n_padded=n_padded, n_shared=n_shared, f=f, p=p, g=g, k=k, t=t, n_forcing=nf,
            threads=threads, tile_floats=res, tile_sites=tile_sites, n_unit_table=table)
    assert f"#define EHM_MAX_THREADS {fm._MAX_THREADS}" in src
    stamps = int(re.search(r"#define EHM_N_STAMPS (\d+)", src).group(1))
    assert stamps == len(fm.STAGES) + 1


def _first_envelope(tm) -> bool:
    """The envelope as the first kernel 5 had it, written out: the shared
    parameters and their gradient, the small vectors and 32 residual rows
    with a pad column within 227 KB."""
    net = tm.nn
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    f, p, g, k, t = dims[0], dims[-1], len(tm.global_param_names), len(tm.fixed_param_names), 1
    norm = net.norm is not None
    n_shared = (2 * f if norm else 0) + sum(b * (a + 1) for a, b in zip(dims[:-1], dims[1:]))
    res = (3 * f if norm else f) + sum(dims[1:]) + sum(dims[1:-1]) + g
    floats = 2 * n_shared + (2 * p + 2 * g + k) + 2 * f + t + 32 + res * 33
    return 4 * floats <= 227 * 1024


SWEEP = [(w, n, norm) for w in (16, 32, 48, 64) for n in range(1, 8) for norm in (False, "static")]


@pytest.mark.parametrize("width,n_hidden,norm", SWEEP, ids=str)
def test_envelope_is_unchanged_and_every_admitted_model_has_a_geometry(width, n_hidden, norm):
    """The redesign admits and refuses exactly what the first kernel 5 did,
    and every admitted model fits a block at every site shape."""
    tm = torch_model(50, hidden=(width,) * n_hidden, norm=norm)
    admitted = _first_envelope(tm)
    reason = fm.fused_multisite_unsupported_reason(tm, ("adam", 0.01), et.LoggingLoss())
    assert (reason is None) == admitted
    if not admitted:
        assert "shared memory" in reason
        return
    plan = fm.plan_fused_multisite(tm, ("adam", 0.01), et.LoggingLoss())
    for batch, n_obs in ((1, 1), (50, 1), (50, 64), (7, 1000), (3000, 64)):
        geo = fm.multisite_geometry(plan, batch, n_obs)
        assert fm._block_smem_bytes(plan, geo.threads, geo.tile_sites) <= fm.MAX_SMEM_BYTES
