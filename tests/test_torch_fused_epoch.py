"""Kernel 2's plain version (``fused_epoch_reference``, what the wrapper
computes on CPU tensors) against the JAX package's fused epoch kernel in
interpret mode and against the port's torch epoch; the envelope and its
reasons; the kernel form's partials check; the exactness gate; and the
ctypes mirror of the CUDA argument struct.

Tolerances, float32: atol 2e-6 after one epoch and 1e-5 after three (as
tests/test_fused.py), and 5e-6 for the running variance, whose magnitude is
~400 (about 1e-8 relative)."""

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
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer

CU_SOURCE = Path(fe.__file__).resolve().parent.parent / "csrc" / "fused_epoch.cu"
LL = et.LoggingLoss(training_loss="mse", loss_types=("mse",))


def _spec(norm=True, hidden=(8,), act="tanh", **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(kw)
    return spec


def setup(norm=True, n=512, batch=128, data=None, nan_frac=0.0, **kw):
    spec = _spec(norm, **kw)
    jm, tm = eh.construct_hybrid_model(**spec), et.construct_hybrid_model(**spec)
    if data is None:
        data = et.prepare_data(tm, et.rbq10_columns(n, seed=42, nan_frac=nan_frac))
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        from easyhybrid_tpu.training.train import fit_input_norm

        state = fit_input_norm(jm, state, data)
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


def assert_model_matches(tm, jparams, jstate, atol):
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, np.asarray(b), atol=max(atol, 5e-6), rtol=1e-5)


CASES = [
    # opt, shuffle, epochs, norm, hidden, act, data kwargs
    (("adam", 0.01), False, 1, True, (8,), "tanh", {}),
    (("sgd", 0.05), False, 1, "static", (8,), "tanh", {}),
    (("sgd", 0.05), False, 1, False, (8,), "tanh", {"n": 300}),
    (("adam", 0.01), True, 1, True, (12, 5), "swish", {}),
    (("adam", 0.01), "batches", 1, "static", (12, 5), "gelu", {}),
    (("adam", 0.01), True, 3, True, (8,), "tanh", {}),
    (("adam", 0.01), True, 1, True, (8,), "softplus", {"n": 256, "batch": 64, "nan_frac": 0.5}),
]
# every optimizer rule of the training kernels besides adam and plain sgd, at
# a learning rate that moves the parameters in a few steps (the four
# kernels' parity tests take one case each)
RULES = [("adamw", 0.01), ("sgd", 0.05, 0.9), ("sgd", 0.05, 0.9, 1.0), ("rmsprop", 0.01),
         ("adagrad", 0.05), ("lion", 0.001), ("adamax", 0.01), ("nadam", 0.01),
         ("adadelta", 1.0), ("radam", 0.01), ("amsgrad", 0.01), ("lamb", 0.01)]
# three epochs where the rule changes course after some steps (radam rectifies
# from step 6)
RULE_CASES = [
    (RULES[0], True, 1, True, (8,), "tanh", {}),
    (RULES[1], False, 1, True, (8,), "tanh", {}),
    (RULES[2], True, 1, "static", (8,), "tanh", {}),
    (RULES[3], True, 1, True, (8,), "tanh", {}),
    (RULES[4], "batches", 1, True, (8,), "swish", {}),
    (RULES[5], True, 1, True, (8,), "tanh", {}),
    (RULES[6], True, 1, "static", (8,), "tanh", {}),
    (RULES[7], True, 1, True, (12, 5), "swish", {}),
    (RULES[8], True, 1, True, (8,), "tanh", {}),
    (RULES[9], True, 3, True, (8,), "tanh", {}),
    (RULES[10], True, 3, True, (8,), "tanh", {}),
    (RULES[11], True, 1, True, (12, 5), "tanh", {}),
]


def assert_slots_match(plan, tm, opt_state, jax_opt_state, atol, rtol=1e-4):
    """Every slot of the port's packed opt state against the JAX kernel's
    slot trees (the same conventions), leaf by leaf through a twin model. A
    file's tolerance for moments applies (here the torch-epoch comparison's
    rtol 1e-4: a moment sums gradients, which differ more than the
    parameters)."""
    twin = copy.deepcopy(tm)
    bn = plan.pack(twin).bn
    assert set(fe.opt_slots(opt_state)) == {k for k in ("m", "v", "u") if k in jax_opt_state}
    for k, slot in fe.opt_slots(opt_state).items():
        plan.unpack(fe.FusedParams(slot, bn), twin)
        got, _ = et.export_jax_params(twin)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_opt_state[k])):
            np.testing.assert_allclose(a, np.asarray(b).reshape(np.shape(a)), atol=atol, rtol=rtol,
                                       err_msg=k)


@pytest.mark.parametrize("opt,shuffle,epochs,norm,hidden,act,data_kw", CASES + RULE_CASES, ids=str)
def test_reference_matches_jax_fused_epoch(opt, shuffle, epochs, norm, hidden, act, data_kw):
    jm, params, state, jt, tm, tt = setup(norm, hidden=hidden, act=act, **data_kw)
    key = jax.random.PRNGKey(5)
    jll = eh.LoggingLoss(training_loss="mse", loss_types=("mse",))
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                             key)

    fn = et.make_fused_epoch(tm, opt, LL, shuffle=shuffle, epochs_per_call=epochs)
    nb, batch = tt.weight.shape
    p0 = fn.plan.pack(tm)
    _, os_, loss = fn(tm, fe.init_fused_opt_state(p0, opt), tt,
                      perms=jax_perms(shuffle, key, epochs, nb, batch))
    atol = 2e-6 if epochs == 1 else 1e-5
    assert_model_matches(tm, jp, js, atol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(jos["t"][0])
    assert_slots_match(fn.plan, tm, os_, jos, atol)


# the torch optimizers' slot names, and the fused slot each is kept in (adagrad's
# sum of squares starts at the initial accumulator; the fused v at zero)
TORCH_SLOTS = {"mu": "m", "trace": "m", "e_x": "m", "nu": "v", "e_g": "v",
               "sum_of_squares": "v", "nu_max": "u"}


def assert_torch_slots_match(plan, opt, opt_state, torch_state, atol, rtol=1e-4):
    """Every slot of the port's packed opt state against the torch
    optimizer's state of the same run."""
    optim = resolve_optimizer(opt)
    for slot in optim.slots:
        leaves = plan.leaves(opt_state[TORCH_SLOTS[slot]])
        shift = (optim.hyperparameters["initial_accumulator_value"]
                 if slot == "sum_of_squares" else 0.0)
        for name, t in torch_state[slot].items():
            np.testing.assert_allclose(leaves[name].numpy() + shift, t.reshape(-1).numpy(),
                                       atol=atol, rtol=rtol, err_msg=slot)


@pytest.mark.parametrize("opt,shuffle,epochs,norm,hidden,act,data_kw", CASES + RULE_CASES, ids=str)
def test_reference_matches_the_torch_epoch(opt, shuffle, epochs, norm, hidden, act, data_kw):
    *_, tm, tt = setup(norm, hidden=hidden, act=act, **data_kw)
    twin = et.construct_hybrid_model(**_spec(norm, hidden=hidden, act=act))
    twin.load_state_dict(tm.state_dict())
    perms = tepoch.perms_for_epochs(shuffle, tt, epochs, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_epoch(tm, opt, LL, shuffle=shuffle, epochs_per_call=epochs)
    packed, os_, loss = fn(fn.plan.pack(tm), fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                           perms=perms)
    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, LL, optim, shuffle=shuffle, epochs_per_call=epochs)
    state, tloss = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    want = fn.plan.pack(twin)
    atol = 2e-6 if epochs == 1 else 1e-5
    np.testing.assert_allclose(packed.params.numpy(), want.params.numpy(), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(packed.bn.numpy(), want.bn.numpy(), atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(tloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])
    assert_torch_slots_match(fn.plan, opt, os_, state, atol)


def test_first_batch_fully_masked_keeps_adam_finite():
    """An all-masked first batch: no step is counted, the update is gated
    off (1 - b1^0 = 0 must not leak NaN), the BatchNorm statistics stay."""
    cols = et.rbq10_columns(256, seed=3)
    y = cols["reco"].copy()
    y[:64] = np.nan
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": y})
    jm, params, state, jt, tm, tt = setup(True, data=data, batch=64)
    jfn = jax_fused_epoch(jm, state, ("adam", 0.01), eh.LoggingLoss(training_loss="mse"), shuffle=False)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params), state, jt,
                             jax.random.PRNGKey(0))
    fn = et.make_fused_epoch(tm, ("adam", 0.01), LL, shuffle=False)
    p0 = fn.plan.pack(tm)
    _, os_, loss = fn(tm, fe.init_fused_opt_state(p0), tt)
    assert int(os_["t"][0]) == 3 == int(jos["t"][0])
    assert all(torch.isfinite(p).all() for p in tm.parameters())
    assert_model_matches(tm, jp, js, 2e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("overrides,optimizer,logging,reason", [
    ({}, "noisy_sgd", LL, "noisy_sgd"),
    ({}, ("radam", {"learning_rate": 0.01, "threshold": 3.0}), LL, "threshold 3.0 < 4"),
    ({}, {"nn": "adam"}, LL, "per-branch"),
    # kernel 2 trains every loss of the JAX kernel and any traceable elementwise
    # loss; an opaque callable, a per-target spec and an elementwise loss the
    # tracer refuses stay on the torch engine
    ({}, "adam", et.LoggingLoss(training_loss=lambda yh, y, m: (yh - y).abs().sum()),
     "trains mse, mae, rmse, nseLoss, pearsonLoss, kgeLoss, pbkgeLoss and any traceable"),
    ({}, "adam", et.LoggingLoss(training_loss=et.PerTarget(["mse"])), "trains mse, mae"),
    ({}, "adam", et.LoggingLoss(training_loss=et.ElementwiseLoss(
        lambda yh, y: torch.sin(yh - y), name="sine")),
     "training loss 'sine' has no kernel form: operation torch.sin"),
    # the declarative weight-L2 trains on the kernel (tests/test_torch_fused_l2.py); an
    # opaque extra_loss does not
    ({}, "adam", et.LoggingLoss(extra_loss=lambda outputs, params: 0.0), "extra_loss"),
    ({}, "adam", et.LoggingLoss(agg=lambda xs: xs[0]), "agg"),
    ({"hidden_layers": [65]}, "adam", LL, "cap of 64"),
    ({"activation": torch.tanh}, "adam", LL, "activation"),
    ({"hidden_layers": [64] * 7}, "adam", LL, "shared memory"),
])
def test_envelope_reasons(overrides, optimizer, logging, reason):
    tm = et.construct_hybrid_model(**_spec(**overrides))
    got = fe.fused_epoch_unsupported_reason(tm, optimizer, logging)
    assert got is not None and reason in got
    assert not et.supports_fused_epoch(tm, optimizer, logging)


def _lamb_step_against_optax(plan, scale):
    """One lamb step of the plain version on random packed vectors whose first
    weight matrix is ``scale`` times the rest, against optax.lamb on the
    leaves; returns the step and what one trust ratio over the whole vector
    would give."""
    import optax

    rng = np.random.default_rng(0)
    p = torch.tensor(rng.normal(size=plan.n_params), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=plan.n_params), dtype=torch.float32)
    next(v for k, v in plan.leaves(p).items() if k.endswith("weight")).mul_(scale)
    zeros = {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}
    got, slots, t = fe._reference_update(plan, p, zeros, torch.zeros((1,)), g, torch.tensor(True))
    tx = optax.lamb(0.01)
    params = {k: jnp.asarray(v.numpy()) for k, v in plan.leaves(p).items()}
    grads = {k: jnp.asarray(v.numpy()) for k, v in plan.leaves(g).items()}
    upd, _ = tx.update(grads, tx.init(params), params)
    want = torch.cat([torch.from_numpy(np.array(params[k] + upd[k])) for k in params])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7, rtol=1e-5)
    assert float(t[0]) == 1.0 and torch.equal(slots["m"], 0.1 * g)
    # the direction of a first step is g / (|g| + eps) elementwise
    d = g / (g.abs() + 1e-6)
    whole = p - 0.01 * (torch.linalg.vector_norm(p) / torch.linalg.vector_norm(d)) * d
    return got, whole


def test_lamb_takes_its_norms_per_leaf():
    """Two leaves of very different scale: the plain version gives optax's
    lamb step (a trust ratio per leaf), far from one ratio over the packed
    vector; the kernels get the leaves as the packed segments."""
    tm = et.construct_hybrid_model(**_spec(True, hidden=(8, 4)))
    plan = fe.plan_fused_epoch(tm, ("lamb", 0.01), LL)
    got, whole = _lamb_step_against_optax(plan, 1000.0)
    assert float((got - whole).abs().max()) > 1.0
    o = fe.optimizer_struct(plan)
    ends = [off + int(np.prod(shape)) for _, off, shape in plan.segments]
    assert o.rule == fe._OPTS["lamb"] and o.n_leaves == len(ends) == 2 + 2 * 3 + 1
    assert list(o.leaf_end[: o.n_leaves]) == ends and ends[-1] == plan.n_params


def test_lamb_takes_a_multisite_global_over_every_site_as_one_leaf():
    """A multi-site plan's per-site global is one (S, 1) leaf, as optax sees
    the stacked leaf: its S values share one trust ratio."""
    base = et.construct_hybrid_model(**_spec("static", hidden=(8,)), device="cpu")
    tm = et.MultiSiteHybridModel(base, 50, device="cpu")
    plan = et.make_fused_multisite_epoch(tm, ("lamb", 0.01), LL).plan
    assert plan.segments[-1][0] == "globals.Q10" and plan.segments[-1][2] == (50, 1)
    _lamb_step_against_optax(plan, 30.0)
    assert fe.optimizer_struct(plan).leaf_end[len(plan.segments) - 1] == plan.n_params


@pytest.mark.parametrize("opt", RULES, ids=str)
def test_every_rule_keeps_kernel_2s_envelope_and_has_a_geometry(opt):
    """The envelope, and the size rule between kernels 2 and 3, do not depend
    on the rule; every admitted model has a geometry at every batch size, with
    amsgrad's u beside the moments in shared memory or all of them in device
    memory (one block)."""
    for width, n_hidden, norm in SWEEP:
        tm = et.construct_hybrid_model(**_spec(norm, hidden=(width,) * n_hidden))
        admitted = fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), LL) is None
        assert (fe.fused_epoch_unsupported_reason(tm, opt, LL) is None) == admitted
        if not admitted:
            continue
        plan = fe.plan_fused_epoch(tm, opt, LL)
        adam = fe.plan_fused_epoch(tm, ("adam", 0.01), LL)
        for batch in (1, 100, 513, 100_000):
            g = plan.geometry(batch)
            assert _smem_bytes(plan, g) <= fe.MAX_SMEM_BYTES
            if opt[0] != "amsgrad":
                assert g == adam.geometry(batch)
            else:
                assert g.moments_shared in (0, 2) and (g.moments_shared or g.cluster == 1)


def test_envelope_accepts_the_quick_start_and_every_norm():
    for norm in (True, "static", False):
        for act in sorted(et.ACTIVATIONS):
            tm = et.construct_hybrid_model(**_spec(norm, hidden=(16, 16), act=act))
            assert et.supports_fused_epoch(tm, ("adam", 0.01), et.LoggingLoss(agg="mean"))
    tm = et.construct_hybrid_model(**_spec(hidden=(64, 64)))
    plan = fe.plan_fused_epoch(tm, "sgd", LL)
    assert plan.width == 64 and plan.tile_rows == 128 and plan.opt_name == "sgd"


def test_form_partials_check_raises_on_a_wrong_partial():
    form = ff.KERNEL_FORMS["rbq10"]
    args = (torch.tensor([2.0, 3.0]), torch.tensor([1.5]), torch.tensor([10.0, 25.0]), 15.0)
    ff.check_form_partials(form, args)

    def wrong(rb, Q10, ta, tref):
        (parts,) = form.partials_fn(rb, Q10, ta, tref)
        return ((parts[0], 1.01 * parts[1], parts[2], parts[3]),)

    with pytest.raises(ValueError, match="'Q10' disagrees with torch.func.jvp"):
        ff.check_form_partials(dataclasses.replace(form, partials_fn=wrong), args)


@pytest.mark.parametrize("shuffle,epochs", [(False, 1), (True, 3), ("batches", 2)])
def test_gate_passes_on_the_plain_version(shuffle, epochs):
    *_, tm, tt = setup(True, hidden=(16, 16), act="swish")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), LL, tt, epochs_per_call=epochs,
                                         shuffle=shuffle)
    assert ok and worst < 1e-4
    for k, v in tm.state_dict().items():  # the gate leaves the model as it was
        assert torch.equal(v, before[k])


def test_gate_fails_on_a_corrupted_gradient(monkeypatch):
    *_, tm, tt = setup(True)
    real = fe.reference_grads

    def corrupted(*args):
        g, loss, valid, bn = real(*args)
        return g * 1.5, loss, valid, bn

    monkeypatch.setattr(fe, "reference_grads", corrupted)
    ok, worst = fe.fused_exactness_check(tm, ("adam", 0.01), LL, tt)
    assert not ok and worst > 0.1


def test_kernel_source_and_ctypes_mirror_agree():
    # the caps live in the header both training kernels include
    src = CU_SOURCE.with_name("eh_device.cuh").read_text() + CU_SOURCE.read_text()
    assert '#include "eh_device.cuh"' in src
    defines = dict(re.findall(r"#define (EH_MAX_\w+) (\d+)", src))
    for name in ("WIDTH", "LAYERS", "FORCING", "ARGS", "SCALARS"):
        assert int(defines[f"EH_MAX_{name}"]) == getattr(ff, f"MAX_{name}")
    assert int(defines["EH_MAX_TARGETS"]) == fe.MAX_TARGETS
    assert "(227 * 1024)" in src and fe.MAX_SMEM_BYTES == 227 * 1024
    body = re.search(r"struct EhFusedEpochArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body))
    assert fields == [name for name, _ in fe._Args._fields_]
    assert "norm_mode" in fields and ctypes.sizeof(fe._Args) > 0


def test_kernel_arguments_pack_the_plan():
    tm = et.construct_hybrid_model(**_spec(True, hidden=(16, 16), act="swish"))
    plan = fe.plan_fused_epoch(tm, ("adam", 0.01), LL)
    a = fe._Args.from_buffer_copy(plan.args_bytes)
    assert plan.n_params == a.n_params == 2 * 2 + 16 * 3 + 16 * 17 + 17 + 1
    assert a.n_nets == 1 and a.n_features == 2 and a.n_neural == 1
    assert list(a.nets[0].dims[:4]) == [2, 16, 16, 1] and a.norm_mode == 2 and a.optimizer.rule == 1
    assert list(a.nets[0].p_off_w[:3]) == [4, 52, 324] and a.p_off_g == plan.n_params - 1
    assert a.optimizer.one_minus_b1 == np.float32(1.0 - 0.9) and plan.tile_rows == 128
    # the backward's residuals, then the output, its scaling's derivative and the feature of ones
    assert a.r_off_g + 1 == plan.res_floats == a.r_off_out == a.r_off_dsc - 1 == a.r_off_one - 2
    assert a.res_floats == plan.tile_floats == plan.res_floats + 3
    packed = plan.pack(tm)
    assert packed.params.numel() == plan.n_params and packed.bn.numel() == 4
    twin = et.construct_hybrid_model(**_spec(True, hidden=(16, 16), act="swish"))
    plan.unpack(packed, twin)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k])


def _parent_envelope(tm) -> bool:
    """The envelope as the first kernel 2 had it, written out: parameters,
    two moments and a gradient, the small vectors, and 32 residual rows with
    a pad column within 227 KB."""
    net = tm.nn
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    f, p, g, k, t = dims[0], dims[-1], len(tm.global_param_names), len(tm.fixed_param_names), 1
    norm = net.norm is not None
    n_params = (2 * f if norm else 0) + sum(b * (a + 1) for a, b in zip(dims[:-1], dims[1:])) + g
    res = (3 * f if norm else f) + sum(dims[1:]) + sum(dims[1:-1]) + g
    floats = (4 * n_params + 2 * f + (2 * p + 2 * g + k) + 2 * g + k + 3 * f + t + 4 + 32
              + max(res, f + t) * 33)
    return 4 * floats <= 227 * 1024


def _smem_bytes(plan, g: fe.Geometry) -> int:
    return plan.smem_bytes(g.threads, g.stages, g.moments_shared)


@pytest.mark.parametrize("hidden,norm,batch,want", [
    # the quick-start: the whole batch in flight in two blocks of 256, staged
    ((16, 16), True, 512, (256, 256, 2, 2, 256, 1)),
    ((16, 16), True, 256, (256, 256, 2, 1, 256, 1)),
    ((16, 16), True, 31, (32, 32, 2, 1, 31, 1)),
    ((16, 16), True, 33, (64, 64, 2, 1, 33, 1)),
    ((16, 16), True, 513, (160, 160, 2, 4, 129, 1)),
    ((16, 16), True, 1000, (256, 256, 2, 4, 250, 1)),
    ((16, 16), True, 2049, (288, 288, 2, 8, 257, 1)),
    ((16, 16), True, 20000, (512, 512, 0, 8, 2500, 1)),  # beyond a cluster: tiles, rows in place
    ((32, 24), True, 256, (256, 256, 2, 1, 256, 1)),
    ((64, 48), False, 300, (160, 160, 2, 2, 150, 1)),
    ((64, 48), "static", 3000, (160, 160, 0, 8, 375, 1)),
    ((64, 64, 64), True, 512, (32, 32, 0, 8, 64, 1)),  # little room beside the state
    ((61, 61, 44, 61, 13), False, 128, (64, 64, 0, 1, 128, 0)),  # moments in device memory
], ids=str)
def test_geometry_is_a_pure_function_of_plan_and_batch(hidden, norm, batch, want):
    tm = et.construct_hybrid_model(**_spec(norm, hidden=hidden, act="swish"))
    plan = fe.plan_fused_epoch(tm, ("adam", 0.01), LL)
    g = plan.geometry(batch)
    assert tuple(g) == want and g == plan.geometry(batch)
    assert g.threads % 32 == 0 and g.threads <= fe._MAX_THREADS[plan.width]
    assert g.cluster in (1, 2, 4, 8) and g.cluster * g.block_rows >= batch
    assert g.stages in (0, 2) and (g.stages == 0 or g.tiles == 1)
    assert g.moments_shared == 1 or g.cluster == 1
    assert _smem_bytes(plan, g) <= fe.MAX_SMEM_BYTES
    forced = dataclasses.replace(plan, cluster=4).geometry(batch)
    assert forced.cluster == (4 if g.moments_shared else 1)


def test_smem_formula_matches_the_source():
    """``_smem_floats`` against ``ehe_smem_floats``'s return expression, and
    ``_loss_floats`` against ``ehe_loss_floats``'s, parsed from the source and
    evaluated on the same numbers for every loss."""
    src = CU_SOURCE.read_text()
    body = re.search(r"static size_t ehe_smem_floats\(.*?\{(.*?)\n\}", src, re.S).group(1)
    expr = re.search(r"return (.*?);", body, re.S).group(1).replace("(size_t)", "")
    expr = re.sub(r"a->(\w+)", r"a_\1", " ".join(expr.split()))
    expr = expr.replace("ehe_loss_floats(a, NW, T)", "LOSS")
    lbody = re.search(r"static int ehe_loss_floats\(.*?\{(.*?)\n\}", src, re.S).group(1)
    cond, amount = re.search(r"return \((.*?)\) \? (.*?) : 0;", lbody, re.S).groups()
    cond = re.sub(r"a->(\w+)", r"a_\1", " ".join(cond.split())).replace("||", " or ")
    kinds = {"LOSS_RMSE": fe.LOSS_KINDS["rmse"],
             "ehe_loss_is_stat": lambda k: k in [fe.LOSS_KINDS[n] for n in fe.STAT_LOSSES]}
    rng = np.random.default_rng(0)
    losses = list(fe.FUSED_LOSSES) + [fe.ELEMENTWISE]
    for i in range(50):
        f, p, g, k, t, nf = (int(rng.integers(lo, hi)) for lo, hi in
                             ((1, 65), (1, 9), (1, 9), (0, 5), (1, 5), (1, 9)))
        threads, stages, shared = 32 * int(rng.integers(1, 17)), int(rng.choice([0, 2])), int(
            rng.integers(0, 2))
        n_params, n_padded, res, table = (int(rng.integers(10, 9000)), 4 * int(rng.integers(3, 2500)),
                                          int(rng.integers(4, 500)), int(rng.integers(0, 129)))
        loss = losses[i % len(losses)]
        names = dict(F=f, P=p, G=g, K=k, T=t, NW=threads // 32, COLS=f + nf + 2 * t,
                     a_n_padded=n_padded, a_moments_shared=shared, a_n_params=n_params,
                     a_n_unit_table=table, a_tile_rows=threads, a_res_floats=res, a_stages=stages,
                     a_loss_sst=int(loss in fe.TARGET_MOMENT_LOSSES), k=fe.LOSS_KINDS[loss],
                     a_l2_leaves=int(rng.integers(0, 2)) * 0b1010, **kinds)
        names["LOSS"] = eval(amount, {"__builtins__": {}}, names) if eval(  # noqa: S307
            cond, {"__builtins__": {}}, names) else 0
        assert names["LOSS"] == fe._loss_floats(loss, threads // 32, t)
        want = eval(expr, {"__builtins__": {}}, names)  # noqa: S307 - the repository's own source
        assert want == fe._smem_floats(
            n_padded=n_padded, n_params=n_params, f=f, p=p, g=g, k=k, t=t, n_forcing=nf,
            threads=threads, res=res, stages=stages, moments_shared=shared, n_unit_table=table,
            loss_floats=fe._loss_floats(loss, threads // 32, t), l2=names["a_l2_leaves"] != 0)
    caps = dict(re.findall(r"#define (EHE_N_STAMPS|EH_MAX_SMEM_BYTES) \(?([\d *]+)\)?", src
                           + CU_SOURCE.with_name("eh_device.cuh").read_text()))
    assert int(caps["EHE_N_STAMPS"]) == len(fe.STAGES) + 1
    assert "#define EHE_MAX_THREADS(W) ((W) == 64 ? 256 : 512)" in src
    assert fe._MAX_THREADS == {16: 512, 32: 512, 64: 256}


SWEEP = [(w, n, norm) for w in (16, 32, 64) for n in range(1, 8) for norm in (True, "static", False)]


@pytest.mark.parametrize("width,n_hidden,norm", SWEEP, ids=str)
def test_envelope_is_unchanged_and_every_admitted_model_has_a_geometry(width, n_hidden, norm):
    """The redesign admits and refuses exactly what the first kernel 2 did,
    every admitted model fits shared memory at every batch size, and
    ``fused_engine`` sends the same models to kernels 2 and 3 as before."""
    tm = et.construct_hybrid_model(**_spec(norm, hidden=(width,) * n_hidden))
    admitted = _parent_envelope(tm)
    reason = fe.fused_epoch_unsupported_reason(tm, ("adam", 0.01), LL)
    assert (reason is None) == admitted
    engine = fe.fused_engine(tm).epoch_path
    assert engine == ("cuda_fused_epoch" if admitted else "cuda_fused_wide")
    if not admitted:
        assert "shared memory" in reason
        return
    plan = fe.plan_fused_epoch(tm, ("adam", 0.01), LL)
    for batch in (1, 32, 100, 512, 513, 5000, 100_000):
        assert _smem_bytes(plan, plan.geometry(batch)) <= fe.MAX_SMEM_BYTES


@pytest.mark.parametrize("hidden", [(61, 61, 44, 61, 13), (13, 57, 57, 40, 36, 57),
                                    (45, 12, 45, 45, 45, 45, 45), (65,), (64,) * 7])
def test_odd_widths_near_the_limit_keep_their_engine(hidden):
    """Rows padded to 4 floats cost shared memory: a model the envelope
    admits near the limit keeps kernel 2 (its moments then live in device
    memory); one it refuses still goes to kernel 3."""
    tm = et.construct_hybrid_model(**_spec(False, hidden=hidden))
    admitted = max(hidden) <= 64 and _parent_envelope(tm)
    assert fe.supports_fused_epoch(tm, ("adam", 0.01), LL) == admitted
    assert fe.fused_engine(tm).epoch_path == ("cuda_fused_epoch" if admitted else "cuda_fused_wide")
    if admitted:
        plan = fe.plan_fused_epoch(tm, ("adam", 0.01), LL)
        g = plan.geometry(128)
        assert g.moments_shared == 0 and g.cluster == 1
        assert _smem_bytes(plan, g) <= fe.MAX_SMEM_BYTES


@pytest.mark.parametrize("dims,norm,n_globals", [
    ((2, 16, 16, 1), True, 1), ((2, 12, 5, 1), True, 1), ((3, 61, 7, 2), False, 3),
    ((64, 64, 1), True, 2), ((1, 1), False, 1),
])
def test_padded_layout_keeps_order_and_aligns_rows(dims, norm, n_globals):
    pp = fe.padded_offsets(dims, norm, n_globals)
    packed = fe.param_offsets(dims, norm)
    off = 2 * dims[0] if norm else 0
    for i, (w, b) in enumerate(zip(pp["pp_w"], pp["pp_b"])):
        row = -(-dims[i] // 4) * 4
        assert w % 4 == 0 and w >= off and b == w + dims[i + 1] * row
        off = b + dims[i + 1]
    assert pp["pp_g"] == off and pp["n_padded"] % 4 == 0 and pp["n_padded"] >= off + n_globals
    assert pp["n_padded"] - (packed["p_g"] + n_globals) <= 3 * (sum(dims[1:]) + len(dims) + 1)
    if all(d % 4 == 0 for d in dims[:-1]) and (not norm or dims[0] % 2 == 0):
        assert pp["pp_w"] == packed["p_w"] or any(o % 4 for o in packed["p_w"])


def test_gradient_units_cover_the_quick_start():
    # layers 16x2, 16x16, 1x16 in 4 x 4 blocks with a bias block per four outputs;
    # the norm's 2 scales and its bias block; the global
    assert fe.gradient_units((2, 16, 16, 1), True, 1) == 4 * 2 + 4 * 5 + 1 * 5 + 2 + 1 + 1 == 37
    assert fe.gradient_units((2, 16, 16, 1), False, 1) == 34
    tm = et.construct_hybrid_model(**_spec(True, hidden=(16, 16), act="swish"))
    plan = fe.plan_fused_epoch(tm, ("adam", 0.01), LL)
    a = fe._Args.from_buffer_copy(plan.args_bytes)
    assert a.n_unit_table == plan.n_unit_table == 37 and a.n_forcing == 1
    assert list(a.nets[0].pp_off_w[:3]) == [4, 84, 356] and a.pp_off_g == 373 and a.n_padded == 376
    wide = et.construct_hybrid_model(**_spec(True, hidden=(64, 64)))
    assert fe.plan_fused_epoch(wide, "adam", LL).n_unit_table == 128


@pytest.mark.cuda
def test_kernel_matches_reference_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    *_, tm, tt = setup(True, hidden=(16, 16), act="swish", n=2000, batch=256)
    tm.to("cuda")
    tt = tepoch.epoch_tensors_to(tt, "cuda")
    fn = et.make_fused_epoch(tm, ("adam", 0.01), LL, shuffle=True, epochs_per_call=2)
    perms = tepoch.perms_for_epochs(True, tt, 2, generator=torch.Generator("cuda").manual_seed(0))
    p0 = fn.plan.pack(tm)
    got = fn(p0, fe.init_fused_opt_state(p0), tt, perms=perms)
    want = fn.reference(p0, fe.init_fused_opt_state(p0), tt, perms=perms)
    torch.testing.assert_close(got[0].params, want[0].params, atol=1e-5, rtol=1e-5)
