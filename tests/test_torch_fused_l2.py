"""The declarative weight-L2 ``extra_loss`` (``l2_extra_loss``) in kernels 2
and 3: their plain versions (what the wrappers compute on CPU tensors)
against the JAX package's fused epoch kernel in interpret mode and its XLA
epoch, as tests/test_fused.py holds the JAX kernel against its XLA epoch;
kernel 3's against the JAX kernel's batch-chunked body (a lowered
``EASYHYBRID_FUSED_MAX_VMEM_MB`` with ``EASYHYBRID_FUSED_CHUNKED=1``, set with
``monkeypatch``, at batch 256), and under a trainable norm against its
unchunked body; the plan's penalty (leaves, count, the factor of ``agg``)
and its fields in the kernels' argument structs; the envelopes (kernels 2
and 3 take the declarative penalty and refuse any other ``extra_loss``,
kernels 4 and 5 refuse every one, as the JAX kernels do).

Tolerances, float32: parameters atol 3e-6 with rtol 1e-5 and the loss rtol
1e-5, as tests/test_fused.py holds the JAX kernel against its XLA epoch
(the penalty's sum of squares and the products are taken in other orders on
each side)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.ops.fused_epoch import _pick_batch_chunks
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.training.epoch import make_train_epoch as jax_train_epoch
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from test_torch_fused_epoch import setup as setup_epoch
from test_torch_fused_wide import _spec as wide_spec
from test_torch_fused_wide import setup as setup_wide

OPT = ("adam", 0.01)
ATOL, RTOL = 3e-6, 1e-5


def _ll(pkg, agg, scale=0.5, **kw):
    return pkg.LoggingLoss(training_loss="mse", loss_types=("mse",), agg=agg,
                           extra_loss=pkg.l2_extra_loss(scale, **kw))


def _jax_runs(jm, params, state, jt, agg, **l2_kw):
    """The JAX kernel (interpret mode on the CPU) and its XLA epoch, one
    unshuffled epoch each: ``[(params, loss)]``."""
    jll = _ll(eh, agg, **l2_kw)
    fused = jax_fused_epoch(jm, state, OPT, jll, shuffle=False)
    p_f, _, _, loss_f = fused(jax.tree.map(jnp.array, params), jax_init_opt(params, OPT), state,
                              jt, jax.random.PRNGKey(1))
    optimizer = optax.adam(0.01)
    xla = jax_train_epoch(jm, jll, optimizer, shuffle=False)
    p_x, _, _, loss_x = xla(jax.tree.map(jnp.array, params), optimizer.init(params),
                            jax.tree.map(jnp.array, state), jt, jax.random.PRNGKey(1))
    return [("the JAX kernel", p_f, loss_f), ("the JAX XLA epoch", p_x, loss_x)]


def _assert_matches(tm, got_loss, runs):
    got, _ = et.export_jax_params(tm)
    for what, p, loss in runs:
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(p)):
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=what)
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("norm", [True, "static"])
def test_kernel2_plain_version_matches_the_jax_kernel_and_xla(agg, norm):
    jm, params, state, jt, tm, tt = setup_epoch(norm)
    runs = _jax_runs(jm, params, state, jt, agg)
    fn = et.make_fused_epoch(tm, OPT, _ll(et, agg), shuffle=False)
    assert fn.plan.l2 is not None and fn.plan.l2.ex_outer == (0.5 if agg == "mean" else 1.0)
    p0 = fn.plan.pack(tm)
    _, _, loss = fn(tm, fe.init_fused_opt_state(p0, OPT), tt)
    _assert_matches(tm, loss, runs)


def test_kernel2_multinn_plain_version_matches_the_jax_kernel_and_xla():
    """Every branch's weights take the penalty (its count over all of them)."""
    spec = dict(predictors={"rb": ["sw_pot", "dsw_pot"]}, hidden_layers=[6, 5],
                neural_param_names=["rb"], global_param_names=["Q10"])
    jm, params, state, jt, tm, tt = setup_epoch(True, **spec)
    runs = _jax_runs(jm, params, state, jt, "mean", scale=0.3)
    fn = et.make_fused_epoch(tm, OPT, _ll(et, "mean", scale=0.3), shuffle=False)
    assert fn.plan.l2.count == 2 * 6 + 6 * 5 + 5
    _, _, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), OPT), tt)
    _assert_matches(tm, loss, runs)


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_kernel3_plain_version_matches_the_jax_chunked_kernel_and_xla(monkeypatch, agg):
    """Each batch of 256 in two chunks on the JAX side: the penalty's value
    enters once a batch, at its last chunk, and its gradient the sum of the
    chunks' before the rule."""
    jm, params, state, jt, tm, tt = setup_wide()
    monkeypatch.setenv("EASYHYBRID_FUSED_MAX_VMEM_MB", "0.45")
    monkeypatch.setenv("EASYHYBRID_FUSED_CHUNKED", "1")
    assert _pick_batch_chunks(jm, [jm.nn], jt, _ll(eh, agg)) == 2
    runs = _jax_runs(jm, params, state, jt, agg)
    fn = et.make_fused_wide_epoch(tm, OPT, _ll(et, agg), shuffle=False)
    _, _, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), OPT), tt)
    _assert_matches(tm, loss, runs)


def test_kernel3_trainable_norm_matches_the_jax_kernel_and_xla():
    """The GPU tutorial's form (a trainable norm, the JAX kernel's unchunked
    body), the penalty unnormalised."""
    jm, params, state, jt, tm, tt = setup_wide(norm=True)
    runs = _jax_runs(jm, params, state, jt, "mean", scale=1e-3, normalize=False)
    fn = et.make_fused_wide_epoch(tm, OPT, _ll(et, "mean", scale=1e-3, normalize=False),
                                  shuffle=False)
    assert fn.plan.l2.value_scale == 1e-3
    _, _, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), OPT), tt)
    _assert_matches(tm, loss, runs)


@pytest.mark.parametrize("kernel", ["kernel 2", "kernel 3"])
def test_plain_versions_match_the_torch_epoch(kernel):
    """The port's torch epoch (``compute_loss`` with the penalty through
    autograd) against each plain version, shuffled, two epochs."""
    if kernel == "kernel 2":
        *_, tm, tt = setup_epoch(True)
        make = et.make_fused_epoch
    else:
        *_, tm, tt = setup_wide(hidden=(70, 33))
        make = et.make_fused_wide_epoch
    twin = copy.deepcopy(tm)
    ll = _ll(et, "mean", scale=0.2)
    perms = tepoch.perms_for_epochs(True, tt, 2, generator=torch.Generator().manual_seed(1))
    fn = make(tm, OPT, ll, shuffle=True, epochs_per_call=2)
    p0 = fn.plan.pack(tm)
    packed, _, got_loss = fn(p0, fe.init_fused_opt_state(p0, OPT), tt, perms=perms)
    optim = resolve_optimizer(OPT)
    tfn = tepoch.make_train_epoch(twin, ll, optim, shuffle=True, epochs_per_call=2)
    _, tloss = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    np.testing.assert_allclose(packed.params.numpy(), fn.plan.pack(twin).params.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(tloss), rtol=1e-5)


def test_the_plans_penalty_and_the_argument_structs():
    """The leaves ``extract_weights`` picks (the Dense weights by ``"w"``, a
    literal key otherwise), their count, ``agg``'s factor on the loss scale,
    and the fields kernels 2 and 3 read."""
    *_, tm, _ = setup_wide()
    fn = et.make_fused_wide_epoch(tm, OPT, _ll(et, "mean", scale=0.25))
    plan, l2 = fn.plan, fn.plan.l2
    names = [plan.segments[i][0] for i in l2.leaves]
    assert names == [n for n, _ in tm.named_parameters() if n.endswith(".weight")]
    assert l2.count == sum(p.numel() for p in et.extract_weights(tm))
    assert l2.ex_outer == 0.5 and plan.agg_scale == 0.5
    assert l2.value_scale == 0.25 / l2.count and l2.coeff == 0.5 * 2 * 0.25 / l2.count
    a = fw._Args.from_buffer_copy(plan.args_bytes)
    assert a.l2_leaves == sum(1 << i for i in l2.leaves)
    np.testing.assert_allclose([a.l2_coeff, a.l2_value, a.l2_outer],
                               np.float32([l2.coeff, l2.value_scale, 0.5]))
    bias = et.make_fused_wide_epoch(tm, OPT, _ll(et, "sum", key="bias")).plan
    assert sorted(bias.segments[i][0] for i in bias.l2.leaves) == sorted(
        n for n, _ in tm.named_parameters() if n.endswith(".bias"))  # the norm's too
    assert bias.agg_scale == 1.0 and bias.l2.ex_outer == 1.0
    none = et.make_fused_wide_epoch(tm, OPT, _ll(et, "mean", key="nothing")).plan
    assert none.l2 is None and none.agg_scale == 0.5  # compute_loss still halves the loss
    plain = et.make_fused_epoch(setup_epoch(True)[4], OPT, et.LoggingLoss()).plan
    assert plain.l2 is None
    b = fe._Args.from_buffer_copy(plain.args_bytes)
    assert (b.l2_coeff, b.l2_value, b.l2_outer, b.l2_leaves) == (0.0, 0.0, 0.0, 0)


OPAQUE = et.LoggingLoss(extra_loss=lambda outputs, params: 0.0)


def test_the_envelopes_of_kernels_2_and_3():
    *_, tm2, _ = setup_epoch(True)
    *_, tm3, _ = setup_wide()
    for reason_fn, tm in ((fe.fused_epoch_unsupported_reason, tm2),
                          (fw.fused_wide_unsupported_reason, tm3)):
        for agg in ("sum", "mean"):
            assert reason_fn(tm, OPT, _ll(et, agg)) is None
        assert reason_fn(tm, OPT, OPAQUE) == (
            "an extra_loss other than l2_extra_loss: only the declarative weight-L2 extra loss "
            "is fused")
        # the penalty changes nothing of the other checks
        assert "agg" in reason_fn(tm, OPT, et.LoggingLoss(extra_loss=et.l2_extra_loss(),
                                                          agg=lambda xs: xs[0]))


def test_kernels_4_and_5_refuse_every_extra_loss_as_the_jax_kernels_do():
    from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
    from easyhybrid_tpu_torch.ops import fused_multisite as fm

    lstm = et.construct_hybrid_model(**wide_spec(hidden_layers={"lstm": 8}), device="cpu")
    sites = et.MultiSiteHybridModel(et.construct_hybrid_model(**wide_spec(hidden=(8,)),
                                                              device="cpu"), n_sites=4)
    for ll in (_ll(et, "sum"), OPAQUE):
        got = fl.fused_epoch_lstm_unsupported_reason(lstm, OPT, ll)
        assert got.startswith("an extra_loss") and "fused_epoch.py:515-516" in got
        got = fm.fused_multisite_unsupported_reason(sites, OPT, ll)
        assert got.startswith("an extra_loss") and "fused_multisite.py:183-184" in got

