"""Populations of an LSTM hybrid in the port: kernel 4's member axis
(``FusedLSTMEpoch.members``, behind the gate and the member self-check in
``population_train`` and ``population_cross_validate``) against the JAX
package on the CPU, and its plumbing.

The member axis's plain version (the port's fused path on CPU tensors,
``fused_lstm_members_reference``) is held against the JAX package's
populations on the same LSTM model, the JAX inits carried across, on
unshuffled runs of its XLA engine (the shuffled member rows are kernel 2's
code, held to the JAX kernel's permutations in tests/test_torch_population.py).
Tolerance ``1e-4 * max(1, |ref|)`` (``assert_population_matches``): the
engines sum in other orders and the differences compound over the steps.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.interop import export_jax_population, load_jax_population
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training import population as pop
from test_torch_population import _carry_jax_inits, _pair, assert_population_matches

SEQ = dict(input_window=6, output_window=2)
KW = dict(nepochs=4, batchsize=64, eval_every=2, seed=3, data_seed=0, sequence_kwargs=SEQ)


def _lstm_pair():
    return _pair(hidden={"lstm": 8})


# the populations held against the JAX package's XLA engine, unshuffled: each on
# kernel 4's member axis (its plain version on the CPU), under a one-pass and
# the two-pass losses
XLA_CASES = {
    "lr sweep, nseLoss, a duplicate member": dict(
        hyper={"learning_rate": [0.01, 0.003, 0.01]}, training_loss="nseLoss",
        loss_types=["nseLoss", "mse"]),
    "seed ensemble, kgeLoss": dict(hyper={"learning_rate": [0.01]}, seeds=[0, 1],
                                   training_loss="kgeLoss", loss_types=["kgeLoss", "mse"]),
    "rmsprop sweep, rmse, agg mean": dict(
        hyper={"learning_rate": [0.01, 0.003], "decay": [0.9, 0.99]}, optimizer="rmsprop",
        training_loss="rmse", agg="mean"),
}


@pytest.mark.parametrize("case", list(XLA_CASES), ids=str)
def test_member_axis_plain_version_matches_the_jax_population(monkeypatch, case):
    jm, tm = _lstm_pair()
    _carry_jax_inits(monkeypatch, jm)
    kw = dict(KW, shuffle_each_epoch=False, **XLA_CASES[case])
    want = eh.population_train(jm, eh.gen_rbq10_data(300, seed=5), **kw)
    got = et.population_train(tm, et.rbq10_columns(300, seed=5), **kw, use_kernel=True)
    assert want.epoch_path == "population_vmap"
    assert got.epoch_path == "population_vmap_fused", got.engine_reason
    assert_population_matches(tm, got, want)
    if "duplicate" in case:
        assert all(torch.equal(v[0], v[2]) for v in got.params.values())


def test_member_axis_cross_validation_matches_the_jax_population(monkeypatch):
    loss = "pearsonLoss"
    jm, tm = _lstm_pair()
    _carry_jax_inits(monkeypatch, jm)
    kw = dict(k=3, optimizer=("adam", 0.01), nepochs=4, batchsize=64, eval_every=2, seed=2,
              data_seed=0, shuffle_each_epoch=False, sequence_kwargs=SEQ, training_loss=loss,
              loss_types=[loss, "mse"])
    want = eh.population_cross_validate(jm, eh.gen_rbq10_data(300, seed=9), **kw)
    got = et.population_cross_validate(tm, et.rbq10_columns(300, seed=9), **kw, use_kernel=True)
    assert want.epoch_path == "population_vmap_cv"
    assert got.epoch_path == "population_vmap_cv_fused", got.engine_reason
    assert_population_matches(tm, got, want)
    np.testing.assert_array_equal(got.seeds, [1, 2, 3])


# ---------------------------------------------------------------------------
# the member launch and its self-check, without a card
# ---------------------------------------------------------------------------

def _member_launch(kind, k=3):
    """A kernel-4 member launch on CPU tensors: k members of LSTM(8) on
    6-step windows (output window 2, 10% NaN targets), batch 64, 2 epochs;
    a learning-rate sweep with one permutation, a seed ensemble with a
    permutation each, or folds with a fold's windows and norm each."""
    _, tm = _lstm_pair()
    cols = et.rbq10_columns(400, seed=4, nan_frac=0.1)
    loss = {"sweep": "nseLoss", "ensemble": "kgeLoss", "folds": "rmse"}[kind]
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    fn = et.make_fused_lstm_epoch(tm, ("adam", 0.01), ll, shuffle=True, epochs_per_call=2)
    windows = et.split_data(cols, tm, sequence_kwargs=SEQ)[0]
    folds = kind == "folds"
    splits = ([windows.take(np.arange(i, windows.n_samples, k)[: windows.n_samples // k])
               for i in range(k)] if folds else [windows])
    inits = [pop.init_member_params(tm, 0 if kind == "sweep" else s) for s in range(k)]
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = []
    for i in range(k):
        et.fit_input_norm(tm, splits[i % len(splits)])
        buffers.append({n: b.detach().clone() for n, b in tm.named_buffers()})
    buffers = {n: torch.stack([b[n] for b in buffers]) for n in buffers[0]}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(tm), params, buffers)
    opt = pop._stacked_opt_state(packed, ("adam", 0.01), k)
    tensors = [tepoch.epoch_tensors_to(et.build_epoch_tensors(s, 64), "cpu") for s in splits]
    data = fn.member_data(tensors if folds else tensors[0])
    rows = fn.member_rows(data, k, per_member_data=folds, generator=torch.Generator().manual_seed(1),
                          shared_perms=kind == "sweep")
    specs = ([("adam", {"learning_rate": lr}) for lr in (0.003, 0.03, 0.003)]
             if kind == "sweep" else None)
    return tm, fn, packed, opt, tensors, data, rows, specs


@pytest.mark.parametrize("kind", ["sweep", "ensemble", "folds"])
def test_members_equal_their_launches_alone(kind):
    """Each member of a member call equals its call alone (K = 1, its spec,
    rows and windows) bit for bit, and the member self-check passes."""
    tm, fn, packed, opt, tensors, data, rows, specs = _member_launch(kind)
    got = fn.members(packed, opt, data, rows, specs=specs)
    assert got[0].params.shape == packed.params.shape and got[2].shape == (3,)
    for i in range(3):
        p, o, loss = fn.alone(fe.FusedParams(packed.params[i], packed.bn[i]),
                              {k: v[i] for k, v in opt.items()}, data,
                              rows[i] if rows.dim() == 3 else rows,
                              None if specs is None else specs[i])
        assert torch.equal(p.params, got[0].params[i]) and torch.equal(p.bn, got[0].bn[i])
        assert all(torch.equal(o[k], got[1][k][i]) for k in o)
        assert torch.equal(loss[0], got[2][i])
    assert not torch.equal(got[0].params[0], got[0].params[1])
    if kind == "sweep":
        assert torch.equal(got[0].params[0], got[0].params[2])  # the duplicate
    assert pop.member_selfcheck(fn, packed, opt, tensors if kind == "folds" else tensors[0],
                                specs=specs, per_member_data=kind == "folds",
                                shared_perms=kind == "sweep") is None


def test_the_launch_arguments_carry_the_member_axis():
    """Kernel 4's argument struct for a member launch: the member count, the
    row index's epoch stride and member stride, the members' optimizer rows;
    a fold's windows after the folds before it; shapes the kernel does not
    read raise."""
    tm, fn, packed, opt, tensors, data, rows, _ = _member_launch("folds")
    plan = fn.plan
    n = tensors[0].weight.numel()
    assert data.x.shape[0] == 3 * n and data.x.shape[1:] == (6, 2) and data.y[0].shape == (3 * n, 2)
    member_opt = fe.member_opt_rows(plan, [("adam", {"learning_rate": lr})
                                           for lr in (0.01, 0.02, 0.03)])
    loss = torch.zeros(3)
    a = fl.launch_args(plan, packed, opt, data, rows, loss, member_opt=member_opt)
    assert (a.n_members, a.n_rows, a.n_epochs, a.perm_stride) == (3, n, 2, 2 * n)
    assert a.member_opt == member_opt.data_ptr() and a.params == packed.params.data_ptr()
    assert rows.shape == (3, 2, n) and int(rows[2].min()) >= 2 * n and int(rows[0].max()) < n
    one = fl.launch_args(plan, fe.FusedParams(packed.params[0], packed.bn[0]),
                         {k: v[0] for k, v in opt.items()}, data, rows[0], torch.zeros(1))
    assert (one.n_members, one.perm_stride, one.member_opt, one.n_rows) == (1, 0, None, n)
    with pytest.raises(ValueError, match="row index"):
        fl.launch_args(plan, packed, opt, data, rows[:2], loss)
    with pytest.raises(ValueError, match="loss"):
        fl.launch_args(plan, packed, opt, data, rows, torch.zeros(1))
    with pytest.raises(ValueError, match="optimizer rows"):
        fl.launch_args(plan, packed, opt, data, rows, loss, member_opt=member_opt[:2])


# ---------------------------------------------------------------------------
# the engine choice
# ---------------------------------------------------------------------------

def _quick_lstm():
    _, tm = _pair(hidden={"lstm": 8})
    return tm


def test_the_engine_reason_and_a_corrupted_member(monkeypatch):
    """The gate and the self-check name themselves in ``engine_reason``;
    under ``use_kernel=True`` a member the self-check finds apart from its
    launch alone raises."""
    cols = et.rbq10_columns(300, seed=6)
    kw = dict(hyper={"learning_rate": [0.01, 0.003]}, nepochs=2, batchsize=64, eval_every=2,
              sequence_kwargs=SEQ, training_loss="pearsonLoss", use_kernel=True)
    monkeypatch.setattr(pop, "_VERDICTS", {})
    r = et.population_train(_quick_lstm(), cols, **kw)
    assert r.epoch_path == "population_vmap_fused"
    assert r.engine_reason.startswith("exactness gate (max grad diff")
    assert r.engine_reason.endswith("+ member self-check passed")
    assert r.kernel_launches == 0  # the plain version on the CPU launches nothing
    real = fl.FusedLSTMEpoch.members

    def corrupted(self, packed, *a, **k):
        p, o, loss = real(self, packed, *a, **k)
        p.params[1] += 1e-3
        return p, o, loss

    monkeypatch.setattr(pop, "_VERDICTS", {})
    monkeypatch.setattr(fl.FusedLSTMEpoch, "members", corrupted)
    with pytest.raises(RuntimeError, match="kernel 4's member axis was refused: member self-check "
                                           "failed: member 1 differs in params"):
        et.population_train(_quick_lstm(), cols, **kw)


def test_a_wide_mlp_population_still_names_kernel_3s_missing_axis():
    """Kernel 3's member axis is ported: a wide MLP's population takes it
    (its plain version on the CPU), behind the gate and the self-check; only
    kernel 4's split form is left to queue B item 5 (``_MEMBER_AXES``)."""
    _, tm = _pair(hidden=[80])
    r = et.population_train(tm, et.rbq10_columns(300, seed=2), hyper={"learning_rate": [0.01]},
                            nepochs=2, batchsize=64, eval_every=2, use_kernel=True)
    assert r.epoch_path == "population_vmap_fused", r.engine_reason
    assert r.engine_reason.endswith("+ member self-check passed")
    assert pop._MEMBER_AXES["cuda_fused_wide"] == "kernel 3"
    assert "cuda_fused_lstm_split" not in pop._MEMBER_AXES


def test_tune_reaches_kernel_4_under_a_two_pass_loss():
    """``tune``'s drivers train each trial through ``train()``: an LSTM grid
    under kgeLoss takes kernel 4 (its plain version on the CPU) in every
    trial, with no change of their own."""
    best, trials = et.grid_search(
        _quick_lstm(), et.rbq10_columns(300, seed=7),
        {"optimizer": [("adam", 0.01), ("adam", 0.003)]}, nepochs=2, batchsize=64,
        training_loss="kgeLoss", sequence_kwargs=SEQ, show_progress=False, use_kernel=True)
    assert len(trials) == 2 and best in [ov for ov, _ in trials]
    assert all(r.epoch_path == "cuda_fused_lstm" for _, r in trials)
    assert all(np.isfinite(r.best_loss) for _, r in trials)


def test_stacked_lstm_trees_cross_between_the_packages():
    """The LSTM leaves (``wi``, ``wh``, the bias, the head) of a stacked JAX
    population load into the port's layout and export back unchanged."""
    jm, tm = _lstm_pair()
    keys = jax.numpy.stack([jax.random.PRNGKey(s) for s in (0, 1, 2)])
    params = jax.vmap(lambda k: jm.init(k)[0])(keys)
    _, state = jm.init(jax.random.PRNGKey(0))
    state = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (3,) + np.shape(a)), state)
    p, b = load_jax_population(tm, jax.tree.map(np.asarray, params), state)
    assert {"nn.wi", "nn.wh", "nn.b", "nn.head.weight"} <= set(p)
    assert p["nn.wi"].shape == (3,) + tuple(tm.nn.wi.shape)
    tree, st = export_jax_population(tm, p, b)
    for a, want in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(want))
    twin = copy.deepcopy(tm)
    et.load_jax_params(twin, jax.tree.map(lambda a: np.asarray(a)[2], params),
                       jax.tree.map(lambda a: np.asarray(a)[2], state))
    for n, t in twin.named_parameters():
        assert torch.equal(t, p[n][2])
