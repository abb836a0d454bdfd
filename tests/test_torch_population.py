"""Population training in the port (``population_train``,
``population_cross_validate``, kernel 2's member axis) against the JAX
package, on the CPU.

Both packages start from the same member parameters: the port's member
initializer (``population.init_member_params``) is swapped for one that
carries the JAX package's ``model.init`` of each seed across. The torch
engine is held against the JAX package's XLA engine on unshuffled runs; the
member axis's plain version (the port's fused path on CPU tensors) against
the JAX package's vmapped fused kernel in interpret mode (``EASYHYBRID_PALLAS=1``
set with ``monkeypatch``, as tests/test_population.py runs it), the JAX
permutations fed to the port's. Tolerance ``1e-4 * max(1, |ref|)``: the two
engines sum in other orders and the differences compound over the steps.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu_torch.interop import export_jax_population, load_jax_population
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.training import deferred
from easyhybrid_tpu_torch.training import population as pop
from easyhybrid_tpu_torch.training.optimizers import hyper_scalars, resolve_optimizer

TOL = 1e-4


def _rbq10(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def _spec(hidden=(8,), norm="static", **kw):
    spec = dict(predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
                parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
                neural_param_names=["rb"], global_param_names=["Q10"],
                hidden_layers=hidden, activation="swish", scale_nn_outputs=True,
                input_batchnorm=norm)
    spec.update(kw)
    return spec


def _pair(**kw):
    spec = _spec(**kw)
    jm = eh.construct_hybrid_model(mechanistic_model=_rbq10, **spec)
    tm = et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu", **spec)
    return jm, tm


def _carry_jax_inits(monkeypatch, jm):
    """The port's members start from the JAX package's ``model.init`` of
    their seeds."""
    def init(model, seed):
        params, state = jm.init(jax.random.PRNGKey(int(seed)))
        twin = copy.deepcopy(model)
        et.load_jax_params(twin, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
        return {k: p.detach().clone() for k, p in twin.named_parameters()}

    monkeypatch.setattr(pop, "init_member_params", init)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.size:
        over = np.abs(got - want) - TOL * np.maximum(1.0, np.abs(want))
        assert over.max() <= 0.0, (f"{what}: {np.abs(got - want).max():.3e} beyond {TOL} x "
                                   "max(1, |ref|)")


def assert_population_matches(tm, got, want, *, state=True):
    """Histories, best losses, final and best parameters (and the state)
    within TOL; best epochs and the best member equal."""
    assert set(got.train_history) == set(want.train_history)
    for k in want.train_history:
        _close(got.train_history[k], want.train_history[k], f"train {k}")
        _close(got.val_history[k], want.val_history[k], f"val {k}")
    _close(got.best_losses, want.best_losses, "best_losses")
    np.testing.assert_array_equal(got.best_epochs, np.asarray(want.best_epochs))
    assert got.best_member == want.best_member and got.monitor == want.monitor
    np.testing.assert_array_equal(got.epochs, want.epochs)
    for mine, theirs, what in ((got.params, want.params, "params"),
                               (got.best_params, want.best_params, "best_params")):
        tree, _ = export_jax_population(tm, mine, got.state)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree.leaves(theirs)):
            _close(a, np.asarray(b), f"{what} {jax.tree_util.keystr(path)}")
    if state:
        _, tree = export_jax_population(tm, got.params, got.state)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want.state)):
            _close(a, np.asarray(b), "state")


KW = dict(nepochs=6, batchsize=64, eval_every=3, seed=3, data_seed=0, shuffle_each_epoch=False)

# the torch engine against the JAX package's XLA engine, unshuffled
TORCH_CASES = {
    "lr sweep": dict(hyper={"learning_rate": [0.01, 0.002, 0.05]}, optimizer="adam"),
    "seed ensemble": dict(hyper={"learning_rate": [0.01]}, seeds=[0, 1, 2], optimizer="adam"),
    "multi-hyper sweep with static_hyper": dict(
        hyper={"learning_rate": [0.02, 0.005], "b1": [0.9, 0.8]}, static_hyper={"b2": 0.99},
        optimizer="adam"),
    "rmsprop decay sweep, loss types r2 and mse": dict(
        hyper={"learning_rate": [0.01, 0.003], "decay": [0.9, 0.99]}, optimizer="rmsprop",
        loss_types=("r2", "mse")),
}


@pytest.mark.parametrize("case", list(TORCH_CASES), ids=str)
def test_torch_engine_matches_the_jax_xla_engine(monkeypatch, case):
    jm, tm = _pair()
    cols = et.rbq10_columns(400, seed=7)
    _carry_jax_inits(monkeypatch, jm)
    want = eh.population_train(jm, eh.gen_rbq10_data(400, seed=7), **KW, **TORCH_CASES[case])
    got = et.population_train(tm, cols, **KW, **TORCH_CASES[case])
    assert want.epoch_path == "population_vmap" and got.epoch_path == "population_vmap"
    assert "the model is on 'cpu', not cuda" in got.engine_reason
    assert_population_matches(tm, got, want)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert set(got.hyper) == set(want.hyper)


def test_torch_engine_cross_validation_matches_jax(monkeypatch):
    jm, tm = _pair()
    _carry_jax_inits(monkeypatch, jm)
    kw = dict(k=3, optimizer=("adam", 0.01), nepochs=4, batchsize=64, eval_every=2, seed=2,
              data_seed=0, shuffle_each_epoch=False)
    want = eh.population_cross_validate(jm, eh.gen_rbq10_data(350, seed=9), **kw)
    got = et.population_cross_validate(tm, et.rbq10_columns(350, seed=9), **kw)
    assert want.epoch_path == "population_vmap_cv" and got.epoch_path == "population_vmap_cv"
    assert_population_matches(tm, got, want)
    np.testing.assert_array_equal(got.seeds, [1, 2, 3])


@pytest.mark.parametrize("kind", ["multinn", "lstm", "multisite"])
def test_torch_engine_on_other_models_matches_jax(monkeypatch, kind):
    """MultiNN (ExpoHybrid) on the torch engine, an LSTM hybrid on windows
    on kernel 4's member axis and a share_nn multi-site seed ensemble on
    kernel 5's (their plain versions on the CPU): JAX's history shapes, and
    parity with the JAX package's XLA engine on unshuffled runs."""
    kw = dict(nepochs=4, batchsize=64, eval_every=2, seed=1, data_seed=0,
              shuffle_each_epoch=False)
    if kind == "multinn":
        def expo_jax(*, ta, rb, k):
            return {"reco": rb * jax.numpy.exp(k * ta)}

        def expo_torch(*, ta, rb, k):
            return {"reco": rb * torch.exp(k * ta)}

        spec = _spec(predictors={"rb": ["sw_pot"], "k": ["dsw_pot"]},
                     parameters={"rb": (2.0, 0.0, 8.0), "k": (0.05, 0.0, 0.2)},
                     neural_param_names=None, global_param_names=[])
        jm = eh.construct_hybrid_model(mechanistic_model=expo_jax, **spec)
        tm = et.construct_hybrid_model(mechanistic_model=expo_torch, device="cpu", **spec)
        data = dict(hyper={"learning_rate": [0.01, 0.003]}, optimizer="adamw")
        rows = 400
    elif kind == "lstm":
        jm, tm = _pair(hidden={"lstm": 8})
        data = dict(hyper={"learning_rate": [0.01, 0.003]},
                    sequence_kwargs=dict(input_window=6, output_window=2))
        rows = 500
    else:
        jb, tb = _pair()
        jm = eh.MultiSiteHybridModel(jb, n_sites=16, share_nn=True)
        tm = et.MultiSiteHybridModel(tb, n_sites=16, share_nn=True, device="cpu")
        data = dict(seeds=[0, 1, 2], optimizer="adam", split_data_at=0.75)
        kw.update(batchsize=16, eval_every=1, nepochs=3)
        rows = 16 * 10
    cols = et.rbq10_columns(rows, seed=3)
    df = eh.gen_rbq10_data(rows, seed=3)
    if kind == "multisite":
        from easyhybrid_tpu.parallel.multisite import prepare_multisite_data

        df["site"] = np.repeat(np.arange(16), 10)
        cols["site"] = np.repeat(np.arange(16), 10)
        jdata = prepare_multisite_data(jb, df, "site")
        tdata = et.prepare_multisite_data(tb, cols, "site")
    else:
        jdata, tdata = df, cols
    _carry_jax_inits(monkeypatch, jm)
    want = eh.population_train(jm, jdata, **kw, **data)
    got = et.population_train(tm, tdata, **kw, **data, use_kernel=kind != "multinn")
    if kind == "multisite":
        assert got.epoch_path == "population_vmap_fused"
        assert got.engine_reason.startswith("multisite kernel: exactness gate")
    elif kind == "lstm":
        assert got.epoch_path == "population_vmap_fused"
        assert got.engine_reason.startswith("exactness gate") and "member self-check passed" in \
            got.engine_reason
    else:
        assert got.epoch_path == "population_vmap"
    assert np.isfinite(got.best_losses).all()
    assert got.val_history["mse"].shape == want.val_history["mse"].shape
    assert_population_matches(tm, got, want)
    if kind == "multisite":
        assert got.params["globals.Q10"].shape == (3, 16, 1)


# ---------------------------------------------------------------------------
# kernel 2's member axis: the plain version against the JAX fused kernel
# ---------------------------------------------------------------------------

def _jax_block_perms(seed, n_evals, members, epochs, n, shared):
    """The permutations the JAX population loop gives its members' fused
    epochs, block by block: ``[(E, n)]`` shared or ``[(K, E, n)]``."""
    key = jax.random.PRNGKey(int(seed))
    if shared:
        keys = [[k] * members for k in jax.random.split(key, n_evals)]
    else:
        flat = jax.random.split(key, n_evals * members)
        keys = [list(flat[i * members:(i + 1) * members]) for i in range(n_evals)]

    def perms(k):
        ks = [k] if epochs == 1 else list(jax.random.split(k, epochs))
        return np.stack([np.asarray(jax_permutation(e, n)) for e in ks])

    out = [np.stack([perms(k) for k in block]) for block in keys]
    return [torch.from_numpy(o[0] if shared else o).long() for o in out]


def _feed_jax_perms(monkeypatch, blocks):
    """The port's member rows for each block from the JAX permutations
    (explicit permutations, as the self-check passes, go through)."""
    real = fe.FusedEpoch.member_rows
    queue = list(blocks)

    def member_rows(self, data, k, *, per_member_data, perms=None, generator=None,
                    shared_perms=True):
        if perms is None:
            perms = queue.pop(0)
        return real(self, data, k, per_member_data=per_member_data, perms=perms,
                    generator=generator, shared_perms=shared_perms)

    monkeypatch.setattr(fe.FusedEpoch, "member_rows", member_rows)
    return queue


@pytest.mark.parametrize("kind", ["sweep", "ensemble", "cross-validation"])
def test_member_axis_plain_version_matches_the_jax_fused_kernel(monkeypatch, kind):
    """The port's fused path on CPU tensors (the member axis's plain version,
    behind the gate and the self-check) against the JAX package's vmapped
    kernel in interpret mode, 300 rows, 2 blocks, shuffled: a sweep (one
    permutation shared), an ensemble (a permutation each), 2 folds (a fold's
    data each)."""
    monkeypatch.setenv("EASYHYBRID_PALLAS", "1")
    monkeypatch.setenv("EASYHYBRID_GATE_CACHE", "0")
    jm, tm = _pair()
    df, cols = eh.gen_rbq10_data(300, seed=3), et.rbq10_columns(300, seed=3)
    kw = dict(nepochs=4, batchsize=64, eval_every=2, seed=2, data_seed=0)
    _carry_jax_inits(monkeypatch, jm)
    if kind == "cross-validation":
        kw.update(k=2, optimizer=("adam", 0.01))
        want = eh.population_cross_validate(jm, df, **kw)
        n_train = max(np.sum(et.make_folds(range(300), k=2, seed=0) != i) for i in (1, 2))
        members, shared = 2, False
    else:
        kw.update(hyper={"learning_rate": [0.02, 0.02, 0.005]} if kind == "sweep"
                  else {"learning_rate": [0.01]})
        if kind == "ensemble":
            kw["seeds"] = [0, 1]
        want = eh.population_train(jm, df, **kw)
        n_train, members, shared = 240, (3 if kind == "sweep" else 2), kind == "sweep"
    assert want.epoch_path.endswith("_fused"), want.engine_reason
    n = -(-n_train // 64) * 64
    _feed_jax_perms(monkeypatch, _jax_block_perms(2, 2, members, 2, n, shared))
    run = et.population_cross_validate if kind == "cross-validation" else et.population_train
    got = run(tm, cols, **kw, use_kernel=True)
    assert got.epoch_path == want.epoch_path, got.engine_reason
    assert "member self-check passed" in got.engine_reason
    assert_population_matches(tm, got, want)
    if kind == "sweep":  # duplicate members: equal bits
        assert all(torch.equal(v[0], v[1]) for v in got.params.values())


# ---------------------------------------------------------------------------
# semantics
# ---------------------------------------------------------------------------

def _quick(norm="static"):
    return et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu",
                                     generator=torch.Generator().manual_seed(0),
                                     **_spec(norm=norm))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_a_sweep_shares_its_permutations_and_an_ensemble_does_not(use_kernel):
    cols = et.rbq10_columns(400, seed=1)
    kw = dict(optimizer="adam", nepochs=4, batchsize=64, eval_every=2, seed=3, data_seed=0,
              use_kernel=use_kernel)
    sweep = et.population_train(_quick(), cols, hyper={"learning_rate": [0.01, 0.01, 0.002]}, **kw)
    assert all(torch.equal(v[0], v[1]) for v in sweep.params.values())
    assert not torch.equal(sweep.params["globals.Q10"][0], sweep.params["globals.Q10"][2])
    ens = et.population_train(_quick(), cols, seeds=[3, 3], **kw)
    assert not all(torch.equal(v[0], v[1]) for v in ens.params.values())
    assert sweep.epoch_path == ("population_vmap_fused" if use_kernel else "population_vmap")


def test_the_epoch_budget_and_best_tracking():
    cols = et.rbq10_columns(300, seed=2)
    r = et.population_train(_quick(), cols, hyper={"learning_rate": [0.02, 0.001]}, nepochs=10,
                            batchsize=64, eval_every=3)
    np.testing.assert_array_equal(r.epochs, [3, 6, 9])
    assert r.val_history["mse"].shape == (3, 2) and r.train_history["mse"].shape == (3, 2)
    assert (r.best_losses <= r.val_history["mse"].min(axis=0) + 1e-12).all()
    assert r.best_member == int(np.argmin(r.best_losses))
    for i in range(2):
        best = r.member_params(i)
        assert set(best) == {k for k, _ in _quick().named_parameters()}
        assert best["globals.Q10"].shape == (1,)
    mean, std = r.param_spread(_quick())["Q10"]
    raw_mean, _ = r.param_spread()["Q10"]
    assert 1.0 < float(mean) < 4.0 and float(std) >= 0.0 and abs(float(raw_mean) - float(mean)) > 1e-6


def test_errors_and_their_wording():
    cols, m = et.rbq10_columns(200, seed=0), _quick()
    with pytest.raises(ValueError, match="counts disagree"):
        et.population_train(m, cols, hyper={"learning_rate": [0.1, 0.2]}, seeds=[0, 1, 2])
    with pytest.raises(ValueError, match="maximize"):
        et.population_train(m, cols, hyper={"learning_rate": [0.1]}, training_loss="r2")
    with pytest.raises(ValueError, match="unknown optimizer"):
        et.population_train(m, cols, optimizer="nope")
    with pytest.raises(ValueError, match="no eval block fits the budget"):
        et.population_train(m, cols, nepochs=2, eval_every=3)
    with pytest.raises(ValueError, match="needs k >= 2"):
        et.population_cross_validate(m, cols, k=1)
    with pytest.raises(NotImplementedError, match="item 15"):
        et.population_train(m, cols, mesh=object())
    with pytest.raises(NotImplementedError, match="item 15"):
        et.population_cross_validate(m, cols, mesh=object())
    with pytest.raises(TypeError, match="learning_rate"):
        et.population_train(m, cols, hyper={"b1": [0.9, 0.8]})


def test_use_kernel_and_the_engine_reasons(monkeypatch):
    cols = et.rbq10_columns(300, seed=4)
    kw = dict(nepochs=2, batchsize=64, eval_every=2)
    r = et.population_train(_quick(), cols, use_kernel=False, **kw)
    assert (r.epoch_path, r.engine_reason) == ("population_vmap",
                                               "use_kernel disabled (use_kernel=False)")
    r = et.population_train(_quick(), cols, **kw)
    assert r.engine_reason == "the model is on 'cpu', not cuda (use_kernel=True overrides)"
    r = et.population_train(_quick(), cols, optimizer="radam", use_kernel=True, **kw,
                            hyper={"learning_rate": [0.01, 0.01], "threshold": [5.0, 3.0]})
    assert r.epoch_path == "population_vmap"
    assert r.engine_reason.startswith("a sweep member's hyperparameters fall outside the fused "
                                      "kernel envelope: radam with threshold 3.0 < 4")
    r = et.population_train(_quick(), cols, agg="mean", use_kernel=True, **kw)
    assert r.epoch_path == "population_vmap_fused"
    assert r.engine_reason.startswith("exactness gate (max grad diff")
    assert r.kernel_launches == 0  # the plain version on the CPU launches nothing
    # use_kernel=True: a failed self-check or gate raises (under "auto", on the card, the
    # torch engine runs with the reason: tests/test_torch_cuda.py)
    monkeypatch.setattr(pop, "_VERDICTS", {})
    monkeypatch.setattr(pop, "member_selfcheck", lambda *a, **k: "member 2 differs in m")
    with pytest.raises(RuntimeError, match="member self-check failed: member 2 differs in m"):
        et.population_train(_quick(), cols, use_kernel=True, **kw)
    monkeypatch.setattr(pop, "_VERDICTS", {})
    monkeypatch.setattr(fe, "fused_exactness_check", lambda *a, **k: (False, 0.5))
    with pytest.raises(RuntimeError, match=r"runtime exactness gate FAILED \(max grad diff 5"):
        et.population_train(_quick(), cols, use_kernel=True, **kw)
    cv = et.population_cross_validate(_quick(), cols, k=2, use_kernel=False, **kw)
    assert cv.epoch_path == "population_vmap_cv"


def test_the_gate_and_self_check_run_once_per_configuration(monkeypatch):
    monkeypatch.setattr(pop, "_VERDICTS", {})
    calls = []
    real = pop.member_selfcheck

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pop, "member_selfcheck", counted)
    cols = et.rbq10_columns(300, seed=5)
    kw = dict(hyper={"learning_rate": [0.01, 0.003]}, nepochs=2, batchsize=64, eval_every=2,
              use_kernel=True)
    a = et.population_train(_quick(), cols, **kw)
    b = et.population_train(_quick(), cols, **kw)
    assert len(calls) == 1 and a.engine_reason == b.engine_reason
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_no_host_read_in_the_population_loop(monkeypatch, use_kernel):
    """Every ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
    ``bool()`` / ``float()`` / ``int()`` of a tensor between the first block
    and the final fetch is counted, as tests/test_torch_deferred.py counts
    them in ``train()``'s deferred loop."""
    calls, state = [], {"window": False}
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            if state["window"]:
                calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    real_window = deferred._sync_debug

    class Window:
        def __init__(self, device):
            self.inner = real_window(device)

        def __enter__(self):
            state["window"] = True
            return self.inner.__enter__()

        def __exit__(self, *exc):
            state["window"] = False
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(deferred, "_sync_debug", Window)
    cols = et.rbq10_columns(300, seed=6)
    for seeds in (None, [0, 1]):
        r = et.population_train(_quick(True), cols, hyper={"learning_rate": [0.01, 0.003]},
                                seeds=seeds, nepochs=4, batchsize=64, eval_every=2,
                                use_kernel=use_kernel)
        assert np.isfinite(r.best_losses).all()
        assert r.epoch_path == ("population_vmap_fused" if use_kernel else "population_vmap")
    et.population_cross_validate(_quick(), cols, k=2, nepochs=2, batchsize=64, eval_every=2,
                                 use_kernel=use_kernel)
    assert calls == []


def test_a_trainable_norm_steps_member_by_member_and_matches_the_plain_member_axis():
    """The torch engine loops over members for a trainable BatchNorm (its
    running statistics move in place); it agrees with the member axis's
    plain version on the same run."""
    cols = et.rbq10_columns(300, seed=8)
    kw = dict(seeds=[0, 1], nepochs=4, batchsize=64, eval_every=2, shuffle_each_epoch=False)
    a = et.population_train(_quick(True), cols, use_kernel=False, **kw)
    b = et.population_train(_quick(True), cols, use_kernel=True, **kw)
    assert (a.epoch_path, b.epoch_path) == ("population_vmap", "population_vmap_fused")
    for k in a.params:
        np.testing.assert_allclose(a.params[k].numpy(), b.params[k].numpy(), rtol=1e-4, atol=1e-5)
    for k in a.state:
        np.testing.assert_allclose(a.state[k].numpy(), b.state[k].numpy(), rtol=1e-4, atol=1e-5)
    assert not torch.equal(a.state["nn.norm.mean"][0], torch.zeros(2))


# ---------------------------------------------------------------------------
# member-axis plumbing without a card
# ---------------------------------------------------------------------------

RULE_SPECS = [("adam", 0.01), ("adamw", 0.02), ("sgd", 0.05), ("sgd", 0.05, 0.9),
              ("sgd", 0.05, 0.9, 1.0), ("rmsprop", 0.01), ("adagrad", 0.05), ("lion", 0.001),
              ("adamax", 0.01), ("nadam", 0.01), ("adadelta", 1.0), ("radam", 0.01),
              ("amsgrad", 0.01), ("lamb", 0.01)]


@pytest.mark.parametrize("spec", RULE_SPECS, ids=str)
def test_member_rows_are_the_shared_structs_floats(spec):
    tm = _quick()
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    plan = fe.plan_fused_epoch(tm, spec, ll)
    name = spec[0]
    other = (name, {**dict(resolve_optimizer(spec).hyperparameters), "learning_rate": 0.123})
    rows = fe.member_opt_rows(plan, [spec, other])
    assert rows.dtype == torch.float32 and tuple(rows.shape) == (2, len(fe.OPT_SCALARS))
    for i, s in enumerate((spec, other)):
        o = fe.optimizer_struct(fe.member_plan(plan, s))
        want = np.array([getattr(o, f) for f in fe.OPT_SCALARS], np.float32)
        np.testing.assert_array_equal(rows[i].numpy(), want)
    assert rows[1, 0] == np.float32(0.123)


def test_the_tensor_form_of_every_rule_gives_the_float_forms_bits():
    g = torch.Generator().manual_seed(0)
    for spec in RULE_SPECS:
        opt = resolve_optimizer(spec)
        params = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
        s1, s2 = opt.init(params), opt.init(params)
        numbers = {k: (torch.tensor(v, dtype=torch.float32) if isinstance(v, float) and k != "nesterov"
                       else v) for k, v in hyper_scalars(opt.name, opt.hyperparameters).items()}
        for _ in range(6):
            grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
            u1, s1 = opt.update(grads, s1, params)
            u2, s2 = opt.update(grads, s2, params, scalars=numbers)
            for k in u1:
                assert torch.equal(u1[k], u2[k]), (spec, k)


def test_the_launch_arguments_carry_the_member_axis():
    tm = _quick(True)
    ll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    fn = et.make_fused_epoch(tm, ("amsgrad", 0.01), ll, epochs_per_call=2)
    plan = fn.plan
    data = et.prepare_data(tm, et.rbq10_columns(300, seed=0))
    tensors = [et.build_epoch_tensors(data.take(np.arange(i, 300, 2)), 64) for i in (0, 1)]
    from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to

    tensors = [epoch_tensors_to(t, "cpu") for t in tensors]
    k = 3
    params = {n: p.detach().expand((k,) + tuple(p.shape)).clone() for n, p in tm.named_parameters()}
    buffers = {n: b.detach().expand((k,) + tuple(b.shape)).clone() for n, b in tm.named_buffers()}
    packed = pop._pack_members(plan, pop._norm_buffer_names(tm), params, buffers)
    opt = pop._stacked_opt_state(packed, ("amsgrad", 0.01), k)
    assert tuple(packed.params.shape) == (k, plan.n_params) and tuple(packed.bn.shape) == (k, 4)
    assert tuple(opt["t"].shape) == (k, 1) and "u" in opt
    shared = fn.member_data(tensors[0])
    n = shared.n_batches * shared.batch
    gen = torch.Generator().manual_seed(0)
    rows = fn.member_rows(shared, k, per_member_data=False, generator=gen)
    assert tuple(rows.shape) == (2, n) and rows.dtype == torch.int32
    own = fn.member_rows(shared, k, per_member_data=False, generator=gen, shared_perms=False)
    assert tuple(own.shape) == (k, 2, n) and not torch.equal(own[0], own[1])
    loss = torch.zeros(k)
    member_opt = fe.member_opt_rows(plan, [("amsgrad", 0.01), ("amsgrad", 0.02), ("amsgrad", 0.03)])
    a = fe.launch_args(plan, packed, opt, shared, own, loss, member_opt=member_opt)
    assert (a.n_members, a.n_rows, a.n_epochs, a.perm_stride) == (k, n, 2, 2 * n)
    assert a.member_opt == member_opt.data_ptr() and a.consts == plan.consts.data_ptr()
    assert a.params == packed.params.data_ptr() and a.u == opt["u"].data_ptr()
    a = fe.launch_args(plan, packed, opt, shared, rows, loss)
    assert (a.perm_stride, a.member_opt) == (0, None)
    # per-member data: each fold's rows after the folds before it
    folds = fn.member_data([tensors[0], tensors[1], tensors[0]])
    assert folds.x.shape[0] == 3 * n
    per = fn.member_rows(folds, k, per_member_data=True, perms=own.long())
    assert torch.equal(per[1] - n, own[1]) and torch.equal(per[2] - 2 * n, own[2])
    one = fe.launch_args(plan, fe.FusedParams(packed.params[0], packed.bn[0]),
                         {kk: v[0] for kk, v in opt.items()}, shared, rows, torch.zeros(1))
    assert (one.n_members, one.perm_stride, one.member_opt) == (1, 0, None)
    with pytest.raises(ValueError, match="row index"):
        fe.launch_args(plan, packed, opt, shared, own[:2], loss)
    with pytest.raises(ValueError, match="loss"):
        fe.launch_args(plan, packed, opt, shared, rows, torch.zeros(1))
    with pytest.raises(ValueError, match="optimizer rows"):
        fe.launch_args(plan, packed, opt, shared, rows, loss, member_opt=member_opt[:2])


def test_the_ctypes_mirror_of_the_member_fields():
    import ctypes
    import re
    from pathlib import Path

    src = (Path(fe.__file__).resolve().parent.parent / "csrc" / "fused_epoch.cu").read_text()
    defines = dict(re.findall(r"#define (EHE_OPT_\w+) (\d+)", src))
    assert int(defines["EHE_OPT_SCALARS"]) == len(fe.OPT_SCALARS) == 13
    assert int(defines["EHE_OPT_WORDS"]) == fe._OPT_WORDS == ctypes.sizeof(fe._Optimizer) // 4
    assert fe.OPT_SCALARS[0] == "lr" and fe.OPT_SCALARS[-1] == "rect_den"
    first = fe._Optimizer.lr.offset // 4
    assert int(defines["EHE_OPT_FIRST"]) == first
    assert fe._Optimizer.rect_den.offset // 4 == first + len(fe.OPT_SCALARS) - 1
    names = [n for n, _ in fe._Args._fields_]
    assert names[-3:] == ["n_members", "perm_stride", "member_opt"]
    assert fe._Args.perm_stride.offset % 8 == 0 and fe._Args.member_opt.offset % 8 == 0
    assert ctypes.sizeof(fe._Args) == fe._Args.member_opt.offset + 8


def test_stacked_trees_cross_between_the_packages():
    jm, tm = _pair()
    keys = jax.numpy.stack([jax.random.PRNGKey(s) for s in (0, 1, 2)])
    params = jax.vmap(lambda k: jm.init(k)[0])(keys)
    _, state = jm.init(jax.random.PRNGKey(0))
    state = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (3,) + np.shape(a)), state)
    p, b = load_jax_population(tm, jax.tree.map(np.asarray, params), state)
    assert set(p) == {n for n, _ in tm.named_parameters()}
    assert p["nn.layers.0.weight"].shape == (3,) + tuple(tm.nn.layers[0].weight.shape)
    tree, st = export_jax_population(tm, p, b)
    for a, want in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(want))
    for a, want in zip(jax.tree.leaves(st), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, np.asarray(want))
    twin = copy.deepcopy(tm)
    et.load_jax_params(twin, jax.tree.map(lambda a: np.asarray(a)[1], params),
                       jax.tree.map(lambda a: np.asarray(a)[1], state))
    for n, t in twin.named_parameters():
        assert torch.equal(t, p[n][1])


def test_members_draw_from_the_ports_stream():
    m = _quick()
    a = pop.init_member_params(m, 7)
    built = et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu",
                                      generator=torch.Generator().manual_seed(7), **_spec())
    assert all(torch.equal(a[n], t) for n, t in built.named_parameters())
    assert not torch.equal(pop.init_member_params(m, 8)["nn.layers.0.weight"],
                           a["nn.layers.0.weight"])
