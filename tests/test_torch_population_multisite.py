"""Seed ensembles of a multi-site model in the port: kernel 5's member axis
(``FusedMultisiteEpoch.members``, behind the gate and the member self-check
in ``population_train``) against the JAX package on the CPU, its plumbing,
the engine choices that keep a multi-site sweep or cross-validation on the
torch engine, and ``ensemble_predict``.

The member axis's plain version (the port's fused path on CPU tensors) is
held against the JAX package's vmapped multi-site kernel in interpret mode
(``EASYHYBRID_PALLAS=1`` set with ``monkeypatch`` for the JAX side, as
tests/test_population.py runs it), with the JAX package's member inits and
permutations carried across. Tolerance ``1e-4 * max(1, |ref|)`` (the one of
tests/test_torch_population.py): the two kernels sum a site's rows and the
sites' gradients in other orders, and the differences compound over the
steps. ``ensemble_predict`` is held to the JAX function within ``1e-5 *
max(1, |ref|)`` (one forward, no steps to compound).
"""

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.interop import load_jax_population
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_multisite as fm
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training import population as pop
from test_torch_population import (_carry_jax_inits, _jax_block_perms, _pair, _spec,
                                   assert_population_matches)

S, N = 256, 8


def _sites(jb, tb, n_sites=S, n_obs=N, seed=3):
    """The JAX and the port's multi-site data of the same table (one site
    every ``n_obs`` rows), as tests/test_population.py builds it."""
    from easyhybrid_tpu.parallel.multisite import prepare_multisite_data

    df = eh.gen_rbq10_data(n_sites * n_obs, seed=seed)
    cols = et.rbq10_columns(n_sites * n_obs, seed=seed)
    df["site"] = cols["site"] = np.repeat(np.arange(n_sites), n_obs)
    return prepare_multisite_data(jb, df, "site"), et.prepare_multisite_data(tb, cols, "site")


def _models(n_sites=S, **kw):
    jb, tb = _pair(**kw)
    return (jb, tb, eh.MultiSiteHybridModel(jb, n_sites=n_sites, share_nn=True),
            et.MultiSiteHybridModel(tb, n_sites=n_sites, share_nn=True, device="cpu"))


def _feed_jax_site_perms(monkeypatch, blocks):
    """Kernel 5's member rows for each block from the JAX permutations
    (explicit permutations, as the self-check passes, go through)."""
    real = fm.FusedMultisiteEpoch.member_rows
    queue = list(blocks)

    def member_rows(self, data, k, *, per_member_data=False, perms=None, generator=None,
                    shared_perms=True):
        if perms is None and not self._same_batches(data):
            perms = queue.pop(0)
        return real(self, data, k, per_member_data=per_member_data, perms=perms,
                    generator=generator, shared_perms=shared_perms)

    monkeypatch.setattr(fm.FusedMultisiteEpoch, "member_rows", member_rows)
    return queue


# population_train's settings, as tests/test_population.py:532-580 runs them
ENSEMBLE_KW = dict(seeds=[0, 1], optimizer="adam", nepochs=2, split_data_at=0.75, eval_every=1,
                   seed=4)
CASES = {
    "full-site batch": dict(batchsize=256),
    "batches of 128, shuffled": dict(batchsize=128),
    "batches of 128, unshuffled": dict(batchsize=128, shuffle_each_epoch=False),
    "rmse, batches of 128, unshuffled": dict(batchsize=128, shuffle_each_epoch=False,
                                             training_loss="rmse", loss_types=["rmse"]),
}


@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_member_axis_plain_version_matches_the_jax_multisite_kernel(monkeypatch, case):
    """256 sites x 8, seeds [0, 1], 2 blocks of one epoch: the port's
    member axis (its plain version on the CPU, behind the gate and the
    self-check) against the JAX package's vmapped multi-site kernel in
    interpret mode."""
    jb, tb, jm, tm = _models()
    jdata, tdata = _sites(jb, tb)
    kw = {**ENSEMBLE_KW, **CASES[case]}
    _carry_jax_inits(monkeypatch, jm)
    with monkeypatch.context() as jax_side:
        jax_side.setenv("EASYHYBRID_PALLAS", "1")
        jax_side.setenv("EASYHYBRID_GATE_CACHE", "0")
        want = eh.population_train(jm, jdata, **kw)
    assert want.epoch_path == "population_vmap_fused", want.engine_reason
    assert want.engine_reason.startswith("multisite kernel: ")
    n_train, batch = 192, kw["batchsize"]
    nb = -(-n_train // batch)
    shuffled = kw.get("shuffle_each_epoch", True) is True and nb > 1
    queue = _feed_jax_site_perms(monkeypatch, _jax_block_perms(4, 2, 2, 1, nb * batch, False)
                                 if shuffled else [])
    got = et.population_train(tm, tdata, **kw, use_kernel=True)
    assert got.epoch_path == "population_vmap_fused", got.engine_reason
    assert got.engine_reason.startswith("multisite kernel: exactness gate (max grad diff")
    assert got.engine_reason.endswith("member self-check passed")
    assert queue == []  # every block took its JAX permutations
    assert_population_matches(tm, got, want)
    assert got.params["globals.Q10"].shape == (2, S, 1)
    # the validation sites (the last 64) see no gradient in any member
    q10 = got.params["globals.Q10"][:, n_train:]
    assert torch.equal(q10, tm.globals.Q10.detach()[None, n_train:].expand_as(q10))


def test_member_axis_matches_the_torch_engine_with_the_ports_own_draws():
    """Without carried permutations, the member axis's plain version and the
    torch engine draw each member's site permutations from one stream in
    the same order: the same ensemble, within the tolerance."""
    jb, tb, _, tm = _models(n_sites=64)
    tdata = _sites(jb, tb, n_sites=64)[1]
    kw = dict(seeds=[3, 4, 5], nepochs=4, eval_every=2, batchsize=16, split_data_at=0.75)
    fused = et.population_train(tm, tdata, use_kernel=True, **kw)
    plain = et.population_train(tm, tdata, use_kernel=False, **kw)
    assert (fused.epoch_path, plain.epoch_path) == ("population_vmap_fused", "population_vmap")
    for k in plain.params:
        np.testing.assert_allclose(fused.params[k].numpy(), plain.params[k].numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert not torch.equal(fused.params["globals.Q10"][0], fused.params["globals.Q10"][1])


# ---------------------------------------------------------------------------
# the engine choice
# ---------------------------------------------------------------------------

def test_a_sweep_and_a_cross_validation_keep_the_torch_engine():
    """As in the JAX package: its sweep engine takes kernel 2's models only,
    and its multi-site cross-validation stays on XLA (folds re-index the
    sites)."""
    jb, tb, _, tm = _models(n_sites=32)
    tdata = _sites(jb, tb, n_sites=32)[1]
    kw = dict(nepochs=2, eval_every=2, batchsize=32, use_kernel=True)
    sweep = et.population_train(tm, tdata, hyper={"learning_rate": [0.01, 0.003]}, **kw)
    assert sweep.epoch_path == "population_vmap"
    assert sweep.engine_reason.startswith("a sweep of a multi-site model runs the torch engine")
    cv = et.population_cross_validate(tm, tdata, k=2, **kw)
    assert cv.epoch_path == "population_vmap_cv"
    assert cv.engine_reason.startswith("multi-site cross-validation runs the torch engine")
    ens = et.population_train(tm, tdata, seeds=[0, 1], **kw)
    assert ens.epoch_path == "population_vmap_fused"
    assert et.population_train(tm, tdata, seeds=[0, 1], nepochs=2, eval_every=2,
                               batchsize=32).engine_reason.startswith("the model is on 'cpu'")
    # share_nn=False is outside the kernel's envelope
    own = et.MultiSiteHybridModel(tb, n_sites=32, share_nn=False, device="cpu")
    r = et.population_train(own, tdata, seeds=[0, 1], **kw)
    assert r.epoch_path == "population_vmap" and "share_nn=False" in r.engine_reason


def test_the_verdicts_are_kept_by_engine(monkeypatch):
    """One configuration's verdict per engine: a multi-site ensemble and its
    base model's ensemble run their own gate and self-check, each once."""
    monkeypatch.setattr(pop, "_VERDICTS", {})
    calls = []
    real = pop.member_selfcheck

    def counted(fn, *a, **k):
        calls.append(type(fn).__name__)
        return real(fn, *a, **k)

    monkeypatch.setattr(pop, "member_selfcheck", counted)
    jb, tb, _, tm = _models(n_sites=32)
    tdata = _sites(jb, tb, n_sites=32)[1]
    kw = dict(seeds=[0, 1], nepochs=2, eval_every=2, batchsize=32, use_kernel=True)
    for _ in range(2):
        et.population_train(tm, tdata, **kw)
        et.population_train(tb, et.rbq10_columns(256, seed=3), **kw)
    assert calls == ["FusedMultisiteEpoch", "FusedEpoch"]
    assert sorted(key[0] for key in pop._VERDICTS) == ["cuda_fused_epoch", "cuda_fused_multisite"]
    fn = fm.make_fused_multisite_epoch(tm, ("adam", 0.01), et.LoggingLoss())
    a = pop._verdict_key("cuda_fused_multisite", fn, None, False, False, 32)
    b = pop._verdict_key("cuda_fused_epoch", fn, None, False, False, 32)
    assert a != b and a[1:] == b[1:]


def test_use_kernel_true_raises_on_a_failed_check(monkeypatch):
    jb, tb, _, tm = _models(n_sites=32)
    tdata = _sites(jb, tb, n_sites=32)[1]
    kw = dict(seeds=[0, 1], nepochs=2, eval_every=2, batchsize=32)
    monkeypatch.setattr(pop, "_VERDICTS", {})
    monkeypatch.setattr(pop, "member_selfcheck", lambda *a, **k: "member 1 differs in v")
    with pytest.raises(RuntimeError, match="kernel 5's member axis was refused: member "
                                           "self-check failed: member 1 differs in v"):
        et.population_train(tm, tdata, use_kernel=True, **kw)
    monkeypatch.setattr(pop, "_VERDICTS", {})
    monkeypatch.setattr(fe, "fused_exactness_check", lambda *a, **k: (False, 0.25))
    with pytest.raises(RuntimeError, match=r"kernel 5's member axis was refused: runtime "
                                           r"exactness gate FAILED \(max grad diff 2\.5"):
        et.population_train(tm, tdata, use_kernel=True, **kw)


# ---------------------------------------------------------------------------
# member-axis plumbing without a card
# ---------------------------------------------------------------------------

def _member_setup(k=3, shuffle=True, batch=128, opt=("adam", 0.01), loss="mse", masked=False,
                  epochs=2, **model_kw):
    tm = et.MultiSiteHybridModel(
        et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu",
                                  generator=torch.Generator().manual_seed(1),
                                  **_spec(**model_kw)), n_sites=300, device="cpu")
    data = et.gen_multisite_arrays(300, 8, seed=0, nan_frac=0.1, site_idx=True)
    if masked:
        data.y["reco"][128:256] = np.nan  # every target of the second site batch
    tensors = tepoch.epoch_tensors_to(et.build_epoch_tensors(data, batch), "cpu")
    logging = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    fn = et.make_fused_multisite_epoch(tm, opt, logging, shuffle=shuffle, epochs_per_call=epochs)
    inits = [pop.init_member_params(tm, s) for s in range(k)]
    params = {n: torch.stack([init[n] for init in inits]) for n in inits[0]}
    buffers = {n: b.detach().expand((k,) + tuple(b.shape)).clone() for n, b in tm.named_buffers()}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(tm), params, buffers)
    return fn, packed, pop._stacked_opt_state(packed, opt, k), fn.member_data(tensors), tensors


@pytest.mark.parametrize("shuffle,opt,loss,masked", [
    (True, ("adam", 0.01), "mse", False),
    ("batches", ("adam", 0.01), "mse", True),  # the members' valid steps come in other orders
    (False, ("amsgrad", 0.01), "nseLoss", False),
    (True, ("lamb", 0.01), "rmse", False),
], ids=str)
def test_every_member_is_its_call_alone(shuffle, opt, loss, masked):
    """The member axis's plain version: every member equals, bit for bit, a
    call of the one-model epoch (``FusedMultisiteEpoch.__call__``, what
    ``train()`` runs) from its state on its own permutations, and
    ``alone``, what the self-check holds the members to."""
    fn, packed, opt0, data, tensors = _member_setup(shuffle=shuffle, opt=opt, loss=loss,
                                                    masked=masked)
    gen = torch.Generator().manual_seed(0)
    rows = fn.member_rows(data, 3, generator=gen, shared_perms=False)
    own = shuffle is not False  # unshuffled, every member reads the same site batches
    assert tuple(rows.shape) == (3,) * own + (2, data.n_batches, data.batch)
    assert rows.dtype == torch.int32
    got = fn.members(packed, opt0, data, rows)
    assert tuple(got[2].shape) == (3,)
    gen = torch.Generator().manual_seed(0)
    steps = []
    for i in range(3):
        perms = tepoch.perms_for_epochs(shuffle, tensors, 2, generator=gen)
        p_i = fe.FusedParams(packed.params[i].clone(), packed.bn[i].clone())
        o_i = {k: v[i].clone() for k, v in opt0.items()}
        one = fn(p_i, o_i, tensors, perms=perms)
        alone = fn.alone(p_i, o_i, data, rows[i] if own else rows)
        for want in (one, alone):
            assert torch.equal(got[0].params[i], want[0].params)
            for k in opt0:
                assert torch.equal(got[1][k][i], want[1][k]), k
            assert torch.equal(got[2][i].reshape(1), want[2].reshape(1))
        steps.append(int(got[1]["t"][i]))
    if masked:
        assert steps == [2 * 2] * 3  # a valid batch a epoch, whatever its place


def test_a_shared_index_and_the_launch_arguments():
    fn, packed, opt0, data, _ = _member_setup(k=3, opt=("lamb", 0.01))
    plan = fn.plan
    shared = fn.member_rows(data, 3, generator=torch.Generator().manual_seed(0))
    assert tuple(shared.shape) == (2, data.n_batches, data.batch)
    own = fn.member_rows(data, 3, generator=torch.Generator().manual_seed(0), shared_perms=False)
    assert torch.equal(own[0], shared) and not torch.equal(own[0], own[1])
    # explicit permutations: (E, n) shared or (K, E, n) a member
    perms = torch.stack([torch.randperm(data.n_batches * data.batch) for _ in range(2)])
    assert torch.equal(fn.member_rows(data, 3, perms=perms), fm.site_index(True, perms, data, 2))
    per = fn.member_rows(data, 3, perms=torch.stack([perms, perms.flip(0), perms]))
    assert torch.equal(per[1], fm.site_index(True, perms.flip(0), data, 2))
    # the members of a shared index are the shared computation's
    got = fn.members(packed, opt0, data, shared)
    ref = fm.fused_multisite_members_reference(
        plan, packed, opt0, data, shared,
        *fm.step_scales(plan, data, shared, same_batches=False))
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    # the struct: the count, the stride of the per-step rows, every member's state
    k = 3
    scale, valid = fm.member_scales(plan, data, own, same_batches=False)
    assert tuple(scale.shape) == (k, 2, data.n_batches, 1) and tuple(valid.shape) == (k, 2, 3)
    loss = torch.zeros((k, 2))
    a, tcount, scratch = fm.launch_args(plan, packed, opt0, data, own, scale, valid, loss)
    assert (a.n_members, a.step_stride, a.n_epochs, a.n_batches) == (k, 2 * 3, 2, 3)
    assert a.params == packed.params.data_ptr() and a.site_index == own.data_ptr()
    assert a.bn == packed.bn.data_ptr() and a.epoch_loss == loss.data_ptr()
    assert tuple(tcount.shape) == (k, 6) and torch.equal(tcount[:, -1], valid.sum((1, 2)))
    gsite, partials, lamb_parts = scratch
    assert tuple(gsite.shape) == (k, plan.n_sites) and partials.shape[0] == k
    assert lamb_parts.shape[0] == k and a.lamb_parts == lamb_parts.data_ptr()
    a, _, _ = fm.launch_args(plan, packed, opt0, data, shared, scale[0], valid[0], loss)
    assert (a.n_members, a.step_stride) == (k, 0)
    one = fm.launch_args(plan, fe.FusedParams(packed.params[0], packed.bn[0]),
                         {n: v[0] for n, v in opt0.items()}, data, shared, scale[0], valid[0],
                         torch.zeros(2))[0]
    assert (one.n_members, one.step_stride) == (1, 0)
    with pytest.raises(ValueError, match="site index"):
        fm.launch_args(plan, packed, opt0, data, own[:2], scale[:2], valid[:2], loss)
    with pytest.raises(ValueError, match="epoch losses"):
        fm.launch_args(plan, packed, opt0, data, own, scale, valid, torch.zeros(2))
    with pytest.raises(ValueError, match="norm statistics"):
        fm.launch_args(plan, fe.FusedParams(packed.params, packed.bn[:1]), opt0, data, own,
                       scale, valid, loss)
    with pytest.raises(ValueError, match="plan's optimizer"):
        fn.members(packed, opt0, data, own, specs=[("adam", 0.01)] * 3)
    with pytest.raises(ValueError, match="per-member data"):
        fn.member_data([data])


def test_the_ctypes_mirror_of_the_member_fields():
    names = [n for n, _ in fm._Args._fields_]
    assert names[-3:] == ["halt", "n_members", "step_stride"]
    assert fm._Args.step_stride.offset % 8 == 0
    assert fm._Args.step_stride.offset + 8 == __import__("ctypes").sizeof(fm._Args)


# ---------------------------------------------------------------------------
# ensemble_predict
# ---------------------------------------------------------------------------

def _close(got, want, what, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    on = ~np.isnan(want)
    over = np.abs(got[on] - want[on]) - tol * np.maximum(1.0, np.abs(want[on]))
    assert over.size == 0 or over.max() <= 0.0, (what, np.abs(got[on] - want[on]).max())


def _carried(tm, want):
    """A JAX population's stacked leaves as the port's, and a
    ``PopulationResults`` of them."""
    params, state = load_jax_population(tm, jax.tree.map(np.asarray, want.params),
                                        jax.tree.map(np.asarray, want.state))
    best, _ = load_jax_population(tm, jax.tree.map(np.asarray, want.best_params),
                                  jax.tree.map(np.asarray, want.state))
    k = len(want.best_losses)
    return pop.PopulationResults(
        hyper={}, seeds=np.arange(k), params=params, best_params=best, state=state,
        best_losses=np.asarray(want.best_losses), best_epochs=np.asarray(want.best_epochs),
        train_history={}, val_history={}, epochs=np.asarray(want.epochs), best_member=0,
        monitor="mse")


def test_ensemble_predict_matches_the_jax_function():
    """tests/test_population.py:216-242's case with the JAX population
    carried across: the mean and the spread of every output, a one-member
    ensemble (spread 0, its mean the member's ``predict``), a tuple input
    and ``best=False``."""
    jm, tm = _pair()
    df = eh.gen_rbq10_data(500, seed=8)
    cols = et.rbq10_columns(500, seed=8)
    want_pop = eh.population_train(jm, df, hyper={"learning_rate": [0.01]}, seeds=[0, 1, 2],
                                   nepochs=10, batchsize=128, eval_every=5, seed=6, data_seed=0)
    got_pop = _carried(tm, want_pop)
    for best in (True, False):
        want = eh.ensemble_predict(jm, want_pop, df, best=best)
        got = et.ensemble_predict(tm, got_pop, cols, best=best)
        assert set(got) == set(want) == {"reco", "reco_std", "rb", "rb_std"}
        for k in want:
            _close(got[k], want[k], k)
    assert got["reco"].shape == (500,) and got["reco_std"].max() > 0
    one = ({k: v[:1] for k, v in got_pop.best_params.items()},
           {k: v[:1] for k, v in got_pop.state.items()})
    out1 = et.ensemble_predict(tm, one, cols)
    np.testing.assert_allclose(out1["reco_std"], 0.0, atol=1e-6)
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(got_pop.best_params[n][0])
        for n, b in tm.named_buffers():
            b.copy_(got_pop.state[n][0])
    solo = et.predict(tm, cols, use_kernel=False)
    np.testing.assert_allclose(out1["reco"], solo["reco"], atol=1e-5)


def test_ensemble_predict_of_the_sweep_examples_ensemble():
    """examples/population_sweep.py:67-82: an 8-seed ensemble at one
    learning rate, predicted on the table's first 1,000 rows, batch size
    256 (four chunks)."""
    jm, tm = _pair(hidden=(16, 16))
    df, cols = eh.gen_rbq10_data(2000, seed=42), et.rbq10_columns(2000, seed=42)
    want_pop = eh.population_train(jm, df, hyper={"learning_rate": [0.01]}, seeds=list(range(8)),
                                   optimizer="adam", nepochs=5, batchsize=512, eval_every=5,
                                   seed=11, data_seed=0)
    got_pop = _carried(tm, want_pop)
    head = {k: v[:1000] for k, v in cols.items()}
    want = eh.ensemble_predict(jm, want_pop, df.head(1000), batch_size=256)
    got = et.ensemble_predict(tm, got_pop, head, batch_size=256)
    assert "reco" in got and "reco_std" in got and set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def test_ensemble_predict_on_a_multisite_population_follows_jax():
    """A multi-site ensemble: site-major outputs ``(S, N)`` and the per-site
    globals ``(S, 1)``, as the JAX function gives them at any batch size; a
    table that is not site-major raises, as it does there."""
    jb, tb, jm, tm = _models(n_sites=16)
    jdata, tdata = _sites(jb, tb, n_sites=16, n_obs=10)
    want_pop = eh.population_train(jm, jdata, seeds=[0, 1], nepochs=2, batchsize=16,
                                   eval_every=1, split_data_at=0.75)
    got_pop = _carried(tm, want_pop)
    for batch_size in (4, 16, 1024):
        want = eh.ensemble_predict(jm, want_pop, jdata, batch_size=batch_size)
        got = et.ensemble_predict(tm, got_pop, tdata, batch_size=batch_size)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"{k} at batch size {batch_size}")
    assert got["Q10"].shape == (16, 1) and got["reco"].shape == (16, 10)
    df = eh.gen_rbq10_data(160, seed=3)
    with pytest.raises(ValueError):
        eh.ensemble_predict(jm, want_pop, df)
    with pytest.raises(ValueError, match="site-major"):
        et.ensemble_predict(tm, got_pop, et.rbq10_columns(160, seed=3))


def test_ensemble_predict_of_a_multinn_model_flattens_as_jax():
    """A MultiNN model's outputs flatten as the JAX function flattens them
    (the branches' raw outputs under the parameter names: ROADMAP queue C),
    and the port keeps that result."""
    def expo_jax(*, ta, rb, k):
        return {"reco": rb * jax.numpy.exp(k * ta)}

    def expo_torch(*, ta, rb, k):
        return {"reco": rb * torch.exp(k * ta)}

    spec = _spec(predictors={"rb": ["sw_pot"], "k": ["dsw_pot"]},
                 parameters={"rb": (2.0, 0.0, 8.0), "k": (0.05, 0.0, 0.2)},
                 neural_param_names=None, global_param_names=[])
    jm = eh.construct_hybrid_model(mechanistic_model=expo_jax, **spec)
    tm = et.construct_hybrid_model(mechanistic_model=expo_torch, device="cpu", **spec)
    df, cols = eh.gen_rbq10_data(300, seed=5), et.rbq10_columns(300, seed=5)
    want_pop = eh.population_train(jm, df, seeds=[0, 1], nepochs=2, batchsize=64, eval_every=1,
                                   data_seed=0)
    got = et.ensemble_predict(tm, _carried(tm, want_pop), cols)
    want = eh.ensemble_predict(jm, want_pop, df)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    assert got["rb"].shape == want["rb"].shape == (300, 1)  # the raw branch output
