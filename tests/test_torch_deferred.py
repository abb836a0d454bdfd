"""The deferred (zero-readback) training loop of the port
(``training/deferred.py``), the halt word of kernels 2-5, and the rest of
the loop's options: ``return_gradients``, a prebuilt ``opt_state`` and
``remat``.

* The port's deferred ``train()`` against the JAX package's deferred
  ``train()`` on the quick-start model (trainable BatchNorm, [16,16] swish),
  from the JAX initial parameters, unshuffled, on the torch engine and on
  kernel 2's plain version (``use_kernel=True``): histories and best
  metrics rtol 1e-5 / atol 1e-6 (as ``test_torch_train.py``); tracked
  values, monitored quantiles, gradient norms and final gradients rtol 1e-4
  (a sum of squares in another leaf order, and quantiles computed in
  float32 against the JAX package's; the norms and gradients also atol 1e-5
  and 1e-6: after 25 epochs at lr 0.05 the parameters sit 1e-6 apart, and a
  norm of 0.017 moves by as much); parameters atol 1e-5.
* The port's deferred loop against its eager loop, bit for bit, on the
  torch engine and the plain versions of kernels 2-5.
* A halted plain launch of each kernel returns its inputs' bits.
* ``defer_blockers`` against the JAX package's; no host read between the
  first block and the final fetch but the loop's poll; a 6-epoch run equals
  3 + 3 epochs through ``train_from=`` and ``opt_state=`` (bit for bit, and
  against the JAX package's pair at the tolerances above); ``remat`` and the
  gradient probe leave the results and the buffers as they were, bit for bit.
"""

import copy
import functools

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.training import deferred as jax_deferred
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.training import deferred
from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

SPEC = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
    mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
    neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
    activation="swish", scale_nn_outputs=True, input_batchnorm=True,
)
# the JAX deferred tests' early stop: a large step, patience 3
STOP_KW = dict(nepochs=40, batchsize=64, optimizer=("adam", 0.05), patience=3,
               tracked_params=["Q10"], monitor_names=["rb"], return_gradients=True,
               keep_history=True, shuffle_each_epoch=False)


@functools.lru_cache(maxsize=None)
def _cols(n=400, seed=42):
    return et.rbq10_columns(n, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_init(seed=0):
    jm = eh.construct_hybrid_model(**SPEC)
    params, state = jm.init(jax.random.PRNGKey(seed))
    return jm, jax.tree.map(np.asarray, (params, state))


@functools.lru_cache(maxsize=None)
def _jax_train(**kw):
    jm, init = _jax_init()
    kw = {k: (list(v) if isinstance(v, tuple) and k != "optimizer" else v) for k, v in kw.items()}
    return eh.train(jm, _cols(), train_from=jax.tree.map(np.array, init), show_progress=False, **kw)


def _port_train(show_progress=False, **kw):
    _, init = _jax_init()
    tm = et.construct_hybrid_model(**SPEC, device="cpu")
    return tm, et.train(tm, _cols(), train_from=init, show_progress=show_progress, **kw)


def _close_history(got, want, rtol=1e-5, atol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for metric in w:
            for k in w[metric]:
                np.testing.assert_allclose(g[metric][k], w[metric][k], rtol=rtol, atol=atol)


def _jax_layout(model, grads):
    """Port gradients (keyed like ``named_parameters``) in the JAX layout."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in twin.named_parameters():
            p.copy_(grads[k])
    return et.export_jax_params(twin)[0]


def _hashable(kw):
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in kw.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_deferred_matches_jax_deferred_with_an_early_stop(use_kernel):
    """The settings of the JAX package's deferred tests at once: patience 3
    with an early stop, tracked and monitored parameters, the prediction
    history and the gradient norms."""
    jr = _jax_train(**_hashable(STOP_KW))
    tm, tr = _port_train(use_kernel=use_kernel, **STOP_KW)
    assert tr.epoch_path == ("cuda_fused_epoch" if use_kernel else "torch")
    assert tr.loop_mode == jr.loop_mode == "deferred"
    assert tr.engine_reason.endswith("; zero-readback")
    assert len(tr.val_history) < 41  # stopped early
    _close_history(tr.train_history, jr.train_history)
    _close_history(tr.val_history, jr.val_history)
    assert tr.best_epoch == jr.best_epoch
    np.testing.assert_allclose(tr.best_loss, jr.best_loss, rtol=1e-5)
    np.testing.assert_allclose(tr.tracked["Q10"], jr.tracked["Q10"], rtol=1e-4)
    assert len(tr.monitored["rb"]) == len(jr.monitored["rb"])
    for a, b in zip(tr.monitored["rb"], jr.monitored["rb"]):
        for q in ("q25", "q50", "q75"):
            np.testing.assert_allclose(a[q], b[q], rtol=1e-4)
    assert len(tr.grad_history) == len(jr.grad_history)
    for a, b in zip(tr.grad_history, jr.grad_history):
        assert set(a) == set(b) == {"global", "nn", "globals"}
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)
    got = jax.tree.leaves(_jax_layout(tm, tr.final_grads))
    want = jax.tree.leaves(jax.device_get(jr.final_grads))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    for a, b in zip(jax.tree.leaves(et.export_jax_params(tm)[0]), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    assert len(tr.history) == len(jr.history)
    for a, b in zip(tr.history.snapshots, jr.history.snapshots):
        np.testing.assert_allclose(a.y_hat_val["reco"], np.asarray(b.y_hat_val["reco"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.y_hat_train["reco"], np.asarray(b.y_hat_train["reco"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_deferred_matches_jax_without_patience_at_eval_every_2(use_kernel):
    kw = dict(nepochs=8, batchsize=64, optimizer=("adam", 0.01), eval_every=2,
              shuffle_each_epoch=False)
    jr = _jax_train(**kw)
    tm, tr = _port_train(use_kernel=use_kernel, **kw)
    assert tr.loop_mode == jr.loop_mode == "deferred"
    assert len(tr.train_history) == len(jr.train_history) == 5  # the initial state + 4
    _close_history(tr.val_history, jr.val_history)
    assert tr.best_epoch == jr.best_epoch
    for a, b in zip(jax.tree.leaves(et.export_jax_params(tm)[0]), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)


def test_engine_and_loop_reasons_as_in_jax():
    """``test_engine_reason_surfaced`` of the JAX package on the port, with
    the loop's suffix in the JAX package's words."""
    tm = et.construct_hybrid_model(**SPEC, generator=torch.Generator().manual_seed(0))
    kw = dict(batchsize=64, show_progress=False)
    res = et.train(tm, _cols(), nepochs=1, **kw)
    assert res.engine_reason.startswith(res.epoch_path) and res.loop_mode == "deferred"
    assert "zero-readback" in res.engine_reason
    res2 = et.train(tm, _cols(), nepochs=1, **{**kw, "show_progress": True})
    assert res2.loop_mode == "eager"
    blockers = jax_deferred.defer_blockers(eh.TrainConfig(nepochs=1, show_progress=True))
    assert res2.engine_reason.endswith("; eager loop forced by " + ", ".join(blockers))
    res3 = et.train(tm, _cols(), nepochs=2, keep_history=True, **kw)
    assert res3.loop_mode == "deferred" and len(res3.history) == 3
    assert res3.history[1].y_hat_val is not None and "reco" in res3.history[1].y_hat_val
    res4 = et.train(tm, _cols(), nepochs=1, jit=False, **kw)
    assert res4.loop_mode == "eager" and res4.engine_reason.endswith("forced by jit=False")


@pytest.mark.parametrize("kw,n", [
    (dict(), None), (dict(show_progress=False), None), (dict(show_progress=False, jit=False), 10),
    (dict(plotting=True, show_progress=False), None), (dict(plotting=True, jit=False), None),
    (dict(show_progress=False, keep_history=True), 100),
    (dict(show_progress=False, keep_history=True, nepochs=200), 1_000_000),   # 256 x 1e6 > 2.5e8
    (dict(show_progress=False, keep_history=True, nepochs=200), 976_562),     # exactly 2.5e8
    (dict(show_progress=False, keep_history=True, nepochs=10, eval_every=3), 15_625_001),
    (dict(keep_history=True, nepochs=1000, eval_every=7), 10_000_000),
])
def test_defer_blockers_match_jax(kw, n):
    port, jaxc = et.TrainConfig(**kw), eh.TrainConfig(**kw)
    assert deferred.defer_blockers(port, n) == jax_deferred.defer_blockers(jaxc, n)
    assert deferred.can_defer(port, n) == jax_deferred.can_defer(jaxc, n)
    assert deferred.history_rows_padded(port) == jax_deferred.history_rows_padded(jaxc)


def _quick(device="cpu", hidden=(16, 16), seed=0, **kw):
    spec = {**SPEC, "hidden_layers": hidden if isinstance(hidden, dict) else list(hidden), **kw}
    return et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed),
                                     device=device)


def _site_table(S=60, N=8):
    q10 = np.random.default_rng(7).uniform(1.4, 2.8, S)
    sites = [et.rbq10_columns(N, seed=7 + s, true_q10=float(q10[s])) for s in range(S)]
    table = {k: np.concatenate([c[k] for c in sites]) for k in ("sw_pot", "dsw_pot", "ta", "reco")}
    table["site"] = np.repeat(np.arange(S), N)
    return table


# the engines at small sizes, each with an early stop: (path, model, data, kwargs)
def _engine_case(name):
    cols = _cols(600, 4)
    common = dict(optimizer=("adam", 0.05), patience=2, tracked_params=["Q10"],
                  monitor_names=["rb"], random_seed=3)
    static = dict(input_batchnorm="static")
    if name == "torch":
        return "torch", _quick(), cols, dict(common, nepochs=12, batchsize=128, use_kernel=False)
    if name == "kernel 2":
        return ("cuda_fused_epoch", _quick(), cols,
                dict(common, nepochs=12, batchsize=128, use_kernel=True, keep_history=True))
    if name == "kernel 3":
        return ("cuda_fused_wide", _quick(hidden=(72,), **static), _cols(300, 4),
                dict(common, optimizer=("adam", 0.3), nepochs=12, batchsize=150, use_kernel=True,
                     eval_every=2))
    if name == "kernel 4":
        m = _quick(hidden={"lstm": 8}, **{**static, "activation": "tanh"})
        return ("cuda_fused_lstm", m, cols,
                dict(common, nepochs=10, batchsize=128, use_kernel=True,
                     sequence_kwargs=dict(input_window=6, output_window=1, lead_time=0)))
    base = _quick(**static)
    data = et.prepare_multisite_data(base, _site_table(), "site")
    return ("cuda_fused_multisite", et.MultiSiteHybridModel(base, n_sites=60, device="cpu"), data,
            dict(common, nepochs=14, batchsize=16, use_kernel=True, split_data_at=0.8,
                 shuffle_each_epoch=True))


def _bits_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_bits_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return a == b


@pytest.mark.parametrize("name", ["torch", "kernel 2", "kernel 3", "kernel 4", "kernel 5"])
def test_deferred_equals_eager_bit_for_bit(name):
    """Histories, stop point, best epoch, best parameters and state, the
    optimizer's slots, the tracked and monitored series and the predictions:
    equal bits from both loops."""
    path, model, data, kw = _engine_case(name)
    if name == "kernel 4":
        kw.pop("monitor_names")  # the windowed outputs carry no per-sample rb
    twin = copy.deepcopy(model)
    d = et.train(model, data, show_progress=False, **kw)
    e = et.train(twin, data, show_progress=True, **kw)
    assert deferred.loop_record(d).stop_index == len(d.val_history) - 1  # an early stop
    _assert_loops_equal(d, e, path, kw)


@pytest.mark.parametrize("name", ["torch", "kernel 2", "kernel 3", "kernel 4", "kernel 5"])
def test_blocks_dispatched_after_the_stop_change_nothing(monkeypatch, name):
    """The card's case where the host has not seen the stop yet, for every
    block after it: the poll never reports ``done``, so the loop dispatches
    all its blocks and those after the stop run with the word set (the torch
    engine's select over leaves, buffers and slots; the kernels' plain
    versions return their inputs), and the stopper ignores their rows. The
    results are the eager loop's, bit for bit."""
    path, model, data, kw = _engine_case(name)
    if name == "kernel 4":
        kw.pop("monitor_names")
    twin = copy.deepcopy(model)
    monkeypatch.setattr(deferred, "poll_done", lambda poll: False)
    d = et.train(model, data, show_progress=False, **kw)
    e = et.train(twin, data, show_progress=True, **kw)
    record, n_blocks = deferred.loop_record(d), kw["nepochs"] // kw.get("eval_every", 1)
    assert record.blocks == n_blocks
    assert record.stop_index == len(d.val_history) - 1 < n_blocks
    assert record.blocks_after_stop == n_blocks - record.stop_index > 0
    _assert_loops_equal(d, e, path, kw)


def _assert_loops_equal(d, e, path, kw):
    assert d.epoch_path == e.epoch_path == path
    assert (d.loop_mode, e.loop_mode) == ("deferred", "eager")
    assert deferred.loop_record(e) is None
    assert d.train_history == e.train_history and d.val_history == e.val_history
    assert (d.best_epoch, d.best_loss) == (e.best_epoch, e.best_loss)
    assert d.tracked == e.tracked and d.monitored == e.monitored
    for got, want in ((d.params, e.params), (d.state, e.state), (d.opt_state, e.opt_state),
                      (d.val_pred_columns, e.val_pred_columns)):
        assert _bits_equal(got, want)
    if kw.get("keep_history"):
        for a, b in zip(d.history.snapshots, e.history.snapshots):
            assert _bits_equal(a.y_hat_val, b.y_hat_val)
            assert _bits_equal(a.y_hat_train, b.y_hat_train)


@pytest.mark.parametrize("make", ["make_fused_epoch", "make_fused_wide_epoch",
                                  "make_fused_lstm_epoch", "make_fused_multisite_epoch"])
def test_a_halted_plain_launch_returns_its_inputs(make):
    """Each kernel's plain version under a set halt word: the parameters,
    statistics and every slot of the opt state come back bit for bit, and
    the loss is 0; under a clear word, the bits of a call without one."""
    _, model, data, _ = _engine_case({"make_fused_epoch": "kernel 2",
                                      "make_fused_wide_epoch": "kernel 3",
                                      "make_fused_lstm_epoch": "kernel 4",
                                      "make_fused_multisite_epoch": "kernel 5"}[make])
    if make == "make_fused_lstm_epoch":
        data = et.split_into_sequences(et.prepare_data(model, data), input_window=6,
                                       output_window=1, lead_time=0)
    elif make != "make_fused_multisite_epoch":
        data = et.prepare_data(model, data)
    et.fit_input_norm(model, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, 16 if "multi" in make else 128), "cpu")
    fn = getattr(et, make)(model, ("adam", 0.01), et.LoggingLoss(), shuffle=True,
                           epochs_per_call=2)
    perms = perms_for_epochs(True, tensors, 2, generator=torch.Generator().manual_seed(0))
    packed = fn.plan.pack(model)
    state = fe.init_fused_opt_state(packed, ("adam", 0.01))
    state["m"].normal_(generator=torch.Generator().manual_seed(1))
    halt = torch.ones((), dtype=torch.int32)
    got = fn(packed, state, tensors, perms=perms, halt=halt)
    assert torch.equal(got[0].params, packed.params) and torch.equal(got[0].bn, packed.bn)
    assert set(got[1]) == set(state) and all(torch.equal(got[1][k], state[k]) for k in state)
    assert float(got[2]) == 0.0
    live = fn(packed, state, tensors, perms=perms, halt=torch.zeros_like(halt))
    free = fn(packed, state, tensors, perms=perms)
    assert int(live[1]["t"][0]) > int(state["t"][0])
    assert _bits_equal(dict(live[1], p=live[0].params, bn=live[0].bn),
                       dict(free[1], p=free[0].params, bn=free[0].bn))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_no_host_read_between_the_first_block_and_the_final_fetch(monkeypatch, use_kernel):
    """Every ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
    ``bool()`` / ``float()`` / ``int()`` of a tensor inside the deferred
    loop's dispatch window is counted, apart from those of its one poll."""
    calls, state = [], {"window": False, "poll": False}
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            if state["window"] and not state["poll"]:
                calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    real_window, real_poll = deferred._sync_debug, deferred.poll_done
    polls = []

    class Window:
        def __init__(self, device):
            self.inner = real_window(device)

        def __enter__(self):
            state["window"] = True
            return self.inner.__enter__()

        def __exit__(self, *exc):
            state["window"] = False
            return self.inner.__exit__(*exc)

    def poll(p):
        state["poll"] = True
        try:
            polls.append(1)
            return real_poll(p)
        finally:
            state["poll"] = False

    monkeypatch.setattr(deferred, "_sync_debug", Window)
    monkeypatch.setattr(deferred, "poll_done", poll)
    r = et.train(_quick(), _cols(), nepochs=6, batchsize=128, use_kernel=use_kernel,
                 tracked_params=["Q10"], monitor_names=["rb"], return_gradients=True,
                 keep_history=True, patience=10, show_progress=False)
    assert r.loop_mode == "deferred" and len(polls) == 6
    assert calls == []
    # the counter sees the eager loop's reads
    state["window"] = True
    et.train(_quick(), _cols(), nepochs=1, batchsize=128, show_progress=True)
    state["window"] = False
    assert calls


def test_six_epochs_equal_three_and_three_through_opt_state_and_train_from():
    """Unshuffled adam: a 6-epoch run against a 3-epoch run continued for 3
    epochs from its parameters, state and optimizer state, bit for bit on
    the port, and the pair against the JAX package's pair."""
    kw = dict(batchsize=64, optimizer=("adam", 0.01), shuffle_each_epoch=False,
              return_model="final")
    _, r6 = _port_train(nepochs=6, **kw)
    _, r3 = _port_train(nepochs=3, **kw)
    tm = et.construct_hybrid_model(**SPEC, device="cpu")
    r33 = et.train(tm, _cols(), nepochs=3, train_from=r3, opt_state=r3.opt_state,
                   show_progress=False, **kw)
    assert r33.epoch_path == "torch"
    assert r33.engine_reason.startswith(
        "torch: the model is on 'cpu'")  # the device decides first, as the backend in JAX
    r33k = et.train(et.construct_hybrid_model(**SPEC, device="cpu"), _cols(), nepochs=3,
                    train_from=r3, opt_state=r3.opt_state, use_kernel=True,
                    show_progress=False, **kw)
    assert r33k.epoch_path == "torch" and "prebuilt opt_state (the fused kernel carries its own)" \
        in r33k.engine_reason
    for got, want in ((r33.params, r6.params), (r33.state, r6.state),
                      (r33.opt_state, r6.opt_state), (r33k.params, r6.params)):
        assert _bits_equal(got, want)
    jm, init = _jax_init()
    j3 = eh.train(jm, _cols(), nepochs=3, train_from=jax.tree.map(np.array, init),
                  show_progress=False, **kw)
    j33 = eh.train(jm, _cols(), nepochs=3, train_from=(j3.params, j3.state),
                   opt_state=j3.opt_state, show_progress=False, **kw)
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(j33.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(j33.state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    _close_history(r33.val_history, j33.val_history)


@pytest.mark.parametrize("show_progress", [False, True])
def test_remat_gives_the_bits_of_no_remat(show_progress):
    """The checkpointed torch epoch, trainable BatchNorm: parameters, running
    statistics, opt state and history equal without it; the statistics moved
    once a step."""
    kw = dict(nepochs=3, batchsize=64, optimizer=("adam", 0.01), show_progress=show_progress)
    plain = et.train(_quick(), _cols(), **kw)
    remat = et.train(_quick(), _cols(), remat=True, **kw)
    assert remat.epoch_path == "torch"
    for got, want in ((remat.params, plain.params), (remat.state, plain.state),
                      (remat.opt_state, plain.opt_state)):
        assert _bits_equal(got, want)
    assert remat.val_history == plain.val_history
    assert not torch.equal(plain.state["nn.norm.var"], _quick().state_dict()["nn.norm.var"])


def test_the_gradient_probe_leaves_the_buffers_and_mode():
    from easyhybrid_tpu_torch.training.epoch import make_grad_probe
    from easyhybrid_tpu_torch.training.train import _full_batch

    m = _quick()
    data = et.prepare_data(m, _cols())
    batch = _full_batch(data, torch.device("cpu"))
    m.eval()
    before = {k: b.clone() for k, b in m.named_buffers()}
    grads = make_grad_probe(m, et.LoggingLoss())(batch)
    assert not m.training
    assert all(torch.equal(b, before[k]) for k, b in m.named_buffers())
    assert set(grads) == {k for k, _ in m.named_parameters()}
    assert float(grads["nn.layers.0.weight"].abs().max()) > 0
    # the gradient itself: autograd over the same training loss
    from easyhybrid_tpu_torch.losses.compute import compute_loss
    from easyhybrid_tpu_torch.losses.specs import LoggingLoss

    loss = compute_loss(m, batch, LoggingLoss(train_mode=True))
    want = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
    assert all(torch.equal(grads[k], w) for (k, _), w in zip(m.named_parameters(), want))
