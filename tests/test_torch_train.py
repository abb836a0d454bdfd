"""The whole training slice: the port's ``train()`` against the JAX
package's on the quick-start model (trainable BatchNorm, [16,16] swish,
adam), from the JAX initial parameters, unshuffled: per-epoch train and val
metrics, the best epoch and the final parameters; then the engine choice on
the CPU, early stopping, the lazy DataFrames, the unported options, and the
SKILL drive's assertion.

Tolerances (float32): metrics rtol 1e-5 / atol 1e-6 and parameters atol
1e-5 over 10 epochs x 4 batches of adam (measured 4e-7 and 1.5e-7); the
BatchNorm running variance (~400) rtol 1e-5."""

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et

SPEC = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
    mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
    neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
    activation="swish", scale_nn_outputs=True, input_batchnorm=True,
)
KW = dict(nepochs=10, batchsize=128, optimizer=("adam", 0.01), shuffle_each_epoch=False,
          show_progress=False)


def _jax_init(seed=0):
    jm = eh.construct_hybrid_model(**SPEC)
    params, state = jm.init(jax.random.PRNGKey(seed))
    return jm, jax.tree.map(np.asarray, (params, state))


def _assert_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for metric in w:
            assert set(g[metric]) == set(w[metric])
            for k in w[metric]:
                np.testing.assert_allclose(g[metric][k], w[metric][k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_matches_jax(use_kernel):
    jm, init = _jax_init()
    cols = et.rbq10_columns(512, seed=42)
    jr = eh.train(jm, cols, train_from=jax.tree.map(np.array, init), **KW)
    tm = et.construct_hybrid_model(**SPEC)
    tr = et.train(tm, cols, train_from=init, use_kernel=use_kernel, **KW)
    assert tr.epoch_path == ("cuda_fused_epoch" if use_kernel else "torch")
    assert tr.loop_mode == "eager"
    _assert_history(tr.train_history, jr.train_history)
    _assert_history(tr.val_history, jr.val_history)
    assert tr.best_epoch == jr.best_epoch
    np.testing.assert_allclose(tr.best_loss, jr.best_loss, rtol=1e-5)
    got_p, got_s = et.export_jax_params(tm)  # the model holds the best parameters
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(jr.state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tr.val_pred_columns["reco_pred"], np.asarray(jr.val_pred["reco_pred"]),
                               rtol=1e-5, atol=1e-5)
    if use_kernel:
        assert "exactness gate passed" in tr.engine_reason


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_matches_jax_with_the_reference_quick_start_optimizer(use_kernel):
    """The reference quick-start's rmsprop at 1e-3 (``examples/rbq10.py``):
    the fused engine's plain version behind its gate and the torch engine
    against the JAX package's ``train()``, at the tolerances above."""
    jm, init = _jax_init()
    cols = et.rbq10_columns(512, seed=42)
    kw = dict(KW, optimizer=("rmsprop", 0.001))
    jr = eh.train(jm, cols, train_from=jax.tree.map(np.array, init), **kw)
    tm = et.construct_hybrid_model(**SPEC)
    tr = et.train(tm, cols, train_from=init, use_kernel=use_kernel, **kw)
    assert tr.epoch_path == ("cuda_fused_epoch" if use_kernel else "torch")
    _assert_history(tr.train_history, jr.train_history)
    _assert_history(tr.val_history, jr.val_history)
    assert tr.best_epoch == jr.best_epoch
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    if use_kernel:
        assert "exactness gate passed" in tr.engine_reason


def test_engine_reasons_on_the_cpu():
    cols = et.rbq10_columns(300, seed=1)
    kw = dict(KW, nepochs=2)
    r = et.train(et.construct_hybrid_model(**SPEC), cols, **kw)
    assert r.epoch_path == "torch" and "'cpu', not cuda" in r.engine_reason
    r = et.train(et.construct_hybrid_model(**SPEC), cols, use_kernel=False, **kw)
    assert r.epoch_path == "torch" and "use_kernel disabled" in r.engine_reason
    r = et.train(et.construct_hybrid_model(**SPEC), cols, use_kernel=True, training_loss="mae", **kw)
    assert r.epoch_path == "torch" and "trains mse" in r.engine_reason
    r = et.train(et.construct_hybrid_model(**SPEC), cols, use_pallas=True, eval_every=2, **kw)
    assert r.epoch_path == "cuda_fused_epoch" and len(r.train_history) == 2


@pytest.mark.parametrize("eval_every", [1, 2])
def test_early_stopping_matches_jax(eval_every):
    """No learning (sgd at lr 0, static norm): patience counts evaluations,
    as in JAX."""
    spec = dict(SPEC, input_batchnorm="static")
    jm = eh.construct_hybrid_model(**spec)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    cols = et.rbq10_columns(300, seed=2)
    kw = dict(KW, nepochs=20, optimizer=("sgd", 0.0), patience=3, eval_every=eval_every)
    jr = eh.train(jm, cols, train_from=jax.tree.map(np.array, init), **kw)
    tr = et.train(et.construct_hybrid_model(**spec), cols, train_from=init, **kw)
    assert tr.best_epoch == jr.best_epoch == 0
    assert len(tr.val_history) == len(jr.val_history) == 4
    _assert_history(tr.val_history, jr.val_history)


def test_results_hold_numpy_columns_and_build_frames_on_access():
    cols = et.rbq10_columns(300, seed=3)
    tm = et.construct_hybrid_model(**SPEC, generator=torch.Generator().manual_seed(0))
    r = et.train(tm, cols, nepochs=3, batchsize=64, tracked_params=["Q10"], monitor_names=["rb"],
                 keep_history=True, show_progress=True)
    assert isinstance(r.train_obs_columns["reco"], np.ndarray)
    assert set(r.val_pred_columns) == {"reco_pred"}
    frame = r.train_obs
    assert type(frame).__name__ == "DataFrame" and frame.shape == (240, 1)
    np.testing.assert_array_equal(r.val_pred["reco_pred"].to_numpy(), r.val_pred_columns["reco_pred"])
    assert len(r.tracked["Q10"]) == 4 and set(r.monitored["rb"][0]) == {"q25", "q50", "q75"}
    assert r.history[1].y_hat_val["reco"].shape == (60,)
    assert set(r.params) == {k for k, _ in tm.named_parameters()}
    assert "rb" in r.val_diffs["parameters"]
    assert r.history_frame().shape[0] == 4


@pytest.mark.parametrize("kwargs,item", [
    (dict(multi_device=True), "item 15"),
    (dict(optimizer="lbfgs"), "item 12"),
    (dict(optimizer={"globals": ("sgd", 0.1)}), "item 6"),
    (dict(return_gradients=True), "item 8"),
    (dict(save_training=True), "item 16"),
])
def test_options_not_ported_yet_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        et.train(et.construct_hybrid_model(**SPEC), et.rbq10_columns(100, seed=1), **kwargs)


def test_warm_start_from_results_and_config_objects():
    cols = et.rbq10_columns(300, seed=4)
    tm = et.construct_hybrid_model(**SPEC, generator=torch.Generator().manual_seed(1))
    r1 = et.train(tm, cols, train_cfg=et.TrainConfig(nepochs=2, batchsize=64, show_progress=False),
                  data_cfg=et.DataConfig(split_data_at=0.7))
    other = et.construct_hybrid_model(**SPEC, generator=torch.Generator().manual_seed(9))
    r2 = et.train(other, cols, nepochs=0, train_from=r1, split_data_at=0.7, show_progress=False)
    np.testing.assert_allclose(r2.best_loss, r1.best_loss, rtol=1e-6)
    assert len(r1.val_obs_columns["reco"]) == 90


def test_skill_drive_on_the_cpu():
    """The end-to-end drive of .claude/skills/verify/SKILL.md on the port."""
    cols = et.rbq10_columns(2000, seed=42)
    m = et.construct_hybrid_model(**SPEC, generator=torch.Generator().manual_seed(0))
    r = et.train(m, cols, nepochs=100, batchsize=512, optimizer=("adam", 0.01), show_progress=False)
    q10 = float(et.scale_param(r.params["globals.Q10"], 1.0, 4.0))
    assert abs(q10 - 2.0) < 0.15 and r.best_loss < 0.05
    out = et.predict(m, cols)  # the model holds the best parameters
    np.testing.assert_allclose(np.nanmean((out["reco"][1600:] - cols["reco"][1600:]) ** 2),
                               r.best_loss, rtol=1e-4)
