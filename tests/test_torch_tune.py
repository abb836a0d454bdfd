"""The sequential tuning drivers and the folds in the port against the JAX
package: ``make_folds`` gives the same fold ids, ``random_search`` and
``grid_search`` the same trials from the same numpy draws, ``best_hyperparams``
the same pick, ``tune`` the same constructor and ``train`` keywords,
``cross_validate`` the same folds. The drivers' ``tune`` / ``train`` are
swapped for recorders where only the plumbing is compared; small real runs
check that the port's drivers train."""

import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.training import tune as jax_tune
from easyhybrid_tpu_torch.training import tune as tune_mod


@pytest.mark.parametrize("n,k,shuffle,seed", [
    (10, 3, True, 0), (700, 4, True, 1), (300, 5, False, None), (1, 2, True, 3),
    (20_000, 5, True, 0), (17, 17, True, 9),
])
def test_make_folds_equals_the_jax_packages(n, k, shuffle, seed):
    got = et.make_folds(range(n), k=k, shuffle=shuffle, seed=seed)
    want = eh.make_folds(range(n), k=k, shuffle=shuffle, seed=seed)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


class _Result:
    def __init__(self, best_loss):
        self.best_loss = best_loss


def _score(overrides):
    """A deterministic stand-in for a trial's best loss."""
    return float(sum(sum(map(ord, str(v))) for v in overrides.values()) % 13) / 13.0


def _record(calls):
    def fake(model, data, mspec=None, **kwargs):
        calls.append((mspec, kwargs))
        merged = {**(mspec.hyper_model if mspec else {}), **(mspec.hyper_train if mspec else {})}
        return _Result(_score({k: v for k, v in merged.items() if k != "nepochs"}))

    return fake


SPACE = {
    "learning_rate": lambda rng: float(10 ** rng.uniform(-4, -1)),
    "hidden_layers": [[8], [16, 16], [32]],
    "activation": ("tanh", "swish"),
    "batchsize": 64,
}


@pytest.mark.parametrize("seed,n_trials", [(0, 5), (3, 8)])
def test_random_search_draws_the_jax_packages_trials(monkeypatch, seed, n_trials):
    got_calls, want_calls = [], []
    monkeypatch.setattr(tune_mod, "tune", _record(got_calls))
    monkeypatch.setattr(jax_tune, "tune", _record(want_calls))
    got = tune_mod.random_search(None, None, SPACE, n_trials=n_trials, seed=seed, nepochs=2)
    want = jax_tune.random_search(None, None, SPACE, n_trials=n_trials, seed=seed, nepochs=2)
    assert [ov for ov, _ in got[1]] == [ov for ov, _ in want[1]]
    assert got[0] == want[0]
    for (gm, gk), (wm, wk) in zip(got_calls, want_calls):
        assert gm.hyper_model == wm.hyper_model and gm.hyper_train == wm.hyper_train
        assert gk == wk


def test_grid_search_walks_the_jax_packages_grid(monkeypatch):
    got_calls, want_calls = [], []
    monkeypatch.setattr(tune_mod, "tune", _record(got_calls))
    monkeypatch.setattr(jax_tune, "tune", _record(want_calls))
    space = {"learning_rate": [0.01, 0.001], "activation": ["tanh", "relu"], "input_batchnorm":
             [True, "static"]}
    got = tune_mod.grid_search(None, None, space, loss_types=["r2", "mse"])
    want = jax_tune.grid_search(None, None, space, loss_types=["r2", "mse"])
    assert [ov for ov, _ in got[1]] == [ov for ov, _ in want[1]] and len(got[1]) == 8
    assert got[0] == want[0]
    assert [c[0].hyper_model for c in got_calls] == [c[0].hyper_model for c in want_calls]


@pytest.mark.parametrize("metric", ["mse", "r2", "nse", "kge", "mae"])
def test_best_hyperparams_picks_as_the_jax_package(metric):
    trials = [({"i": i}, _Result(v)) for i, v in enumerate([0.3, 0.1, 0.7, 0.1, 0.5])]
    assert et.best_hyperparams(trials, metric) == jax_tune.best_hyperparams(trials, metric)


@pytest.mark.parametrize("kwargs", [
    {}, {"loss_types": ["r2"]}, {"training_loss": "nseLoss"},
    {"loss_types": [], "training_loss": "mae"},
])
def test_trial_metric_and_the_split_of_overrides(kwargs):
    assert tune_mod._trial_metric(kwargs) == jax_tune._trial_metric(kwargs)
    overrides = {"hidden_layers": [8], "activation": "tanh", "learning_rate": 0.1,
                 "scale_nn_outputs": True, "start_from_default": False, "nepochs": 3}
    got = tune_mod._split_overrides(None, overrides)
    want = jax_tune._split_overrides(None, overrides)
    assert (got.hyper_model, got.hyper_train) == (want.hyper_model, want.hyper_train)


SPEC = dict(predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
            parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
            neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[8, 4],
            activation="tanh", scale_nn_outputs=True, input_batchnorm="static")


def _rbq10(*, ta, rb, Q10):
    return {"reco": rb * Q10 ** (0.1 * (ta - 15.0))}


@pytest.mark.parametrize("multi", [False, True])
def test_model_to_kwargs_and_tunes_merge_equal_the_jax_packages(monkeypatch, multi):
    spec = dict(SPEC)
    if multi:
        spec.update(predictors={"rb": ["sw_pot"], "Q10": ["dsw_pot"]}, global_param_names=[],
                    activation={"rb": "tanh", "Q10": "swish"})
    jm = eh.construct_hybrid_model(mechanistic_model=_rbq10, **spec)
    tm = et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu", **spec)
    got, want = tune_mod.model_to_kwargs(tm), jax_tune.model_to_kwargs(jm)
    assert set(got) == set(want)
    for k in want:
        if k not in ("mechanistic_model", "parameters"):
            assert got[k] == want[k], k
    assert got["parameters"].names == tuple(want["parameters"].names)
    # tune: the model rebuilt with the overrides, train given hyper_train then kwargs
    built, trained = [], []
    monkeypatch.setattr(tune_mod, "construct_hybrid_model",
                        lambda **kw: built.append(kw) or et.construct_hybrid_model(**kw))
    monkeypatch.setattr(tune_mod, "train", lambda m, d, **kw: trained.append((m, kw)) or "r")
    mspec = et.ModelSpec(hyper_model={"hidden_layers": [4]},
                         hyper_train={"nepochs": 3, "batchsize": 16})
    assert et.tune(tm, None, mspec, batchsize=32, random_seed=5) == "r"
    jbuilt, jtrained = [], []
    monkeypatch.setattr(jax_tune, "construct_hybrid_model",
                        lambda **kw: jbuilt.append(kw) or eh.construct_hybrid_model(**kw))
    monkeypatch.setattr(jax_tune, "train", lambda m, d, **kw: jtrained.append((m, kw)) or "r")
    jax_tune.tune(jm, None, mspec, batchsize=32, random_seed=5)
    assert trained[0][1] == jtrained[0][1] == {"nepochs": 3, "batchsize": 32, "random_seed": 5}
    assert built[0]["hidden_layers"] == jbuilt[0]["hidden_layers"] == [4]
    assert built[0]["device"] == tm.device
    assert {k for k in built[0] if k not in ("device", "generator")} == set(jbuilt[0])


def test_cross_validate_trains_the_jax_packages_folds(monkeypatch):
    got, want = [], []
    monkeypatch.setattr(tune_mod, "train",
                        lambda m, d, **kw: got.append((m, kw)) or _Result(len(got)))
    monkeypatch.setattr(jax_tune, "train",
                        lambda m, d, **kw: want.append(kw) or _Result(len(want)))
    cols = et.rbq10_columns(103, seed=1)
    model = et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu", **SPEC)
    scores, _ = et.cross_validate(model, cols, k=4, seed=7, nepochs=2)
    jscores, _ = jax_tune.cross_validate(None, eh.gen_rbq10_data(103, seed=1), k=4, seed=7,
                                         nepochs=2)
    assert scores == jscores == [1, 2, 3, 4]
    for (m, kw), wkw in zip(got, want):
        np.testing.assert_array_equal(kw.pop("folds"), wkw.pop("folds"))
        assert kw == wkw
        assert m is not model  # each fold trains a copy, from the same parameters
        assert all(torch.equal(a, b) for a, b in zip(m.parameters(), model.parameters()))


def test_the_drivers_train_on_the_port():
    cols = et.rbq10_columns(300, seed=2)
    model = et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu", **SPEC)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kw = dict(nepochs=2, batchsize=64, show_progress=False)
    best, trials = et.random_search(model, cols, {"optimizer": [("adam", 0.01), ("adam", 0.05)],
                                                  "hidden_layers": [[4], [8]]},
                                    n_trials=2, seed=0, **kw)
    assert best in [ov for ov, _ in trials] and all(np.isfinite(r.best_loss) for _, r in trials)
    best, trials = et.grid_search(model, cols, {"optimizer": [("adam", 0.01), ("sgd", 0.05)]},
                                  **kw)
    assert len(trials) == 2
    # a rebuilt model draws from torch.Generator(random_seed): two trials of one
    # configuration give the same result
    a = et.tune(model, cols, et.ModelSpec(hyper_train={"optimizer": ("adam", 0.02)}), **kw)
    b = et.tune(model, cols, et.ModelSpec(hyper_train={"optimizer": ("adam", 0.02)}), **kw)
    assert a.best_loss == b.best_loss
    scores, results = et.cross_validate(model, cols, k=3, **kw)
    assert len(scores) == 3 and all(np.isfinite(scores))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
