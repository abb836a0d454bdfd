"""The port's losses against the JAX package's: every registry metric on
the same masked inputs (with NaN targets), the elementwise losses,
``compute_loss`` in train and eval modes on the quick-start model with the
JAX parameters carried across, and the direction traits and names.
Tolerance: rtol 1e-5, atol 1e-6, float32 (masked reductions in another
summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.losses import compute as jcompute
from easyhybrid_tpu.losses import metrics as jmetrics
from easyhybrid_tpu.losses import specs as jspecs
from easyhybrid_tpu_torch.losses import compute as tcompute
from easyhybrid_tpu_torch.losses import metrics as tmetrics
from easyhybrid_tpu_torch.losses import specs as tspecs

RTOL, ATOL = 1e-5, 1e-6
NAMES = sorted(k for k in jmetrics.METRICS if k.isascii())


def _inputs(seed=0, n=257):
    rng = np.random.default_rng(seed)
    y = (2.0 + rng.standard_normal(n)).astype(np.float32)
    yh = (y + 0.3 * rng.standard_normal(n)).astype(np.float32)
    y[rng.random(n) < 0.2] = np.nan
    mask = np.isfinite(y).astype(np.float32)
    mask[-10:] = 0.0  # padding rows
    return yh, y, mask


@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_jax(name):
    yh, y, mask = _inputs()
    want = float(jmetrics.loss_fn(jnp.asarray(yh), jnp.asarray(y), jnp.asarray(mask), name))
    got = float(tmetrics.loss_fn(torch.from_numpy(yh), torch.from_numpy(y), torch.from_numpy(mask), name))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # no mask: finiteness decides
    want = float(jmetrics.loss_fn(jnp.asarray(yh), jnp.asarray(y), None, name))
    got = float(tmetrics.loss_fn(torch.from_numpy(yh), torch.from_numpy(y), None, name))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("make", ["pinball", "huber"])
def test_elementwise_losses_match_jax(make):
    yh, y, mask = _inputs(1)
    jl, tl = getattr(jmetrics, make)(0.3), getattr(tmetrics, make)(0.3)
    want = float(jl(jnp.asarray(yh), jnp.asarray(y), jnp.asarray(mask)))
    got = float(tl(torch.from_numpy(yh), torch.from_numpy(y), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tspecs.loss_name(tl) == jspecs.loss_name(jl)


def test_sigma_targets_neutralise_masked_rows():
    yh, y, mask = _inputs(2)
    sigma = np.where(np.isfinite(y), 0.5, np.nan).astype(np.float32)

    def jf(a, b, m, sigma):
        return jnp.sum(((a - b) / sigma) ** 2 * m)

    def tf(a, b, m, sigma):
        return torch.sum(((a - b) / sigma) ** 2 * m)

    want = float(jmetrics.loss_fn(jnp.asarray(yh), (jnp.asarray(y), jnp.asarray(sigma)), jnp.asarray(mask), jf))
    got = float(tmetrics.loss_fn(torch.from_numpy(yh), (torch.from_numpy(y), torch.from_numpy(sigma)),
                                 torch.from_numpy(mask), tf))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="does not support"):
        tmetrics.loss_fn(torch.from_numpy(yh), (torch.from_numpy(y), torch.from_numpy(sigma)), None, "mse")


def _models(input_batchnorm=True):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[8, 8],
        activation="tanh", scale_nn_outputs=True, input_batchnorm=input_batchnorm,
    )
    jm = eh.construct_hybrid_model(**spec)
    params, state = jm.init(jax.random.PRNGKey(3))
    tm = et.construct_hybrid_model(**spec)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jm, params, state, tm


def _batch(n=300, seed=5):
    cols = et.rbq10_columns(n, seed=seed, nan_frac=0.25)
    x = np.stack([cols["sw_pot"], cols["dsw_pot"]], -1)
    y = cols["reco"]
    mask = np.isfinite(y).astype(np.float32)
    y = np.where(mask > 0, y, 0.0).astype(np.float32)
    return x, cols["ta"], y, mask


@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("training_loss", ["mse", "nseLoss", "kgeLoss"])
def test_compute_loss_train_mode_matches_jax(agg, training_loss):
    jm, params, state, tm = _models()
    x, ta, y, mask = _batch()
    jbatch = ((jnp.asarray(x), {"ta": jnp.asarray(ta)}), ({"reco": jnp.asarray(y)}, {"reco": jnp.asarray(mask)}))
    tbatch = ((torch.from_numpy(x), {"ta": torch.from_numpy(ta)}),
              ({"reco": torch.from_numpy(y)}, {"reco": torch.from_numpy(mask)}))
    extra_j, extra_t = eh.l2_extra_loss(0.01), et.l2_extra_loss(0.01)
    jl = jspecs.LoggingLoss(training_loss=training_loss, agg=agg, extra_loss=extra_j)
    tl = tspecs.LoggingLoss(training_loss=training_loss, agg=agg, extra_loss=extra_t)
    want, new_state = jcompute.compute_loss(jm, params, state, jbatch, jl)
    got = tcompute.compute_loss(tm, tbatch, tl)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    # training mode moved the BatchNorm running statistics as JAX's new_state
    np.testing.assert_allclose(tm.nn.norm.mean.numpy(), np.asarray(new_state["nn"]["norm"]["mean"]),
                               rtol=RTOL, atol=ATOL)


def test_compute_loss_eval_mode_matches_jax():
    jm, params, state, tm = _models()
    x, ta, y, mask = _batch(seed=6)
    jbatch = ((jnp.asarray(x), {"ta": jnp.asarray(ta)}), ({"reco": jnp.asarray(y)}, {"reco": jnp.asarray(mask)}))
    tbatch = ((torch.from_numpy(x), {"ta": torch.from_numpy(ta)}),
              ({"reco": torch.from_numpy(y)}, {"reco": torch.from_numpy(mask)}))
    types = ("mse", "r2", "kge", "pearson")
    want, _, jout = jcompute.compute_loss(jm, params, state, jbatch,
                                          jspecs.LoggingLoss(loss_types=types, train_mode=False))
    tm.train()
    got, tout = tcompute.compute_loss(tm, tbatch, tspecs.LoggingLoss(loss_types=types, train_mode=False))
    assert tm.training  # the mode is restored
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]) == {"reco", "sum"}
        for k in want[name]:
            np.testing.assert_allclose(float(got[name][k]), float(want[name][k]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout["reco"].numpy(), np.asarray(jout["reco"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "spec", ["mse", "r2", "nse", "kgeLoss", "pearson", "pbkge", "alpha", "β"]
)
def test_direction_and_names_match_jax(spec):
    assert tmetrics.best_direction(spec) == jmetrics.best_direction(spec)
    assert tmetrics.best_direction(tspecs.SymbolicLoss(spec)) == jmetrics.best_direction(jspecs.SymbolicLoss(spec))
    assert tmetrics.is_better(0.4, 0.5, spec) == jmetrics.is_better(0.4, 0.5, spec)
    assert tspecs.loss_name(tspecs.to_loss_spec(spec)) == jspecs.loss_name(jspecs.to_loss_spec(spec))


def test_training_loss_check_and_custom_metrics():
    with pytest.raises(ValueError, match="maximized"):
        tmetrics.check_training_loss("nse")
    tmetrics.check_training_loss("nseLoss")

    def skill(yh, y, m):
        return 1.0 - tmetrics.masked_mean(torch.abs(yh - y), m)

    tmetrics.register_metric("skill_torch_test", skill, maximize=True)
    try:
        assert tmetrics.best_direction("skill_torch_test") == "max"
        yh, y, mask = _inputs(3)
        v = tmetrics.loss_fn(torch.from_numpy(yh), torch.from_numpy(y), torch.from_numpy(mask), "skill_torch_test")
        assert torch.isfinite(v)
    finally:
        tmetrics.METRICS.pop("skill_torch_test")
        tmetrics.MAXIMIZE_METRICS.discard("skill_torch_test")
    ll = tspecs.LoggingLoss(loss_types="mse", agg="mean")
    assert ll.loss_types == ("mse",) and ll.agg_name == "mean"
    assert tspecs.loss_name(tspecs.PerTarget(["mse", "mae"])) == "per_target"
