"""The whole serving slice: the port's make_inference_fn / predict against
the JAX package's, on the quick-start model with the JAX weights carried
across: the same keys and values (rtol=1e-5, atol=1e-6, float32), a ragged
row count, NaN predictor rows, and the engine choice on CPU."""

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm

RTOL, ATOL = 1e-5, 1e-6


def _spec(**kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=[16, 16], activation="swish",
        scale_nn_outputs=True, input_batchnorm="static",
    )
    spec.update(kw)
    return spec


def _pair(spec, df, seed=0):
    jm = eh.construct_hybrid_model(**spec)
    params, state = jm.init(jax.random.PRNGKey(seed))
    state = jax_fit_input_norm(jm, state, eh.prepare_data(jm, df))
    tm = et.construct_hybrid_model(**spec)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jm, params, state, tm


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,batch_size", [(1000, 256), (300, 1024), (512, 128)])
def test_predict_matches_jax(n, batch_size):
    df = eh.gen_rbq10_data(n, seed=4, nan_frac=0.1)
    jm, params, state, tm = _pair(_spec(), df)
    rng = np.random.default_rng(n)
    df.loc[rng.choice(n, 7, replace=False), "sw_pot"] = np.nan  # NaN predictor rows
    want = eh.predict(jm, params, state, df, batch_size=batch_size)
    fn = et.make_inference_fn(tm, batch_size=batch_size)
    got = fn(df)
    assert set(got) == {"reco", "rb"}
    _assert_same(got, want)
    assert np.isnan(got["reco"]).sum() == 7
    assert fn.engine == "torch"
    assert "cpu" in fn.engine_reason


def test_predict_inputs_agree():
    """A DataFrame, a dict of columns and a HybridData give the same result."""
    cols = et.rbq10_columns(333, seed=9)
    tm = et.construct_hybrid_model(**_spec(), generator=torch.Generator().manual_seed(2))
    et.fit_input_norm(tm, et.prepare_data(tm, cols))
    a = et.predict(tm, cols, batch_size=100)
    b = et.predict(tm, et.gen_rbq10_data(333, seed=9), batch_size=100)
    c = et.predict(tm, et.prepare_data(tm, cols, drop_missing_rows=False), batch_size=100)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])
    assert a["reco"].shape == (333,)


def test_predict_outside_the_envelope_matches_jax(rbq10_model, rbq10_df):
    """Trainable BatchNorm (the conftest fixture) runs the plain engine, in
    eval mode, and says why."""
    params, state = rbq10_model.init(jax.random.PRNGKey(1))
    tm = et.construct_hybrid_model(**_spec(hidden_layers=[8, 8], activation="tanh",
                                           input_batchnorm=True))
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    tm.train()
    want = eh.predict(rbq10_model, params, state, rbq10_df, batch_size=100)
    fn = et.make_inference_fn(tm, batch_size=100)
    got = fn(rbq10_df)
    _assert_same(got, want)
    assert fn.engine == "torch"
    assert "BatchNorm" in fn.engine_reason
    assert tm.training  # the mode is restored
    np.testing.assert_array_equal(tm.nn.norm.mean.numpy(), np.asarray(state["nn"]["norm"]["mean"]))


def test_untagged_model_matches_jax():
    """A plain Python mechanistic function (no kernel form) gives the same
    predictions through the plain engine."""
    def rbq10(*, ta, rb, Q10, tref=15.0):
        return {"reco": rb * Q10 ** (0.1 * (ta - tref))}

    df = eh.gen_rbq10_data(400, seed=8)
    jm, params, state, tm = _pair(_spec(mechanistic_model=rbq10), df)
    fn = et.make_inference_fn(tm, batch_size=128)
    assert "no kernel form" in fn.engine_reason
    _assert_same(fn(df), eh.predict(jm, params, state, df, batch_size=128))
