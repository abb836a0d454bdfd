"""Port parity: the port's numpy data modules (synthetic RbQ10 data,
prepare_data, padding and epoch tensors) and its static-norm fit against
the JAX package's."""

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_build_epoch_tensors
from easyhybrid_tpu.data.loaders import pad_axis0 as jax_pad_axis0
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm

SPEC = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
    mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
    neural_param_names=["rb"], global_param_names=["Q10"],
    hidden_layers=[16, 16], activation="swish",
    scale_nn_outputs=True, input_batchnorm="static",
)


@pytest.mark.parametrize("kwargs", [dict(seed=42), dict(seed=3, nan_frac=0.2, true_q10=1.7)])
def test_rbq10_data_matches_jax(kwargs):
    want = eh.gen_rbq10_data(777, **kwargs)
    cols = et.rbq10_columns(777, **kwargs)
    got = et.gen_rbq10_data(777, **kwargs)
    assert list(cols) == list(want.columns) == list(got.columns)
    for c in want.columns:
        np.testing.assert_array_equal(cols[c], want[c].to_numpy())
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy())


@pytest.mark.parametrize("drop", [True, False])
def test_prepare_data_matches_jax(drop):
    df = eh.gen_rbq10_data(200, seed=1, nan_frac=0.2)
    df.loc[[4, 9], "ta"] = np.nan
    df.loc[[11], "sw_pot"] = np.nan
    jm, tm = eh.construct_hybrid_model(**SPEC), et.construct_hybrid_model(**SPEC)
    want = eh.prepare_data(jm, df, drop_missing_rows=drop)
    for data in (df, {c: df[c].to_numpy() for c in df.columns}):
        got = et.prepare_data(tm, data, drop_missing_rows=drop)
        np.testing.assert_array_equal(got.x, want.x)
        for part in ("forcing", "y"):
            assert list(getattr(got, part)) == list(getattr(want, part))
            for k in getattr(want, part):
                np.testing.assert_array_equal(getattr(got, part)[k], getattr(want, part)[k])
    with pytest.raises(TypeError, match="DataFrame"):
        et.prepare_data(tm, [1, 2, 3])


@pytest.mark.parametrize("batch", [None, 64, 128])
def test_epoch_tensors_and_padding_match_jax(batch):
    df = eh.gen_rbq10_data(300, seed=2, nan_frac=0.1)
    data = eh.prepare_data(eh.construct_hybrid_model(**SPEC), df)
    want = jax_build_epoch_tensors(data, batch)
    got = et.build_epoch_tensors(data, batch)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.weight, want.weight)
    for k in want.y:
        np.testing.assert_array_equal(got.y[k], want.y[k])
        np.testing.assert_array_equal(got.mask[k], want.mask[k])
    assert got.n_samples == want.n_samples and got.num_batches == want.num_batches
    np.testing.assert_array_equal(et.pad_axis0(data.x[:50], 64), jax_pad_axis0(data.x[:50], 64))


def test_fit_input_norm_matches_jax():
    df = eh.gen_rbq10_data(500, seed=6)
    jm = eh.construct_hybrid_model(**SPEC)
    data = eh.prepare_data(jm, df)
    _, state = jm.init(jax.random.PRNGKey(0))
    want = jax_fit_input_norm(jm, state, data)["nn"]["norm"]
    tm = et.construct_hybrid_model(**SPEC)
    et.fit_input_norm(tm, data)
    np.testing.assert_allclose(tm.nn.norm.mean.numpy(), np.asarray(want["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tm.nn.norm.var.numpy(), np.asarray(want["var"]), rtol=1e-6)
    # constant column: variance floored at 1e-12
    const = eh.prepare_data(jm, df.assign(dsw_pot=1.0))
    et.fit_input_norm(tm, const)
    assert tm.nn.norm.var[1].item() == pytest.approx(1e-12)
    # a model without a static norm is left alone
    bn = et.construct_hybrid_model(**{**SPEC, "input_batchnorm": True})
    et.fit_input_norm(bn, data)
    assert torch.equal(bn.nn.norm.mean, torch.zeros(2))
