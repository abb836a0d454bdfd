"""The port's split_data against the JAX package's: the same rows in the
same order for the chronological and the seeded random fraction split, by
id and by folds, and the windowing helpers. numpy only on both sides, so
the arrays must be equal."""

import numpy as np
import pytest

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data import split as jsplit
from easyhybrid_tpu_torch.data import split as tsplit

SPEC = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
    parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
    neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[4],
)


def _models():
    return (eh.construct_hybrid_model(mechanistic_model=et.rbq10, **SPEC),
            et.construct_hybrid_model(mechanistic_model=et.rbq10, **SPEC))


def _cols(n=300):
    cols = et.rbq10_columns(n, seed=11, nan_frac=0.1)
    cols["sw_pot"][::37] = np.nan  # rows the NaN filter drops
    rng = np.random.default_rng(11)
    cols["site"] = rng.integers(0, 9, n)
    cols["fold"] = rng.integers(1, 5, n)
    return cols


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        for k in w.forcing:
            np.testing.assert_array_equal(g.forcing[k], w.forcing[k])
        for k in w.y:
            np.testing.assert_array_equal(g.y[k], w.y[k])


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(split_data_at=0.7),
    dict(shuffleobs=True, seed=5),
    dict(shuffleobs=True, seed=6, split_data_at=0.5),
    dict(split_by_id="site"),
    dict(split_by_id="site", shuffleobs=True, seed=3),
    dict(folds="fold", val_fold=2),
], ids=str)
def test_split_matches_jax(kwargs):
    jm, tm = _models()
    cols = _cols()
    _assert_same(tsplit.split_data(cols, tm, **kwargs), jsplit.split_data(cols, jm, **kwargs))


def test_split_from_a_dataframe_and_arrays():
    jm, tm = _models()
    cols = _cols()
    df = et.gen_rbq10_data(300, seed=11)
    _assert_same(et.split_data(df, tm, shuffleobs=True, seed=1),
                 jsplit.split_data(df, jm, shuffleobs=True, seed=1))
    folds = np.asarray(cols["fold"])
    _assert_same(tsplit.split_data(cols, tm, folds=folds, val_fold=3),
                 jsplit.split_data(cols, jm, folds=folds, val_fold=3))


def test_train_val_indices_and_sequence_kwargs():
    for args in [(10, dict(at=0.8)), (17, dict(at=0.5, shuffle=True, seed=2))]:
        for a, b in zip(tsplit.train_val_indices(args[0], **args[1]),
                        jsplit.train_val_indices(args[0], **args[1])):
            np.testing.assert_array_equal(a, b)
    for cfg in [et.DataConfig(), et.DataConfig(sequence_length=5),
                et.DataConfig(sequence_kwargs={"output_window": 2}, sequence_length=4)]:
        assert tsplit.merged_sequence_kwargs(cfg) == jsplit.merged_sequence_kwargs(cfg)


def test_split_errors():
    _, tm = _models()
    cols = _cols()
    with pytest.raises(ValueError, match="not supported together"):
        tsplit.split_data(cols, tm, split_by_id="site", folds="fold", val_fold=1)
    with pytest.raises(ValueError, match="both folds and val_fold"):
        tsplit.split_data(cols, tm, folds="fold")
    with pytest.raises(ValueError, match="out of range"):
        tsplit.split_data(cols, tm, folds="fold", val_fold=9)


def test_sequence_windows_match_jax():
    from easyhybrid_tpu.data import sequences as jseq
    from easyhybrid_tpu_torch.data import sequences as tseq

    jm, tm = _models()
    cols = et.rbq10_columns(60, seed=2, nan_frac=0.2)
    data = et.prepare_data(tm, cols, drop_missing_rows=False)
    kw = dict(input_window=5, output_window=2, output_shift=2, lead_time=1)
    got = tseq.filter_sequences(tseq.split_into_sequences(data, **kw))
    want = jseq.filter_sequences(jseq.split_into_sequences(eh.prepare_data(jm, cols, drop_missing_rows=False), **kw))
    _assert_same([got], [want])
