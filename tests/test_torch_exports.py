"""The port's public surface against the JAX package's: every name of
``easyhybrid_tpu.__all__`` is either exported by ``easyhybrid_tpu_torch`` or
stands in the not-yet table below with the ``ROADMAP.md`` queue A item that
ports it, so "how much of the surface is ported" is a number. Also the numpy
generators the two packages share, value for value."""

import numpy as np
import pytest

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et

# name -> the item of ROADMAP.md's queue A ("Modules still to port") that brings it
NOT_YET = {
    **dict.fromkeys(["MultiNNHybridModel", "make_hybrid", "CustomHybridModel", "format_model",
                     "format_parameter_table"], 4),
    **dict.fromkeys(["LinearHM", "RespirationRbQ10", "RsComponents", "RbQ10TwoParams",
                     "FluxPartModelQ10", "m_rb_q10"], 10),
    **dict.fromkeys(["ModelSpec", "tune", "best_hyperparams", "random_search", "grid_search",
                     "cross_validate", "population_train", "population_cross_validate",
                     "PopulationResults"], 14),
    "ensemble_predict": 9,
    **dict.fromkeys(["make_mesh", "shard_batch", "replicate"], 15),
    **dict.fromkeys(["get_full_config", "save_hybrid_config", "load_hybrid_config",
                     "TrainingPaths", "resolve_paths", "make_folds", "WrappedTuples",
                     "print_banner", "load_timeseries_netcdf", "is_xarray_like",
                     "load_timeseries_xarray", "to_dataset", "xarray_to_dataframe"], 1),
    **dict.fromkeys(["save_pytree", "load_pytree", "load_checkpoint", "load_group",
                     "get_all_groups", "hybrid_colors", "set_theme", "theme_easy_hybrid",
                     "use_theme", "plot_population", "trace", "StepTimer", "debug_nans",
                     "assert_sharding"], 16),
}
QUEUE_A_ITEMS = {1, 4, 6, 8, 9, 10, 12, 14, 15, 16, 17, 18}


@pytest.mark.parametrize("name", eh.__all__)
def test_every_reference_name_is_exported_or_queued(name):
    if name in et.__all__:
        assert hasattr(et, name) and name not in NOT_YET
    else:
        assert NOT_YET.get(name) in QUEUE_A_ITEMS, f"{name}: neither exported nor queued"


def test_the_not_yet_table_only_names_reference_names():
    assert set(NOT_YET) <= set(eh.__all__)
    assert len(set(et.__all__)) == len(et.__all__)
    ported = [n for n in eh.__all__ if n in et.__all__]
    assert len(ported) + len(NOT_YET) == len(eh.__all__) == 110
    assert len(ported) == 59  # grows as names are ported; 38 before the 19 + 2 names of queue A item 19


@pytest.mark.parametrize("name", [
    "TrainingHistory", "EpochSnapshot", "EarlyStopping", "resolve_optimizer", "compute_loss",
    "validate_config", "split_into_sequences", "filter_sequences", "train_val_indices",
    "prepare_splits", "batch_iterator", "masked_mean", "check_training_loss", "SymbolicLoss",
    "FunctionLoss", "ParameterizedLoss", "ExtraLoss", "extract_weights", "weight_l2",
    "gen_linear_data", "gen_linear_data_2outputs",
])
def test_item_19_names_come_from_the_ports_own_modules(name):
    obj = getattr(et, name)
    assert obj.__module__.startswith("easyhybrid_tpu_torch.")
    assert callable(obj) and callable(getattr(eh, name))


@pytest.mark.parametrize("gen,n,seed", [
    ("gen_linear_data", 1000, 123), ("gen_linear_data", 40, 5),
    ("gen_linear_data_2outputs", 1000, 123), ("gen_linear_data_2outputs", 90, 7),
])
def test_linear_generators_match_the_reference(gen, n, seed):
    """Both draw from ``np.random.default_rng(seed)`` in the same order: the
    frames are equal value for value, column for column, dtype for dtype."""
    got, want = getattr(et, gen)(n, seed=seed), getattr(eh, gen)(n, seed=seed)
    assert list(got.columns) == list(want.columns) and len(got) == n
    for col in want.columns:
        assert got[col].dtype == want[col].dtype
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())


def test_root_exports_work_through_the_package_root():
    import torch

    t = torch.tensor([[1.0, 2.0], [3.0, 0.0]])
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    assert float(et.masked_mean(t, mask)) == pytest.approx(2.0)
    data = et.HybridData(x=np.arange(40, dtype=np.float32).reshape(20, 2),
                         forcing={"ta": np.arange(20, dtype=np.float32)},
                         y={"obs": np.arange(20, dtype=np.float32)})
    seqs = et.split_into_sequences(data, input_window=4, output_window=1, lead_time=0)
    assert seqs.x.shape[1:] == (4, 2) and seqs.y["obs"].shape[1] == 1
    opt = et.resolve_optimizer(("adam", 0.01))
    assert hasattr(opt, "init") and hasattr(opt, "update")
    assert et.SymbolicLoss("mse").name == "mse"
