"""Train/validation splitting.

A numpy-only copy of ``easyhybrid_tpu/data/split.py``: by-ID grouping,
external k-fold assignment with ``val_fold``, and the random or
chronological fraction split, with optional sequence windowing before the
split and pre-split tuple pass-through. The same seed gives the same
indices as the JAX package (both use ``numpy.random.default_rng``).
xarray input is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .prepare import HybridData, _is_dataframe, prepare_data
from .sequences import filter_sequences, split_into_sequences

__all__ = ["split_data", "prepare_splits", "train_val_indices", "merged_sequence_kwargs"]

log = logging.getLogger("easyhybrid_tpu_torch")


def train_val_indices(
    n: int,
    *,
    at: float = 0.8,
    shuffle: bool = False,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fraction split of ``range(n)``; chronological unless ``shuffle``."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    n_train = int(round(n * at))
    return idx[:n_train], idx[n_train:]


def _column_vector(data, name):
    if _is_dataframe(data) or isinstance(data, Mapping):
        return np.asarray(data[name])
    raise TypeError(
        f"cannot look up column {name!r} in {type(data).__name__}; pass the "
        "id/fold assignments as an array instead"
    )


def _align(vec, keep, n: int, what: str) -> np.ndarray:
    """Drop the entries of rows removed by the NaN filter."""
    if keep is not None and len(vec) == len(keep) and len(vec) != n:
        vec = vec[keep]
    if len(vec) != n:
        raise ValueError(
            f"{what} length {len(vec)} != prepared sample count {n}; pass "
            "pre-filtered data or the values of kept rows"
        )
    return vec


def split_data(
    data,
    model,
    *,
    split_by_id: Union[None, str, Sequence] = None,
    folds: Union[None, str, Sequence] = None,
    val_fold: Optional[int] = None,
    shuffleobs: bool = False,
    split_data_at: float = 0.8,
    sequence_kwargs: Optional[dict] = None,
    seed: Optional[int] = None,
) -> Tuple[HybridData, HybridData]:
    """Prepare ``data`` for ``model`` and split it into (train, val).
    A ``(train_HybridData, val_HybridData)`` tuple passes straight through."""
    if (
        isinstance(data, tuple)
        and len(data) == 2
        and all(isinstance(d, HybridData) for d in data)
    ):
        log.warning("data was prepared already; split_data keyword arguments ignored")
        return data

    prepared, keep = prepare_data(
        model, data, drop_missing_rows=(sequence_kwargs is None), return_keep=True
    )
    if sequence_kwargs is not None:
        defaults = dict(input_window=10, output_window=1, output_shift=1, lead_time=1)
        sk = {**defaults, **sequence_kwargs}
        prepared = filter_sequences(split_into_sequences(prepared, **sk))

    n = prepared.n_samples
    if split_by_id is not None and folds is not None:
        raise ValueError(
            "split_by_id and folds are not supported together; do the split "
            "when constructing folds"
        )

    if split_by_id is not None:
        if sequence_kwargs is not None:
            raise ValueError("split_by_id with sequence windows is not supported")
        ids = (
            _column_vector(data, split_by_id)
            if isinstance(split_by_id, str)
            else np.asarray(split_by_id)
        )
        ids = _align(ids, keep, n, "id vector")
        unique_ids = list(dict.fromkeys(ids.tolist()))
        tr_u, va_u = train_val_indices(
            len(unique_ids), at=split_data_at, shuffle=shuffleobs, seed=seed
        )
        train_ids = {unique_ids[i] for i in tr_u}
        val_ids = {unique_ids[i] for i in va_u}
        train_idx = np.array([i for i, v in enumerate(ids) if v in train_ids], dtype=np.intp)
        val_idx = np.array([i for i, v in enumerate(ids) if v in val_ids], dtype=np.intp)
        return prepared.take(train_idx), prepared.take(val_idx)

    if folds is not None or val_fold is not None:
        if folds is None or val_fold is None:
            raise ValueError("provide both folds and val_fold for k-fold splits")
        if shuffleobs:
            log.warning(
                "shuffleobs is ignored with folds/val_fold; shuffle at fold "
                "construction instead"
            )
        f = _column_vector(data, folds) if isinstance(folds, str) else np.asarray(folds)
        f = _align(f, keep, n, "folds")
        if not (1 <= val_fold <= int(f.max())):
            raise ValueError(f"val_fold={val_fold} out of range 1:{int(f.max())}")
        val_idx = np.nonzero(f == val_fold)[0]
        if len(val_idx) == 0:
            raise ValueError(f"no samples assigned to validation fold {val_fold}")
        train_idx = np.nonzero(f != val_fold)[0]
        return prepared.take(train_idx), prepared.take(val_idx)

    train_idx, val_idx = train_val_indices(n, at=split_data_at, shuffle=shuffleobs, seed=seed)
    return prepared.take(train_idx), prepared.take(val_idx)


def merged_sequence_kwargs(data_config) -> Optional[dict]:
    """``sequence_kwargs`` with ``input_window`` defaulting to
    ``sequence_length``; None when neither is set."""
    if not (
        getattr(data_config, "sequence_length", None)
        or getattr(data_config, "sequence_kwargs", None)
    ):
        return None
    sequence_kwargs = dict(data_config.sequence_kwargs or {})
    if data_config.sequence_length:
        sequence_kwargs.setdefault("input_window", data_config.sequence_length)
    return sequence_kwargs or None


def prepare_splits(data, model, data_config, *, seed: Optional[int] = None):
    """Map a :class:`DataConfig` onto :func:`split_data`."""
    return split_data(
        data,
        model,
        split_by_id=data_config.split_by_id,
        folds=data_config.folds,
        val_fold=data_config.val_fold,
        shuffleobs=data_config.shuffleobs,
        split_data_at=data_config.split_data_at,
        sequence_kwargs=merged_sequence_kwargs(data_config),
        seed=seed,
    )
