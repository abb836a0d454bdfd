"""Sequence windowing for recurrent hybrid models.

A numpy-only copy of ``easyhybrid_tpu/data/sequences.py``: the same
``input_window`` / ``output_window`` / ``output_shift`` / ``lead_time``
semantics, batch-major windows ``(num_samples, time, features)``, which
``split_data(sequence_kwargs=...)`` makes for the recurrent hybrids
(``hidden_layers={"lstm": H}``, ``models/nn.py::LSTMNet``) that ``train()``
runs on the torch engine or on kernel 4 (``ops/fused_epoch_lstm.py``).
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np

from .prepare import HybridData

__all__ = ["split_into_sequences", "filter_sequences", "window_starts"]

log = logging.getLogger("easyhybrid_tpu_torch")


def window_starts(
    length: int,
    input_window: int,
    output_window: int,
    output_shift: int,
    lead_time: int,
) -> np.ndarray:
    """Valid 0-based window start indices.

    0-based translation of reference sequences.jl:210-216: a window starting
    at ``sx`` spans inputs ``[sx, sx+input_window)``; its target window ends
    ``lead_time`` steps after the last input and spans ``output_window``
    steps backwards from there.
    """
    if lead_time < 0:
        raise ValueError("lead_time must be >= 0 (0 = instantaneous end)")
    sx_min = max(0, output_window - input_window - lead_time)
    sx_max = length - input_window - lead_time  # inclusive
    if sx_min > sx_max:
        raise ValueError(
            f"windows too long for series length {length} "
            f"(input_window={input_window}, lead_time={lead_time})"
        )
    starts = np.arange(sx_min, sx_max + 1, output_shift)
    if len(starts) == 0:
        raise ValueError("no samples with given output_shift/windows")
    return starts


def _window_2d(arr: np.ndarray, starts: np.ndarray, width: int, offset: int = 0):
    """Gather windows ``arr[s+offset : s+offset+width]`` for each start →
    ``(num_samples, width, ...)``. Uses sliding_window_view (no copy until
    the fancy-index gather)."""
    arr = np.asarray(arr)
    sw = np.lib.stride_tricks.sliding_window_view(arr, width, axis=0)
    # sw shape: (L - width + 1, ..., width) with window axis last
    out = sw[starts + offset]
    # move window axis right after samples: (S, width, features...)
    return np.moveaxis(out, -1, 1).astype(np.float32)


def split_into_sequences(
    data: HybridData,
    *,
    input_window: int = 10,
    output_window: int = 1,
    output_shift: int = 1,
    lead_time: int = 1,
) -> HybridData:
    """Window a time-ordered :class:`HybridData` into sequence samples.

    * predictors ``(L, F)`` → ``(S, input_window, F)`` (dict branches each)
    * forcing ``(L,)`` → ``(S, input_window)``
    * targets ``(L,)`` → ``(S, output_window)``
    """
    x = data.x
    ref = next(iter(x.values())) if isinstance(x, Mapping) else x
    length = np.shape(ref)[0]
    starts = window_starts(length, input_window, output_window, output_shift, lead_time)

    # target window: last input index is s+input_window-1; target end index
    # is that + lead_time; target start = end - output_window + 1.
    y_offset = input_window + lead_time - output_window

    if isinstance(x, Mapping):
        x_seq = {k: _window_2d(v, starts, input_window) for k, v in x.items()}
    else:
        x_seq = _window_2d(x, starts, input_window)
    forcing_seq = {
        k: _window_2d(v, starts, input_window) for k, v in data.forcing.items()
    }
    y_seq = {k: _window_2d(v, starts, output_window, y_offset) for k, v in data.y.items()}
    return HybridData(x=x_seq, forcing=forcing_seq, y=y_seq)


def filter_sequences(data: HybridData) -> HybridData:
    """Drop sequence samples with any NaN predictor or all-NaN targets.

    Parity: reference ``filter_sequences`` (sequences.jl:9-66)."""
    x = data.x
    if isinstance(x, Mapping):
        pred_ok = np.ones(data.n_samples, bool)
        for v in x.values():
            pred_ok &= ~np.any(np.isnan(v), axis=tuple(range(1, np.ndim(v))))
    else:
        pred_ok = ~np.any(np.isnan(x), axis=tuple(range(1, np.ndim(x))))

    target_ok = np.zeros(data.n_samples, bool)
    for v in data.y.values():
        target_ok |= np.any(~np.isnan(v), axis=tuple(range(1, np.ndim(v))))

    valid = pred_ok & target_ok
    n, kept = len(valid), int(valid.sum())
    if kept < n:
        log.info(
            "Dropped %d / %d sequences with NaN predictors or all-NaN targets",
            n - kept,
            n,
        )
    return data.take(np.nonzero(valid)[0])
