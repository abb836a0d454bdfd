"""Batching: padded epoch arrays + a host-side iterator.

A numpy-only copy of ``easyhybrid_tpu/data/loaders.py``. A split is padded
to a multiple of the batch size and reshaped to ``(num_batches, batch,
...)`` once; padding rows carry a zero validity weight so they contribute
nothing to losses or gradients. :func:`pad_axis0` is the inference
chunker's padding helper.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from .prepare import HybridData

__all__ = [
    "EpochTensors", "build_epoch_tensors", "batch_iterator", "pad_axis0",
]


def pad_axis0(arr, n: int) -> np.ndarray:
    """Zero-pad ``arr``'s leading axis to ``n`` rows (float32); padding rows
    ride the zero-weight/zero-mask arithmetic everywhere downstream."""
    arr = np.asarray(arr, np.float32)
    if arr.shape[0] == n:
        return arr
    width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width)


class EpochTensors(NamedTuple):
    """Padded epoch data (host-side numpy).

    ``x``/``forcing``/``y`` have a leading ``(num_batches, batch)`` pair;
    ``mask[t]`` marks valid (finite, non-padding) target entries; ``weight``
    marks non-padding samples ``(num_batches, batch)``.
    """

    x: Any
    forcing: Dict[str, Any]
    y: Dict[str, Any]
    mask: Dict[str, Any]
    weight: Any
    n_samples: int

    @property
    def num_batches(self) -> int:
        return int(self.weight.shape[0])

    @property
    def batch_size(self) -> int:
        return int(self.weight.shape[1])


def _pad_reshape(arr: np.ndarray, num_batches: int, batch: int) -> np.ndarray:
    n = arr.shape[0]
    padded = num_batches * batch
    if padded != n:
        pad_width = [(0, padded - n)] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_width)
    return arr.reshape((num_batches, batch) + arr.shape[1:])


def build_epoch_tensors(
    data: HybridData,
    batch_size: Optional[int],
    *,
    extra_mask: Optional[Mapping[str, np.ndarray]] = None,
) -> EpochTensors:
    """Pad ``data`` to a whole number of batches and stack batch-major.

    ``batch_size=None`` → one full batch. NaN targets become 0 with a 0
    mask; padding samples get ``weight = 0`` and all-0 masks.
    """
    n = data.n_samples
    if batch_size is None:
        batch_size = n
    num_batches = max(1, math.ceil(n / batch_size))

    def prep(arr):
        return _pad_reshape(np.asarray(arr, np.float32), num_batches, batch_size)

    if isinstance(data.x, Mapping):
        x = {k: prep(v) for k, v in data.x.items()}
    else:
        x = prep(data.x)
    forcing = {k: prep(v) for k, v in data.forcing.items()}

    weight_flat = np.zeros(num_batches * batch_size, np.float32)
    weight_flat[:n] = 1.0
    weight = weight_flat.reshape(num_batches, batch_size)

    y, mask = {}, {}
    for t, arr in data.y.items():
        arr = np.asarray(arr, np.float32)
        finite = np.isfinite(arr)
        if extra_mask is not None and t in extra_mask:
            finite = finite & np.asarray(extra_mask[t], bool)
        y[t] = prep(np.where(finite, arr, 0.0))
        m = _pad_reshape(finite.astype(np.float32), num_batches, batch_size)
        # zero out padding in the mask
        w = weight.reshape((num_batches, batch_size) + (1,) * (m.ndim - 2))
        mask[t] = m * w
    return EpochTensors(
        x=x, forcing=forcing, y=y, mask=mask, weight=weight, n_samples=n
    )


def batch_iterator(
    data: HybridData,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: Optional[int] = None,
    drop_last: bool = False,
):
    """Host-side minibatch iterator for users who want manual loops."""
    n = data.n_samples
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, stop, batch_size):
        sel = idx[start : start + batch_size]
        sub = data.take(sel)
        yield sub.as_batch()
