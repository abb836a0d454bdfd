"""K-fold assignment helper.

PyTorch-port copy of ``easyhybrid_tpu/utils/folds.py`` (parity: the
reference ``make_folds``, src/utils/helpers_cross_validation.jl:16-26): a
per-row fold id vector in 1..k, usable as ``folds=`` with ``val_fold=`` in
:func:`easyhybrid_tpu_torch.split_data`. numpy only; the ids equal the JAX
package's for the same ``k``, ``shuffle`` and ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["make_folds"]


def make_folds(
    data,
    *,
    k: int = 5,
    shuffle: bool = True,
    seed: Optional[int] = None,
) -> np.ndarray:
    n = len(data)
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    folds = np.zeros(n, np.int64)
    # contiguous chunks over the (shuffled) order, like MLUtils.kfolds
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    start = 0
    for fold_id, size in enumerate(sizes, start=1):
        folds[idx[start : start + size]] = fold_id
        start += size
    return folds
