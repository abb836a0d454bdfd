"""Training utilities. Only the static input-norm fit is ported so far; the
training loop (``train``) is the next slice (ROADMAP.md, queue A)."""

from __future__ import annotations

import numpy as np
import torch

from ..data.prepare import HybridData

__all__ = ["fit_input_norm"]


def fit_input_norm(model, train_data: HybridData) -> None:
    """Fit the ``input_batchnorm="static"`` statistics from the training
    split, in place: the per-feature mean and biased variance (floored at
    1e-12) of ``train_data.x`` go into the norm's buffers. Models without a
    static norm are left as they are."""
    nn = getattr(model, "nn", None)
    norm = getattr(nn, "norm", None)
    if norm is None or getattr(nn, "input_batchnorm", False) != "static":
        return
    x = np.asarray(train_data.x, np.float32)
    flat = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        norm.mean.copy_(torch.from_numpy(flat.mean(0)))
        norm.var.copy_(torch.from_numpy(np.maximum(flat.var(0), 1e-12)))
