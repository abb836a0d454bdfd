"""Batched inference engine for serving.

Counterpart of ``easyhybrid_tpu/training/inference.py``: inputs are padded
to a fixed ``batch_size`` and run in chunks; rows with NaN predictors are
kept (NaN propagates); padding rows are dropped from the output, and so is
every output whose leading axis is not the batch (the globals).

Inference runs on the model's device. The engine is chosen once, in
:func:`make_inference_fn`, and exposed on the returned function:

* ``"cuda_fused_forward"``: the model is on a CUDA device and inside the
  fused forward kernel's envelope; every chunk is one kernel launch;
* ``"torch"``: the plain module forward on the model's device; the model
  is on the CPU or outside the envelope, and ``engine_reason`` says which.

Ensemble inference waits for the population slice (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..data.loaders import pad_axis0
from ..data.prepare import prepare_data
from ..ops.fused_forward import fused_forward_unsupported_reason, make_fused_forward

__all__ = ["make_inference_fn", "predict"]


def _flatten_outputs(outputs) -> Dict[str, Any]:
    """Model outputs → flat ``{name: (B, ...) tensor}`` (drops nested
    non-tensor entries)."""
    flat: Dict[str, Any] = {}
    for k, v in outputs.items():
        if isinstance(v, Mapping):
            for kk, vv in v.items():
                if not isinstance(vv, Mapping) and np.ndim(vv) >= 1:
                    flat[kk] = vv
        else:
            flat[k] = v
    return flat


def _plain_forward(model) -> Callable:
    def forward(x, forcing):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return _flatten_outputs(model(x, forcing))
        finally:
            model.train(was_training)

    return forward


def make_inference_fn(model, *, batch_size: int = 1024):
    """Build ``predict(data) -> dict of np.ndarray`` over fixed-size chunks
    of ``batch_size`` rows.

    ``data`` may be a DataFrame, a dict of columns, or a ``HybridData``.
    The fused engine packs the model's parameters when this is called, as
    the JAX version closes over its ``params``: build a new function after
    changing them.
    """
    device = model.device
    reason = fused_forward_unsupported_reason(model)
    if device.type == "cuda" and reason is None:
        forward = make_fused_forward(model, batch_size=batch_size)
        engine = "cuda_fused_forward"
        engine_reason = "CUDA model inside the fused forward kernel's envelope"
    else:
        forward = _plain_forward(model)
        engine = "torch"
        engine_reason = reason or f"the model is on {device}; the kernel runs on CUDA"

    def predict_fn(data) -> Dict[str, np.ndarray]:
        return _run_chunked(model, forward, data, batch_size, device)

    predict_fn.engine = engine
    predict_fn.engine_reason = engine_reason
    return predict_fn


def predict(model, data, *, batch_size: int = 1024) -> Dict[str, np.ndarray]:
    """One-shot convenience wrapper around :func:`make_inference_fn`."""
    return make_inference_fn(model, batch_size=batch_size)(data)


def _run_chunked(model, forward, data, batch_size: int, device) -> Dict[str, np.ndarray]:
    """Pad/chunk/copy driver around ``forward``."""
    hd = prepare_data(model, data, drop_missing_rows=False)
    n = hd.n_samples
    x_all = np.asarray(hd.x)

    chunks: Dict[str, list] = {}
    for start in range(0, max(n, 1), batch_size):
        end = min(start + batch_size, n)
        take = end - start
        x = torch.tensor(pad_axis0(x_all[start:end], batch_size), device=device)
        forcing = {
            k: torch.tensor(pad_axis0(np.asarray(v)[start:end], batch_size), device=device)
            for k, v in hd.forcing.items()
        }
        out = forward(x, forcing)
        for k, v in out.items():
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            if v.ndim >= 1 and v.shape[0] == batch_size:
                chunks.setdefault(k, []).append(v[:take])
    return {k: np.concatenate(vs) for k, vs in chunks.items()}
