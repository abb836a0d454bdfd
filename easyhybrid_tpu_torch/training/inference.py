"""Batched inference engine for serving.

Counterpart of ``easyhybrid_tpu/training/inference.py``: inputs are padded
to a fixed ``batch_size`` and run in chunks; rows with NaN predictors are
kept (NaN propagates); padding rows are dropped from the output, and so is
every output whose leading axis is not the batch (the globals).

Inference runs on the model's device. The engine is chosen once, in
:func:`make_inference_fn`, and exposed on the returned function:

* ``"cuda_fused_forward"``: the model is on a CUDA device (or
  ``use_kernel=True``) and inside the fused forward kernel's envelope; a
  call copies each input array to the card once, into a buffer of whole
  chunks whose padding rows are zeroed there, computes every chunk in one
  kernel launch and copies each output back once
  (:meth:`FusedForward.table`; on a CPU model the kernel's plain version
  runs the same path);
* ``"torch"``: the plain module forward on the model's device, chunk by
  chunk as the JAX ``predict`` runs; the model is on the CPU or outside the
  envelope (or ``use_kernel=False``), and ``engine_reason`` says which.

Ensemble inference waits for the population slice (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..data.loaders import pad_axis0
from ..data.prepare import prepare_data
from ..ops.fused_forward import fused_forward_unsupported_reason, make_fused_forward
from .epoch import map_x

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


def _scalars(model) -> Dict[str, np.ndarray]:
    """The scaled globals and the fixed values, as ``(1,)`` host arrays: the
    plain forward returns them too, and the chunk filter keeps them exactly
    when the batch holds one row, as the JAX ``predict`` does. Snapshot of
    the parameters, like the kernel's plan."""
    with torch.no_grad():
        scalars = {**model._scale_globals(), **model.fixed.as_dict()}
        return {k: v.detach().cpu().numpy().copy() for k, v in scalars.items()}


def make_inference_fn(model, *, batch_size: int = 1024, use_kernel: Any = "auto"):
    """Build ``predict(data) -> dict of np.ndarray`` over fixed-size chunks
    of ``batch_size`` rows.

    ``data`` may be a DataFrame, a dict of columns, or a ``HybridData``.
    The fused engine packs the model's parameters when this is called, as
    the JAX version closes over its ``params``: build a new function after
    changing them. ``use_kernel`` ``"auto"`` takes the fused engine for a
    CUDA model inside its envelope; True takes it on any device (on the CPU
    its plain version computes), False never.
    """
    device = model.device
    reason = fused_forward_unsupported_reason(model)
    if use_kernel is False:
        reason = "use_kernel disabled (use_kernel=False)"
    elif reason is None and use_kernel is not True and device.type != "cuda":
        reason = f"the model is on {device}; the kernel runs on CUDA (use_kernel=True overrides)"
    if reason is None:
        fused = make_fused_forward(model, batch_size=batch_size)
        scalars = _scalars(model)
        engine = "cuda_fused_forward"
        engine_reason = ("CUDA model inside the fused forward kernel's envelope"
                         if device.type == "cuda" else
                         f"use_kernel=True: the kernel's plain version on {device}")

        def predict_fn(data) -> Dict[str, np.ndarray]:
            return _run_fused(model, fused, scalars, data, batch_size)
    else:
        forward = _plain_forward(model)
        engine = "torch"
        engine_reason = reason

        def predict_fn(data) -> Dict[str, np.ndarray]:
            return _run_chunked(model, forward, data, batch_size, device)

    predict_fn.engine = engine
    predict_fn.engine_reason = engine_reason
    return predict_fn


def predict(model, data, *, batch_size: int = 1024, use_kernel: Any = "auto"
            ) -> Dict[str, np.ndarray]:
    """One-shot convenience wrapper around :func:`make_inference_fn`."""
    return make_inference_fn(model, batch_size=batch_size, use_kernel=use_kernel)(data)


def _run_fused(model, fused, scalars, data, batch_size: int) -> Dict[str, np.ndarray]:
    """The fused engine's serving path: the rows through :meth:`FusedForward.table`
    (one copy in per input array, one launch, one copy out per output),
    with the keys and rows
    of :func:`_run_chunked`: at ``batch_size=1`` the ``(1,)`` scalars too,
    once per row, as the chunk filter keeps them."""
    hd = prepare_data(model, data, drop_missing_rows=False)
    n = hd.n_samples
    out = fused.table(np.asarray(hd.x), {k: np.asarray(v) for k, v in hd.forcing.items()})
    if batch_size == 1:
        out.update({k: np.repeat(v, n) for k, v in scalars.items()})
    return out


def _run_chunked(model, forward, data, batch_size: int, device) -> Dict[str, np.ndarray]:
    """Pad/chunk/copy loop around the plain ``forward``, chunk by chunk as
    the JAX ``predict`` runs."""
    hd = prepare_data(model, data, drop_missing_rows=False)
    n = hd.n_samples

    def chunk(a, start, end):
        return torch.tensor(pad_axis0(np.asarray(a)[start:end], batch_size), device=device)

    chunks: Dict[str, list] = {}
    for start in range(0, max(n, 1), batch_size):
        end = min(start + batch_size, n)
        take = end - start
        x = map_x(lambda a: chunk(a, start, end), hd.x)
        forcing = {k: chunk(v, start, end) for k, v in hd.forcing.items()}
        out = forward(x, forcing)
        for k, v in out.items():
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            if v.ndim >= 1 and v.shape[0] == batch_size:
                chunks.setdefault(k, []).append(v[:take])
    return {k: np.concatenate(vs) for k, vs in chunks.items()}
