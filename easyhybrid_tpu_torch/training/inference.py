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

:func:`ensemble_predict` serves a trained population: one forward over
every member at once (``torch.func.vmap`` over ``functional_call``, built
once per model), chunk by chunk, returning each output's member mean and
spread.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..data.loaders import pad_axis0
from ..data.prepare import prepare_data
from ..ops.fused_forward import fused_forward_unsupported_reason, make_fused_forward
from .epoch import map_x

__all__ = ["make_inference_fn", "predict", "ensemble_predict"]

# the vmapped ensemble forwards, one per model under a weak key: repeat calls
# reuse it, and a model the caller drops releases it
_ENSEMBLE_FORWARDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


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


def ensemble_predict(model, population, data, *, batch_size: int = 1024, best: bool = True
                     ) -> Dict[str, np.ndarray]:
    """Ensemble inference over a trained population: one forward over all K
    members per chunk of ``batch_size`` rows, returning every output's
    member mean and, as ``<name>_std``, its member spread (the population
    standard deviation, ``correction=0``, as ``jnp.std``): the predictive
    uncertainty of a seed or hyperparameter ensemble.

    ``population`` is a :class:`~easyhybrid_tpu_torch.training.population.
    PopulationResults` (each member's best-epoch parameters, or its final
    ones with ``best=False``, with the final state: the same for a static
    input norm; for a trainable BatchNorm the end-of-run statistics stand in
    for the best epoch's) or a ``(stacked_params, stacked_state)`` tuple of
    dicts keyed like ``named_parameters()`` / ``named_buffers()`` with a
    leading member axis. The forward runs on the model's device. Outputs are
    flattened as :func:`predict` flattens them."""
    from ..parallel.multisite import MultiSiteHybridModel

    if isinstance(population, tuple):
        stacked_params, stacked_state = population
    else:
        stacked_params = population.best_params if best else population.params
        stacked_state = population.state
    device = model.device
    params = {k: torch.as_tensor(v).to(device) for k, v in stacked_params.items()}
    state = {k: torch.as_tensor(v).to(device) for k, v in stacked_state.items()}
    hd = prepare_data(model, data, drop_missing_rows=False)
    if isinstance(model, MultiSiteHybridModel) and np.ndim(hd.x) != 3:
        # the JAX package's vmap over the chunk refuses the same data
        raise ValueError(
            f"a multi-site model predicts on site-major data (S, N, F) from "
            f"prepare_multisite_data; got x of shape {np.shape(hd.x)}")
    return _run_chunked(model, functools.partial(_ensemble_forward(model), params, state), hd,
                        batch_size, device)


def _ensemble_forward(model) -> Callable:
    """``forward(params, state, x, forcing)``: the model in eval mode over
    the members' stacked leaves (``torch.func.vmap`` over
    ``functional_call``), the outputs flattened, then their mean and
    ``_std`` over the members. One per model, cached under a weak key; the
    function holds the model weakly, so the cache entry does not keep it."""
    try:
        cached = _ENSEMBLE_FORWARDS.get(model)
    except TypeError:  # a model that cannot be weakly referenced
        cached = None
    if cached is not None:
        return cached
    model_ref = weakref.ref(model)

    def forward(params, state, x, forcing):
        m = model_ref()

        def one(p, s):
            return _flatten_outputs(torch.func.functional_call(m, {**p, **s}, (x, forcing)))

        was_training = m.training
        m.eval()
        try:
            with torch.no_grad():
                outs = torch.func.vmap(one)(params, state)  # (K, B, ...)
        finally:
            m.train(was_training)
        flat = {}
        for k, v in outs.items():
            flat[k] = v.mean(0)
            flat[k + "_std"] = v.std(0, correction=0)
        return flat

    try:
        _ENSEMBLE_FORWARDS[model] = forward
    except TypeError:
        pass
    return forward


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
