"""The ``train`` public API: config overlay, engine choice, the eager epoch
loop with early stopping, and the results.

PyTorch counterpart of ``easyhybrid_tpu/training/train.py``. The training
split lives on the model's device as padded epoch tensors, moved there once;
evaluation runs both splits in eval mode after every block of
``eval_every`` epochs, and only the scalar metrics come back to the host.

The epoch engine is chosen once (``TrainResults.epoch_path``):

* ``"cuda_fused_epoch"``: the model is on CUDA (or ``use_kernel=True``),
  inside the fused kernel's envelope (``ops/fused_epoch.py``), and the
  runtime exactness gate passed; each block of ``eval_every`` epochs is one
  kernel launch;
* ``"cuda_fused_wide"``: the same for an MLP hybrid that kernel's one thread
  block cannot hold (widths above 64, or parameters and moments beyond its
  shared memory) and the wide kernel (``ops/fused_wide.py``), by size
  alone; each block of ``eval_every`` epochs is one call of its launcher;
* ``"cuda_fused_multisite"``: the same for a ``MultiSiteHybridModel`` and
  the multi-site kernel (``ops/fused_multisite.py``); each block of
  ``eval_every`` epochs is one call of its launcher;
* ``"cuda_fused_lstm"``: the same for a hybrid over an ``LSTMNet`` trained on
  sequence windows (``sequence_kwargs``) and the LSTM kernel
  (``ops/fused_epoch_lstm.py``); one launch per block of ``eval_every`` epochs;
* ``"torch"``: the torch epoch (``training/epoch.py``).

``TrainResults.engine_reason`` says why, in the JAX package's wording where
it applies. The loop is always the eager one (``loop_mode == "eager"``);
the JAX package's zero-readback deferred loop is not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config.train_config import DataConfig, TrainConfig, TrainResults, validate_config
from ..data.loaders import build_epoch_tensors
from ..data.prepare import HybridData
from ..data.split import merged_sequence_kwargs, split_data
from ..losses.specs import LoggingLoss
from ..ops.fused_epoch import fused_engine, fused_exactness_check, init_fused_opt_state
from ..params import scale_param
from .early_stopping import EarlyStopping
from .epoch import can_skip_empty_guard, epoch_tensors_to, make_dual_evaluator, make_train_epoch
from .history import EpochSnapshot, TrainingHistory
from .optimizers import parse_opt_spec, resolve_optimizer

__all__ = ["train", "fit_input_norm", "kwargs_to_configs"]

log = logging.getLogger("easyhybrid_tpu_torch")

#: kwarg renames kept for familiarity with the reference API and the JAX package
_RENAMED_KWARGS = {
    "opt": "optimizer",
    "hybrid_name": "model_name",
    "file_name": "model_name",
    "loss_fn": "training_loss",
    "use_pallas": "use_kernel",
}

_TRAIN_FIELDS = {f.name for f in dataclasses.fields(TrainConfig)}
_DATA_FIELDS = {f.name for f in dataclasses.fields(DataConfig)}


def kwargs_to_configs(
    kwargs: Dict[str, Any],
    train_cfg: Optional[TrainConfig],
    data_cfg: Optional[DataConfig],
) -> Tuple[TrainConfig, DataConfig, Dict[str, Any]]:
    """Overlay flat kwargs onto typed configs; return the leftovers."""
    train_cfg = train_cfg or TrainConfig()
    data_cfg = data_cfg or DataConfig()
    leftovers: Dict[str, Any] = {}
    for k, v in kwargs.items():
        if k in _RENAMED_KWARGS:
            log.warning("keyword %r is deprecated; use %r", k, _RENAMED_KWARGS[k])
            k = _RENAMED_KWARGS[k]
        if k in _TRAIN_FIELDS:
            train_cfg = train_cfg.replace(**{k: v})
        elif k in _DATA_FIELDS:
            data_cfg = data_cfg.replace(**{k: v})
        else:
            leftovers[k] = v
    return train_cfg, data_cfg, leftovers


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


def _get_ps_st(train_from):
    """Warm-start source → ``(params, state)``: a :class:`TrainResults` or a
    ``(params, state)`` pair, in the port's layout (names of
    ``named_parameters`` / ``named_buffers``) or the JAX package's."""
    if train_from is None:
        return None
    if isinstance(train_from, TrainResults):
        return train_from.params, train_from.state
    if isinstance(train_from, tuple) and len(train_from) == 2:
        return train_from
    raise TypeError(f"cannot warm-start from {type(train_from).__name__}")


def _warm_start(model, params, state) -> None:
    named_p, named_b = dict(model.named_parameters()), dict(model.named_buffers())
    if isinstance(params, Mapping) and set(params) <= set(named_p) and set(state) <= set(named_b):
        with torch.no_grad():
            for k, v in params.items():
                named_p[k].copy_(torch.as_tensor(v))
            for k, v in state.items():
                named_b[k].copy_(torch.as_tensor(v))
        return
    from ..interop import load_jax_params

    load_jax_params(model, params, state)


def _full_batch(data: HybridData, device):
    """The whole split as one ``((x, forcing), (y, mask))`` batch on ``device``."""
    t = epoch_tensors_to(build_epoch_tensors(data, None), device)
    return (
        (t.x[0], {k: v[0] for k, v in t.forcing.items()}),
        ({k: v[0] for k, v in t.y.items()}, {k: v[0] for k, v in t.mask.items()}),
    )


def _host_metrics(metrics) -> Dict[str, Dict[str, float]]:
    """Nested metric tensors → floats, in one device-to-host copy."""
    keys = [(m, t) for m, entry in metrics.items() for t in entry]
    values = torch.stack([torch.as_tensor(metrics[m][t]).reshape(()) for m, t in keys])
    out: Dict[str, Dict[str, float]] = {}
    for (m, t), v in zip(keys, values.cpu().tolist()):
        out.setdefault(m, {})[t] = float(v)
    return out


def _outputs_to_host(outputs, n: int):
    def host(v):
        arr = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        return arr[:n] if arr.ndim >= 1 and arr.shape[0] >= n else arr

    return {k: ({kk: host(vv) for kk, vv in v.items()} if isinstance(v, Mapping) else host(v))
            for k, v in outputs.items()}


def _obs_pred_columns(data: HybridData, outputs, targets):
    """Observed and predicted columns as numpy dicts (the DataFrames of
    ``TrainResults`` are built from them on access). Windowed targets
    ``(N, T_out)`` give the long format: ``sample`` and ``step`` index
    columns, the predictions cut to the trailing ``T_out`` steps, and a
    per-sample target beside them repeated over a window's steps."""
    shapes = {t: np.asarray(data.y[t]).shape for t in targets}
    windows = {s for s in shapes.values() if len(s) > 1}
    if len(windows) > 1:
        raise ValueError(f"targets with different windows {sorted(windows)} cannot share "
                         "one long-format frame")
    window = next(iter(windows), None)

    def flat(arr, shape):
        if window is not None and len(shape) == 1:
            arr = np.broadcast_to(arr.reshape(-1, *([1] * (len(window) - 1))), window)
        return np.ascontiguousarray(arr, np.float32).ravel()

    def pred_of(t):
        arr, y_shape = np.asarray(outputs[t], np.float32), shapes[t]
        if arr.ndim >= 2 and len(y_shape) >= 2 and arr.shape[1] != y_shape[1]:
            arr = arr[:, -y_shape[1]:]  # trailing-window alignment
        return flat(arr, y_shape)

    index = {}
    if window is not None:
        idx = np.indices(window).reshape(len(window), -1)
        index = {"sample": idx[0], "step": idx[1]}
    obs = {**index, **{t: flat(np.asarray(data.y[t], np.float32), shapes[t]) for t in targets}}
    pred = {**index, **{f"{t}_pred": pred_of(t) for t in targets if t in outputs}}
    return obs, pred


def _extract_diffs(outputs, targets):
    """Non-target outputs (the learned physical parameters and the like)."""
    diffs = {k: v for k, v in outputs.items() if k not in targets}
    return diffs or None


def _select_engine(model, cfg: TrainConfig, logging_loss: LoggingLoss, tensors, eval_every: int):
    """``(use the fused kernel, reason)`` following the JAX package's rules,
    with the device in place of the backend."""
    use_kernel = cfg.use_kernel
    if use_kernel not in ("auto", None) and use_kernel is not True and use_kernel is not False:
        use_kernel = bool(use_kernel)
    if use_kernel is False:
        return False, "use_kernel disabled (use_kernel=False)"
    device = model.device
    if use_kernel is not True and device.type != "cuda":
        return False, (f"the model is on {device.type!r}, not cuda "
                       "(use_kernel=True overrides)")
    engine = fused_engine(model)
    shuffle = cfg.shuffle_each_epoch
    args = (model, cfg.optimizer, logging_loss, tensors)
    reason = engine.unsupported_reason(*args, shuffle=shuffle)
    if reason is not None:
        if engine.unsupported_reason(*args, shuffle=False) is None:
            # only the shuffle mode disqualified the kernel: name the flag
            return False, engine.shuffle_refusal.format(shuffle)
        return False, ("model/optimizer/loss outside the fused-kernel envelope "
                       f"({engine.envelope}): {reason}")
    ok, gdiff = fused_exactness_check(
        model, cfg.optimizer, logging_loss, tensors, epochs_per_call=eval_every,
        shuffle=cfg.shuffle_each_epoch,
    )
    if ok:
        log.info("fused CUDA epoch kernel enabled (exactness gate: max grad diff %.2e)", gdiff)
        return True, f"exactness gate passed (max grad diff {gdiff:.2e})"
    if use_kernel is True:
        log.warning("use_kernel was requested but the runtime exactness gate FAILED "
                    "(max grad diff %.2e): running the torch epoch", gdiff)
    return False, f"runtime exactness gate FAILED (max grad diff {gdiff:.2e})"


def train(
    model,
    data,
    *,
    train_cfg: Optional[TrainConfig] = None,
    data_cfg: Optional[DataConfig] = None,
    **kwargs,
) -> TrainResults:
    """Train a hybrid model in place. Accepts typed configs, flat kwargs, or
    both (kwargs override config fields). ``data`` is a dict of columns, a
    DataFrame, a ``HybridData`` or a pre-split ``(train, val)`` pair. The
    model is left holding the returned (best or final) parameters."""
    cfg, dcfg, leftovers = kwargs_to_configs(kwargs, train_cfg, data_cfg)
    validate_config(cfg, dcfg)
    parse_opt_spec(cfg.optimizer)  # raises for the rules the port lacks
    if leftovers:
        log.warning("Unknown kwargs ignored: %s", ", ".join(leftovers))

    train_data, val_data = split_data(
        data, model, split_by_id=dcfg.split_by_id, folds=dcfg.folds, val_fold=dcfg.val_fold,
        shuffleobs=dcfg.shuffleobs, split_data_at=dcfg.split_data_at,
        sequence_kwargs=merged_sequence_kwargs(dcfg), seed=cfg.random_seed,
    )
    if val_data.n_samples == 0:
        raise ValueError(
            "validation split is empty; lower split_data_at (< 1.0) or pass "
            "a pre-split (train, val) tuple"
        )

    device = model.device
    host_tensors = build_epoch_tensors(train_data, cfg.batchsize)
    skip_empty_guard = can_skip_empty_guard(host_tensors)
    train_tensors = epoch_tensors_to(host_tensors, device)
    train_eval_batch = _full_batch(train_data, device)
    val_eval_batch = _full_batch(val_data, device)

    warm = _get_ps_st(cfg.train_from)
    if warm is not None:
        _warm_start(model, *warm)
    fit_input_norm(model, train_data)

    logging_loss = LoggingLoss(
        loss_types=tuple(cfg.loss_types), training_loss=cfg.training_loss,
        extra_loss=cfg.extra_loss, agg=cfg.agg,
    )
    eval_every = max(1, int(cfg.eval_every))
    fused, reason = _select_engine(model, cfg, logging_loss, train_tensors, eval_every)
    generator = torch.Generator(device=device).manual_seed(int(cfg.random_seed))

    if fused:
        engine = fused_engine(model)
        epoch_path = engine.epoch_path
        kernel_epoch = engine.make_epoch(model, cfg.optimizer, logging_loss,
                                         shuffle=cfg.shuffle_each_epoch,
                                         epochs_per_call=eval_every)
        packed = kernel_epoch.plan.pack(model)
        opt_state = init_fused_opt_state(packed, cfg.optimizer)

        def run_block():
            nonlocal packed, opt_state
            packed, opt_state, _ = kernel_epoch(packed, opt_state, train_tensors,
                                                generator=generator)
            kernel_epoch.plan.unpack(packed, model)
    else:
        epoch_path = "torch"
        optimizer = resolve_optimizer(cfg.optimizer)
        opt_state = optimizer.init({k: p.detach() for k, p in model.named_parameters()})
        torch_epoch = make_train_epoch(model, logging_loss, optimizer,
                                       shuffle=cfg.shuffle_each_epoch,
                                       epochs_per_call=eval_every,
                                       skip_empty_guard=skip_empty_guard)

        def run_block():
            nonlocal opt_state
            opt_state, _ = torch_epoch(opt_state, train_tensors, generator=generator)

    engine_reason = (f"{epoch_path}: {reason}; eager loop (the deferred loop is not "
                     "ported yet)")
    log.info("epoch engine: %s", engine_reason)

    want_outputs = bool(cfg.keep_history or cfg.monitor_names)
    evaluator = make_dual_evaluator(model, logging_loss)

    def snapshot_now() -> EpochSnapshot:
        (m_tr, out_tr), (m_va, out_va) = evaluator(train_eval_batch, val_eval_batch)
        snap = EpochSnapshot(_host_metrics(m_tr), _host_metrics(m_va))
        if want_outputs:
            snap.y_hat_train = _outputs_to_host(out_tr, train_data.n_samples)
            snap.y_hat_val = _outputs_to_host(out_va, val_data.n_samples)
        return snap

    def params_now():
        return {k: p.detach() for k, p in model.named_parameters()}

    def state_now():
        return {k: b.detach() for k, b in model.named_buffers()}

    def tracked_values() -> Dict[str, float]:
        out = {}
        table = model.param_table
        globals_, fixed = model.globals.as_dict(), model.fixed.as_dict()
        for name in cfg.tracked_params or ():
            if name in globals_:
                v = scale_param(globals_[name].detach(), table.lower_of(name), table.upper_of(name))
                out[name] = float(v.reshape(-1)[0])
            elif name in fixed:
                out[name] = float(fixed[name].reshape(-1)[0])
        return out

    def monitored_quantiles(snapshot) -> Dict[str, Dict[str, float]]:
        out = {}
        if not cfg.monitor_names or snapshot.y_hat_val is None:
            return out
        params_out = snapshot.y_hat_val.get("parameters", {})
        for name in cfg.monitor_names:
            if name in params_out:
                arr = np.asarray(params_out[name]).ravel()
                if arr.size >= 1:
                    q25, q50, q75 = np.nanpercentile(arr, [25, 50, 75])
                    out[name] = {"q25": float(q25), "q50": float(q50), "q75": float(q75)}
        return out

    init_snapshot = snapshot_now()
    history = TrainingHistory([
        init_snapshot if cfg.keep_history
        else EpochSnapshot(init_snapshot.l_train, init_snapshot.l_val)
    ])
    stopper = EarlyStopping(init_snapshot, params_now(), state_now(), cfg)
    tracked = {k: [v] for k, v in tracked_values().items()}
    monitored = {k: [v] for k, v in monitored_quantiles(init_snapshot).items()}

    t0 = time.perf_counter()
    for epoch in range(eval_every, cfg.nepochs + 1, eval_every):
        run_block()
        snapshot = snapshot_now()
        stopper.update(history, snapshot, params_now(), state_now(), epoch, cfg.keep_history)
        for k, v in tracked_values().items():
            tracked.setdefault(k, []).append(v)
        for k, v in monitored_quantiles(snapshot).items():
            monitored.setdefault(k, []).append(v)
        if cfg.show_progress and (
            epoch == eval_every
            or epoch + eval_every > cfg.nepochs
            or epoch % max(1, cfg.nepochs // 10) == 0
        ):
            agg, metric = stopper.agg_name, stopper.metric
            log.info(
                "epoch %4d/%d  train %s(%s)=%.6g  val=%.6g  best=%.6g@%d  (%.1fs)",
                epoch, cfg.nepochs, metric, agg,
                snapshot.l_train.get(metric, {}).get(agg, float("nan")),
                snapshot.l_val.get(metric, {}).get(agg, float("nan")),
                stopper.best_loss, stopper.best_epoch, time.perf_counter() - t0,
            )
        if stopper.done:
            break

    best_params, best_state = stopper.best_or_final(params_now(), state_now(), cfg.return_model)
    _warm_start(model, best_params, best_state)

    (_, out_tr), (_, out_va) = evaluator(train_eval_batch, val_eval_batch)
    out_tr = _outputs_to_host(out_tr, train_data.n_samples)
    out_va = _outputs_to_host(out_va, val_data.n_samples)
    targets = tuple(model.targets)
    train_obs, train_pred = _obs_pred_columns(train_data, out_tr, targets)
    val_obs, val_pred = _obs_pred_columns(val_data, out_va, targets)
    return TrainResults(
        train_history=history.train_losses(),
        val_history=history.val_losses(),
        train_obs_columns=train_obs,
        train_pred_columns=train_pred,
        val_obs_columns=val_obs,
        val_pred_columns=val_pred,
        train_diffs=_extract_diffs(out_tr, targets),
        val_diffs=_extract_diffs(out_va, targets),
        params={k: v.detach().cpu().clone() for k, v in best_params.items()},
        state={k: v.detach().cpu().clone() for k, v in best_state.items()},
        best_epoch=stopper.best_epoch,
        best_loss=stopper.best_loss,
        history=history,
        tracked=tracked or None,
        monitored=monitored or None,
        opt_state=opt_state,
        epoch_path=epoch_path,
        loop_mode="eager",
        engine_reason=engine_reason,
    )
