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
* ``"cuda_fused_lstm_split"``: the same for an LSTM hybrid whose state one
  block of that kernel cannot hold (hidden sizes past 64, or a window whose
  checkpoints outgrow it) and kernel 4's cluster-split form
  (``ops/fused_lstm_split.py``), by size and window alone;
* ``"torch"``: the torch epoch (``training/epoch.py``).

``TrainResults.engine_reason`` says why, in the JAX package's wording where
it applies, and ends with the loop (``TrainResults.loop_mode``):

* ``"deferred"`` (``"; zero-readback"``) whenever nothing needs host values
  in the middle of the run (``training/deferred.py``: early stopping on the
  device, one fetch at the end);
* ``"eager"`` (``"; eager loop forced by <settings>"``) under
  ``show_progress=True``, ``jit=False`` or a ``keep_history`` too large for
  device buffers: the metrics come to the host after every block and the
  host decides whether to go on.

Both loops give the same results, bit for bit on the same engine.
``return_gradients`` adds the gradient norms to every snapshot
(``grad_history``) and the gradient at the returned parameters
(``final_grads``); a prebuilt ``opt_state`` runs the torch engine; ``remat``
recomputes the torch epoch's forward in its backward pass.
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
from ..interop import jax_branch_of
from ..losses.specs import LoggingLoss
from ..ops._build import nvcc_seconds
from ..ops.fused_epoch import FusedParams, fused_engine, fused_exactness_check, init_fused_opt_state
from . import deferred
from .early_stopping import EarlyStopping
from .epoch import (can_skip_empty_guard, epoch_tensors_to, make_dual_evaluator, make_grad_probe,
                    make_train_epoch, map_x, select_state)
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
    1e-12) of ``train_data.x`` go into the norm's buffers; a MultiNN model's
    branch b takes them from ``train_data.x[b]``. Networks without a static
    norm are left as they are."""
    nns = getattr(model, "nns", None)
    if nns is not None:
        for name, net in nns.items():
            _fit_static_norm(net, train_data.x[name])
    else:
        _fit_static_norm(getattr(model, "nn", None), train_data.x)


def _fit_static_norm(net, x) -> None:
    norm = getattr(net, "norm", None)
    if norm is None or getattr(net, "input_batchnorm", False) != "static":
        return
    x = np.asarray(x, np.float32)
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
        (map_x(lambda a: a[0], t.x), {k: v[0] for k, v in t.forcing.items()}),
        ({k: v[0] for k, v in t.y.items()}, {k: v[0] for k, v in t.mask.items()}),
    )


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
    if cfg.opt_state is not None:
        return False, "prebuilt opt_state (the fused kernel carries its own)"
    engine = fused_engine(model, tensors)
    shuffle = cfg.shuffle_each_epoch
    args = (model, cfg.optimizer, logging_loss, tensors)
    reason = engine.unsupported_reason(*args, shuffle=shuffle)
    if reason is not None:
        if engine.unsupported_reason(*args, shuffle=False) is None:
            # only the shuffle mode disqualified the kernel: name the flag
            return False, engine.shuffle_refusal.format(shuffle)
        return False, ("model/optimizer/loss outside the fused-kernel envelope "
                       f"({engine.envelope}): {reason}")
    # the gate's first launch builds the kernel for a traced mechanistic form
    # that has no build on disk yet (one nvcc run, then cached on disk)
    t0, nvcc0 = time.perf_counter(), nvcc_seconds()
    ok, gdiff = fused_exactness_check(
        model, cfg.optimizer, logging_loss, tensors, epochs_per_call=eval_every,
        shuffle=cfg.shuffle_each_epoch,
    )
    gate_s, nvcc_s = time.perf_counter() - t0, nvcc_seconds() - nvcc0
    log.info("exactness gate: %.2f s, of it %.2f s building kernels (nvcc)", gate_s, nvcc_s)
    if ok:
        log.info("fused CUDA epoch kernel enabled (exactness gate: max grad diff %.2e)", gdiff)
        built = f", {nvcc_s:.1f} s of them nvcc" if nvcc_s > 0.0 else ""
        return True, f"exactness gate passed (max grad diff {gdiff:.2e}; {gate_s:.2f} s{built})"
    if use_kernel is True:
        log.warning("use_kernel was requested but the runtime exactness gate FAILED "
                    "(max grad diff %.2e): running the torch epoch", gdiff)
    return False, f"runtime exactness gate FAILED (max grad diff {gdiff:.2e})"


class _TorchRun:
    """The torch engine as the loops drive it: ``block(halt)`` trains
    ``eval_every`` epochs in place; with a halt word it keeps the model's
    leaves, buffers and optimizer slots as they were where the word is set.
    ``kept()`` are the tensors whose best values the device stopper keeps."""

    epoch_path = "torch"

    def __init__(self, model, cfg, logging_loss, tensors, generator, eval_every, skip_empty_guard):
        optimizer = resolve_optimizer(cfg.optimizer)
        self.model, self.tensors, self.generator = model, tensors, generator
        if cfg.opt_state is not None:
            self.opt_state = _opt_state_to(cfg.opt_state, model.device)
        else:
            self.opt_state = optimizer.init({k: p.detach() for k, p in model.named_parameters()})
        self.epoch = make_train_epoch(model, logging_loss, optimizer,
                                      shuffle=cfg.shuffle_each_epoch, epochs_per_call=eval_every,
                                      skip_empty_guard=skip_empty_guard, remat=cfg.remat)

    def kept(self) -> Dict[str, torch.Tensor]:
        return {**{k: p.detach() for k, p in self.model.named_parameters()},
                **{k: b.detach() for k, b in self.model.named_buffers()}}

    def block(self, halt=None) -> None:
        if halt is None:
            self.opt_state, _ = self.epoch(self.opt_state, self.tensors, generator=self.generator)
            return
        old = {k: t.clone() for k, t in self.kept().items()}
        old_opt = self.opt_state  # the update makes new tensors
        self.opt_state, _ = self.epoch(self.opt_state, self.tensors, generator=self.generator)
        frozen = halt != 0
        with torch.no_grad():
            for k, t in self.kept().items():
                t.copy_(torch.where(frozen, old[k], t))
        self.opt_state = select_state(frozen, old_opt, self.opt_state)

    def restore(self, kept) -> None:
        with torch.no_grad():
            for k, t in self.kept().items():
                t.copy_(kept[k])


class _FusedRun:
    """A fused engine as the loops drive it: each block is one call of its
    epoch function on the packed parameters (one launch, or one call of its
    launcher), written back into the model; the halt word goes to the kernel.
    The device stopper keeps the packed buffers."""

    def __init__(self, engine, model, cfg, logging_loss, tensors, generator, eval_every):
        self.epoch_path = engine.epoch_path
        self.model, self.tensors, self.generator = model, tensors, generator
        self.fn = engine.make_epoch(model, cfg.optimizer, logging_loss,
                                    shuffle=cfg.shuffle_each_epoch, epochs_per_call=eval_every)
        self.packed = self.fn.plan.pack(model)
        self.opt_state = init_fused_opt_state(self.packed, cfg.optimizer)

    def kept(self) -> Dict[str, torch.Tensor]:
        return {"params": self.packed.params, "bn": self.packed.bn}

    def block(self, halt=None) -> None:
        self.packed, self.opt_state, _ = self.fn(self.packed, self.opt_state, self.tensors,
                                                 generator=self.generator, halt=halt)
        self.fn.plan.unpack(self.packed, self.model)

    def restore(self, kept) -> None:
        self.fn.plan.unpack(FusedParams(kept["params"], kept["bn"]), self.model)


def _opt_state_to(opt_state, device):
    """A copy of a prebuilt (nested) optimizer state on ``device``."""
    if isinstance(opt_state, Mapping):
        return {k: _opt_state_to(v, device) for k, v in opt_state.items()}
    return torch.as_tensor(opt_state).detach().clone().to(device)


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
        run = _FusedRun(fused_engine(model, train_tensors), model, cfg, logging_loss, train_tensors,
                        generator, eval_every)
    else:
        run = _TorchRun(model, cfg, logging_loss, train_tensors, generator, eval_every,
                        skip_empty_guard)
    epoch_path = run.epoch_path

    blockers = deferred.defer_blockers(cfg, n_samples=train_data.n_samples + val_data.n_samples)
    loop_mode = "eager" if blockers else "deferred"
    loop_reason = "eager loop forced by " + ", ".join(blockers) if blockers else "zero-readback"
    engine_reason = f"{epoch_path}: {reason}; {loop_reason}"
    if blockers:
        log.info("epoch engine: %s (eager loop: %s need mid-run host values; unset for the "
                 "zero-readback loop)", epoch_path, ", ".join(blockers))
    else:
        log.info("epoch engine: %s (deferred loop)", epoch_path)

    grad_probe = make_grad_probe(model, logging_loss) if cfg.return_gradients else None
    rows = deferred.SnapshotRow(
        model=model, evaluator=make_dual_evaluator(model, logging_loss),
        train_batch=train_eval_batch, val_batch=val_eval_batch, cfg=cfg,
        n_val=val_data.n_samples, grad_probe=grad_probe, branch_of=jax_branch_of(model),
    )

    def params_now():
        return {k: p.detach() for k, p in model.named_parameters()}

    def state_now():
        return {k: b.detach() for k, b in model.named_buffers()}

    if loop_mode == "deferred":
        out = deferred.run_deferred_loop(cfg=cfg, run=run, rows=rows, eval_every=eval_every,
                                         n_train=train_data.n_samples, n_val=val_data.n_samples)
        history, tracked, monitored = out["history"], out["tracked"], out["monitored"]
        grad_history, record = out["grad_history"], out["record"]
        best_epoch, best_loss = out["best_epoch"], out["best_loss"]
        if cfg.return_model == "best":
            log.info("Returning best model from epoch %d with validation loss %.6g",
                     best_epoch, best_loss)
            run.restore(out["best"])
        else:
            log.info("Returning final model; best validation loss was %.6g at epoch %d",
                     best_loss, best_epoch)
        best_params = {k: v.clone() for k, v in params_now().items()}
        best_state = {k: v.clone() for k, v in state_now().items()}
    else:
        history, tracked, monitored, grad_history, stopper = _eager_loop(
            cfg, run, rows, eval_every, train_data.n_samples, val_data.n_samples,
            params_now, state_now)
        record = None
        best_epoch, best_loss = stopper.best_epoch, stopper.best_loss
        best_params, best_state = stopper.best_or_final(params_now(), state_now(),
                                                        cfg.return_model)
        _warm_start(model, best_params, best_state)

    final_grads = None
    if grad_probe is not None:
        final_grads = {k: v.cpu() for k, v in grad_probe(train_eval_batch).items()}
    (_, out_tr), (_, out_va) = rows.evaluator(train_eval_batch, val_eval_batch)
    out_tr = _outputs_to_host(out_tr, train_data.n_samples)
    out_va = _outputs_to_host(out_va, val_data.n_samples)
    targets = tuple(model.targets)
    train_obs, train_pred = _obs_pred_columns(train_data, out_tr, targets)
    val_obs, val_pred = _obs_pred_columns(val_data, out_va, targets)
    results = TrainResults(
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
        best_epoch=best_epoch,
        best_loss=best_loss,
        history=history,
        tracked=tracked or None,
        monitored=monitored or None,
        opt_state=run.opt_state,
        grad_history=grad_history or None,
        final_grads=final_grads,
        epoch_path=epoch_path,
        loop_mode=loop_mode,
        engine_reason=engine_reason,
    )
    results._loop_record = record  # deferred.loop_record(results)
    return results


def _eager_loop(cfg, run, rows, eval_every, n_train, n_val, params_now, state_now):
    """The eager loop: after every block the snapshot's row comes to the
    host (one copy, a wait for the device), and the host stopper decides."""

    def snapshot_now():
        row, out_tr, out_va = rows.take()
        l_train, l_val, tracked_i, monitored_i, grads_i = rows.unpack(row.cpu().tolist())
        snap = EpochSnapshot(l_train, l_val)
        if cfg.keep_history:
            snap.y_hat_train = _outputs_to_host(out_tr, n_train)
            snap.y_hat_val = _outputs_to_host(out_va, n_val)
        return snap, tracked_i, monitored_i, grads_i

    tracked: Dict[str, list] = {}
    monitored: Dict[str, list] = {}
    grad_history: list = []

    def record(tracked_i, monitored_i, grads_i):
        for k, v in tracked_i.items():
            tracked.setdefault(k, []).append(v)
        for k, v in monitored_i.items():
            monitored.setdefault(k, []).append(v)
        if grads_i is not None:
            grad_history.append(grads_i)

    snap, *extra = snapshot_now()
    history = TrainingHistory([snap])
    stopper = EarlyStopping(snap, params_now(), state_now(), cfg)
    record(*extra)

    t0 = time.perf_counter()
    for epoch in range(eval_every, cfg.nepochs + 1, eval_every):
        run.block()
        snap, *extra = snapshot_now()
        stopper.update(history, snap, params_now(), state_now(), epoch, cfg.keep_history)
        record(*extra)
        if cfg.show_progress and (
            epoch == eval_every
            or epoch + eval_every > cfg.nepochs
            or epoch % max(1, cfg.nepochs // 10) == 0
        ):
            agg, metric = stopper.agg_name, stopper.metric
            log.info(
                "epoch %4d/%d  train %s(%s)=%.6g  val=%.6g  best=%.6g@%d  (%.1fs)",
                epoch, cfg.nepochs, metric, agg,
                snap.l_train.get(metric, {}).get(agg, float("nan")),
                snap.l_val.get(metric, {}).get(agg, float("nan")),
                stopper.best_loss, stopper.best_epoch, time.perf_counter() - t0,
            )
        if stopper.done:
            break
    return history, tracked, monitored, grad_history, stopper
