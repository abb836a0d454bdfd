"""Early stopping and best-model tracking.

PyTorch counterpart of ``easyhybrid_tpu/training/early_stopping.py``:
direction-aware comparison on the aggregated scalar of the first entry of
``loss_types`` (looked up by name), a patience counter, and a snapshot of
the best parameters and buffers, copied on their device.

:class:`DeviceStopper` is the same arithmetic on the device for the
deferred loop (``training/deferred.py``): its state is 0-d tensors, it
keeps the best tensors with ``torch.where``, and its ``done`` word is the
halt word the training kernels read at entry, so nothing of it is read on
the host until the run ends.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from ..losses.metrics import best_direction, is_better
from ..losses.specs import agg_name as _spec_agg_name
from ..losses.specs import loss_name
from .history import EpochSnapshot, TrainingHistory, _agg_loss

__all__ = ["EarlyStopping", "DeviceStopper", "monitored", "snapshot_tensors"]

log = logging.getLogger("easyhybrid_tpu_torch")


def monitored(cfg) -> tuple:
    """``(metric, agg)``: the name of the metric early stopping compares (the
    first ``loss_types`` entry, else the training loss) and its aggregate's."""
    return (loss_name(cfg.loss_types[0] if cfg.loss_types else cfg.training_loss),
            _spec_agg_name(cfg.agg))


def snapshot_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached copies of ``name -> tensor``."""
    return {k: v.detach().clone() for k, v in tensors.items()}


class EarlyStopping:
    def __init__(self, init_snapshot: EpochSnapshot, params, state, cfg):
        self.metric, self.agg_name = monitored(cfg)
        self.best_loss = _agg_loss(init_snapshot.l_val, self.agg_name, self.metric)
        self.best_params = snapshot_tensors(params)
        self.best_state = snapshot_tensors(state)
        self.best_epoch = 0
        self.counter = 0
        self.patience = cfg.patience
        self.done = False

    def update(self, history: TrainingHistory, snapshot: EpochSnapshot, params, state,
               epoch: int, keep_history: bool) -> None:
        """Append the snapshot (stripped to its metrics unless
        ``keep_history``), track the best model and the patience."""
        current = _agg_loss(snapshot.l_val, self.agg_name, self.metric)
        history.append(snapshot if keep_history else EpochSnapshot(snapshot.l_train, snapshot.l_val))
        if is_better(current, self.best_loss, self.metric):
            self.best_loss = current
            self.best_params = snapshot_tensors(params)
            self.best_state = snapshot_tensors(state)
            self.best_epoch = epoch
            self.counter = 0
        else:
            self.counter += 1
        if self.patience is not None and self.counter >= self.patience:
            log.warning(
                "Early stopping at epoch %d, best validation loss wrt %s: %.6g at epoch %d",
                epoch, self.metric, self.best_loss, self.best_epoch,
            )
            self.done = True

    def best_or_final(self, params, state, return_model: str):
        if return_model == "best":
            log.info("Returning best model from epoch %d with validation loss %.6g",
                     self.best_epoch, self.best_loss)
            return self.best_params, self.best_state
        log.info("Returning final model; best validation loss was %.6g at epoch %d",
                 self.best_loss, self.best_epoch)
        return snapshot_tensors(params), snapshot_tensors(state)


class DeviceStopper:
    """:class:`EarlyStopping`'s patience arithmetic on the device.

    ``value`` is the monitored metric's aggregate in a snapshot's row (a 0-d
    float32 tensor); ``kept`` maps names to the tensors whose best values are
    kept (a fused engine's packed buffers, or the torch engine's leaves).
    ``done`` is an int32 word, 1 once the patience ran out: a training kernel
    given its address returns at entry, and :meth:`update` ignores every
    snapshot after it. Nothing here waits for the device."""

    def __init__(self, value: torch.Tensor, kept: Dict[str, torch.Tensor], cfg):
        self.maximize = best_direction(monitored(cfg)[0]) == "max"
        self.patience = cfg.patience
        dev = value.device
        self.best_loss = value.detach().clone()
        self.best_epoch = torch.zeros((), dtype=torch.int64, device=dev)
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        self.done = torch.zeros((), dtype=torch.int32, device=dev)
        self.kept = snapshot_tensors(kept)

    def update(self, value: torch.Tensor, epoch: int, current: Dict[str, torch.Tensor]) -> None:
        """One snapshot at ``epoch``: the comparison, the best tensors, and
        with a patience the counter and the ``done`` word, in place where
        the kernels read it (without one, ``done`` stays 0)."""
        better = (value > self.best_loss) if self.maximize else (value < self.best_loss)
        if self.patience is not None:
            live = self.done == 0
            better = better & live
            self.counter = torch.where(live, torch.where(better, 0, self.counter + 1),
                                       self.counter)
            self.done.copy_((~live) | (self.counter >= self.patience))
        self.best_loss = torch.where(better, value, self.best_loss)
        self.best_epoch = torch.where(better, epoch, self.best_epoch)
        self.kept = {k: torch.where(better, current[k], v) for k, v in self.kept.items()}
