"""Early stopping and best-model tracking.

PyTorch counterpart of ``easyhybrid_tpu/training/early_stopping.py``:
direction-aware comparison on the aggregated scalar of the first entry of
``loss_types`` (looked up by name), a patience counter, and a snapshot of
the best parameters and buffers, copied on their device.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from ..losses.metrics import is_better
from ..losses.specs import agg_name as _spec_agg_name
from ..losses.specs import loss_name
from .history import EpochSnapshot, TrainingHistory, _agg_loss

__all__ = ["EarlyStopping", "snapshot_tensors"]

log = logging.getLogger("easyhybrid_tpu_torch")


def snapshot_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached copies of ``name -> tensor``."""
    return {k: v.detach().clone() for k, v in tensors.items()}


class EarlyStopping:
    def __init__(self, init_snapshot: EpochSnapshot, params, state, cfg):
        self.agg_name = _spec_agg_name(cfg.agg)
        self.metric = loss_name(cfg.loss_types[0] if cfg.loss_types else cfg.training_loss)
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
