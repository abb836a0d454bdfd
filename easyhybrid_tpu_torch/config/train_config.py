"""Training / data configuration records and results.

PyTorch counterpart of ``easyhybrid_tpu/config/train_config.py``. The same
fields, with ``use_pallas`` renamed ``use_kernel`` (the fused CUDA epoch
kernel). Fields the port cannot honour yet raise ``NotImplementedError`` in
:func:`validate_config` when they are set away from their default, naming
their ROADMAP item. ``TrainResults`` keeps the observed and predicted
columns as numpy dicts; its ``train_obs`` / ``train_pred`` / ``val_obs`` /
``val_pred`` build pandas DataFrames on access, importing pandas there and
only there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..losses.metrics import check_training_loss

__all__ = ["TrainConfig", "DataConfig", "TrainResults", "validate_config"]


@dataclasses.dataclass
class TrainConfig:
    """Knobs for :func:`easyhybrid_tpu_torch.train`.

    ``optimizer`` is a name (``"adam"``, ``"sgd"``, …), a ``(name, lr)``
    tuple or ``(name, {hyperparameters})`` (see ``training/optimizers.py``).
    ``use_kernel``: ``"auto"`` runs the fused CUDA epoch kernel on a CUDA
    model inside its envelope once the exactness gate passed; True makes the
    kernel a candidate on any device (on CPU tensors it computes its plain
    version); False always runs the torch epoch.
    """

    nepochs: int = 200
    batchsize: Optional[int] = 64
    optimizer: Any = ("adam", 0.01)
    # a prebuilt optimizer state (a torch-engine run's TrainResults.opt_state);
    # it sends the run to the torch engine
    opt_state: Any = None
    # patience counts EVAL SNAPSHOTS without improvement, not raw epochs
    patience: Optional[int] = None
    training_loss: Any = "mse"
    loss_types: Sequence[Any] = ("mse", "r2")
    extra_loss: Optional[Callable] = None
    agg: Union[str, Callable] = "sum"
    train_from: Any = None          # (params, state) | TrainResults
    random_seed: int = 161803
    model_name: str = "hybrid_model"
    return_model: str = "best"      # "best" | "final"
    keep_history: bool = False      # keep per-epoch prediction snapshots
    save_training: bool = False
    monitor_names: Sequence[str] = ()
    tracked_params: Sequence[str] = ()
    output_folder: Optional[str] = None
    plotting: bool = False
    show_progress: bool = True
    yscale: str = "log"
    # True = full sample reshuffle per epoch; "batches" = permute the batch
    # order only; False = chronological
    shuffle_each_epoch: Any = True
    return_gradients: bool = False
    full_batch: bool = False
    promote_f64: bool = False
    second_order: bool = False
    # evaluate / early-stop every N epochs; the fused kernel runs the N
    # epochs of a block in one launch (trailing nepochs % N epochs are skipped)
    eval_every: int = 1
    inner_maxiters: int = 10
    # no effect on the arithmetic (PyTorch runs eagerly); False forces the
    # eager loop, as it does in the JAX package
    jit: bool = True
    multi_device: bool = False
    mesh: Any = None
    checkpoint_every: int = 1
    checkpoint_format: str = "pickle"
    use_kernel: Any = "auto"
    # recompute the torch epoch's forward in the backward pass; the fused
    # kernels ignore it, as the JAX kernels do
    remat: bool = False

    def replace(self, **kwargs) -> "TrainConfig":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class DataConfig:
    """Data handling knobs."""

    shuffleobs: bool = False
    split_by_id: Union[None, str, Sequence] = None
    split_data_at: float = 0.8
    folds: Union[None, str, Sequence] = None
    val_fold: Optional[int] = None
    sequence_length: Optional[int] = None
    sequence_kwargs: Optional[dict] = None
    input_batchnorm: bool = False

    def replace(self, **kwargs) -> "DataConfig":
        return dataclasses.replace(self, **kwargs)


# field -> (default, what is missing, ROADMAP item)
_NOT_PORTED_TRAIN = {
    "multi_device": (False, "data parallelism over several devices", "item 15"),
    "mesh": (None, "data parallelism over a device mesh", "item 15"),
    "second_order": (False, "the second-order (linesearch) driver", "item 12"),
    "full_batch": (False, "the second-order driver's full-batch mode", "item 12"),
    "promote_f64": (False, "the second-order driver's float64 mode", "item 12"),
    "save_training": (False, "checkpoints and metric streams", "item 16"),
    "plotting": (False, "plotting", "item 16"),
}


def validate_config(cfg: TrainConfig, data_cfg: Optional[DataConfig] = None) -> None:
    """Sanity checks, plus a ``NotImplementedError`` for every field set to
    something the port does not do yet."""
    if cfg.nepochs < 0:
        raise ValueError("nepochs must be >= 0")
    if cfg.batchsize is not None and cfg.batchsize <= 0:
        raise ValueError("batchsize must be positive (or None for full batch)")
    if cfg.patience is not None and cfg.patience <= 0:
        raise ValueError("patience must be positive (or None to disable)")
    if cfg.return_model not in ("best", "final"):
        raise ValueError("return_model must be 'best' or 'final'")
    check_training_loss(cfg.training_loss)
    if not cfg.loss_types:
        raise ValueError("loss_types must not be empty")
    for field, (default, what, item) in _NOT_PORTED_TRAIN.items():
        if getattr(cfg, field) != default:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: {what} is not ported to "
                f"easyhybrid_tpu_torch yet (ROADMAP.md, queue A, {item})"
            )


def _frame(columns: Optional[Dict[str, np.ndarray]]):
    if columns is None:
        return None
    import pandas as pd

    return pd.DataFrame(columns)


@dataclasses.dataclass
class TrainResults:
    """Training outcome record.

    ``train_history`` / ``val_history`` are lists of nested metric dicts
    (one per evaluated epoch, index 0 = the initial state). ``params`` /
    ``state`` are the returned (best or final) parameters and buffers as
    CPU tensors keyed like ``model.named_parameters()`` / ``named_buffers()``.
    ``*_obs_columns`` / ``*_pred_columns`` are numpy dicts; the matching
    ``*_obs`` / ``*_pred`` properties wrap them in DataFrames.
    ``epoch_path`` is ``"cuda_fused_epoch"``, ``"cuda_fused_wide"``,
    ``"cuda_fused_lstm"``, ``"cuda_fused_lstm_split"``, ``"cuda_fused_multisite"`` or
    ``"torch"``;
    ``engine_reason`` says why."""

    train_history: Any = None
    val_history: Any = None
    train_obs_columns: Optional[Dict[str, np.ndarray]] = None
    train_pred_columns: Optional[Dict[str, np.ndarray]] = None
    val_obs_columns: Optional[Dict[str, np.ndarray]] = None
    val_pred_columns: Optional[Dict[str, np.ndarray]] = None
    train_diffs: Any = None
    val_diffs: Any = None
    params: Any = None
    state: Any = None
    best_epoch: int = 0
    best_loss: float = float("nan")
    history: Any = None
    paths: Any = None
    tracked: Any = None
    monitored: Any = None
    opt_state: Any = None
    grad_history: Any = None
    metrics_stream: Any = None
    epoch_path: Any = None
    loop_mode: Any = None
    engine_reason: Any = None
    final_grads: Any = None

    @property
    def train_obs(self):
        return _frame(self.train_obs_columns)

    @property
    def train_pred(self):
        return _frame(self.train_pred_columns)

    @property
    def val_obs(self):
        return _frame(self.val_obs_columns)

    @property
    def val_pred(self):
        return _frame(self.val_pred_columns)

    @property
    def ps_st(self) -> Tuple[Any, Any]:
        return self.params, self.state

    def history_frame(self):
        """Per-epoch metric table, columns ``{split}_{metric}_{target}``."""
        import pandas as pd

        rows = []
        for epoch, (tr, va) in enumerate(zip(self.train_history, self.val_history)):
            row = {"epoch": epoch}
            for split, metrics in (("train", tr), ("val", va)):
                for metric, targets in metrics.items():
                    for target, value in targets.items():
                        row[f"{split}_{metric}_{target}"] = float(value)
            rows.append(row)
        return pd.DataFrame(rows)

    def __repr__(self):
        n_ep = len(self.train_history) - 1 if self.train_history else 0
        return (
            "TrainResults(\n"
            f"  epochs trained = {n_ep}\n"
            f"  best epoch     = {self.best_epoch}\n"
            f"  best val loss  = {self.best_loss}\n"
            f"  epoch path     = {self.epoch_path}\n"
            f"  fields: train_history, val_history, train_obs, train_pred,\n"
            f"          val_obs, val_pred, train_diffs, val_diffs, params,\n"
            f"          state, history\n"
            ")"
        )
