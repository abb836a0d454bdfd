"""easyhybrid_tpu_torch: the PyTorch / CUDA port of easyhybrid_tpu.

The port covers serving and training: build a hybrid model (single-series
over an MLP, over an LSTM on sequence windows with ``hidden_layers={"lstm":
H}`` and ``train(..., sequence_kwargs=...)``, or lifted over sites with
``MultiSiteHybridModel``), carry its parameters in
(or initialise them from a ``torch.Generator``), ``train`` it, and run
``make_inference_fn`` / ``predict``. Models are built on the CUDA device
when there is one, and the entry points follow the model's device. There a
model inside the envelopes runs hand-written kernels, compiled with ``nvcc``
at first use: the fused forward (``csrc/fused_forward.cu``) for serving, and
the fused training epochs (``csrc/fused_epoch.cu``, ``csrc/fused_wide.cu``
for MLPs too wide for one thread block, ``csrc/fused_epoch_lstm.cu`` for LSTM
hybrids and ``csrc/fused_multisite.cu`` for multi-site models), which
``train`` enables behind a runtime exactness gate.

Importing the package imports torch and numpy only; pandas is imported
only where a DataFrame is read or built.
"""

from .version import __version__
from .params import (
    ParameterContainer,
    build_parameters,
    scale_param,
    unscale_param,
    sigmoid,
    hard_sigmoid,
    inv_hard_sigmoid,
    inv_sigmoid,
)
from .data.prepare import HybridData, prepare_data
from .data.loaders import batch_iterator, build_epoch_tensors, pad_axis0
from .data.sequences import filter_sequences, split_into_sequences
from .data.synthetic import (
    gen_linear_data,
    gen_linear_data_2outputs,
    gen_multisite_arrays,
    gen_rbq10_data,
    rbq10_columns,
)
from .models.nn import ACTIVATIONS, BatchNorm, Dense, LSTMNet, MLP, construct_nn
from .models.hybrid import SingleNNHybridModel, construct_hybrid_model
from .parallel.multisite import MultiSiteHybridModel, prepare_multisite_data
from .data.split import prepare_splits, split_data, train_val_indices
from .config.train_config import DataConfig, TrainConfig, TrainResults, validate_config
from .losses.metrics import (
    METRICS,
    best_direction,
    check_training_loss,
    huber,
    is_better,
    loss_fn,
    masked_mean,
    pinball,
    register_metric,
)
from .losses.specs import (
    ElementwiseLoss,
    ExtraLoss,
    FunctionLoss,
    LoggingLoss,
    ParameterizedLoss,
    PerTarget,
    SymbolicLoss,
)
from .losses.compute import compute_loss
from .utils.weights import extract_weights, l2_extra_loss, weight_l2
from .training.early_stopping import EarlyStopping
from .training.history import EpochSnapshot, TrainingHistory
from .training.optimizers import resolve_optimizer
from .training.train import fit_input_norm, train
from .training.inference import make_inference_fn, predict
from .interop import export_jax_params, load_jax_params
from .ops.fused_forward import (
    kernel_form,
    make_fused_forward,
    rbq10,
    supports_fused_forward,
)
from .ops.fused_epoch import make_fused_epoch, supports_fused_epoch
from .ops.fused_epoch_lstm import make_fused_lstm_epoch, supports_fused_epoch_lstm
from .ops.fused_multisite import make_fused_multisite_epoch, supports_fused_multisite
from .ops.fused_wide import make_fused_wide_epoch, supports_fused_wide
from .utils.device import default_device

__all__ = [
    "__version__",
    "ParameterContainer",
    "build_parameters",
    "scale_param",
    "unscale_param",
    "sigmoid",
    "hard_sigmoid",
    "inv_hard_sigmoid",
    "inv_sigmoid",
    "HybridData",
    "prepare_data",
    "build_epoch_tensors",
    "pad_axis0",
    "gen_multisite_arrays",
    "gen_rbq10_data",
    "rbq10_columns",
    "ACTIVATIONS",
    "BatchNorm",
    "Dense",
    "LSTMNet",
    "MLP",
    "construct_nn",
    "SingleNNHybridModel",
    "construct_hybrid_model",
    "MultiSiteHybridModel",
    "prepare_multisite_data",
    "split_data",
    "DataConfig",
    "TrainConfig",
    "TrainResults",
    "METRICS",
    "best_direction",
    "huber",
    "is_better",
    "loss_fn",
    "pinball",
    "register_metric",
    "ElementwiseLoss",
    "LoggingLoss",
    "PerTarget",
    "l2_extra_loss",
    "fit_input_norm",
    "train",
    "make_inference_fn",
    "predict",
    "export_jax_params",
    "load_jax_params",
    "kernel_form",
    "make_fused_forward",
    "rbq10",
    "supports_fused_forward",
    "make_fused_epoch",
    "supports_fused_epoch",
    "make_fused_lstm_epoch",
    "supports_fused_epoch_lstm",
    "make_fused_multisite_epoch",
    "supports_fused_multisite",
    "make_fused_wide_epoch",
    "supports_fused_wide",
    "default_device",
    "TrainingHistory",
    "EpochSnapshot",
    "EarlyStopping",
    "resolve_optimizer",
    "compute_loss",
    "validate_config",
    "split_into_sequences",
    "filter_sequences",
    "train_val_indices",
    "prepare_splits",
    "batch_iterator",
    "masked_mean",
    "check_training_loss",
    "SymbolicLoss",
    "FunctionLoss",
    "ParameterizedLoss",
    "ExtraLoss",
    "extract_weights",
    "weight_l2",
    "gen_linear_data",
    "gen_linear_data_2outputs",
]
