"""easyhybrid_tpu_torch: the PyTorch / CUDA port of easyhybrid_tpu.

This slice is the serving path: build a hybrid model, carry its parameters
in (or initialise them from a ``torch.Generator``), fit its static input
norm, and run ``make_inference_fn`` / ``predict``. On a CUDA device a model
inside the envelope runs the hand-written fused forward kernel
(``csrc/fused_forward.cu``), compiled with ``nvcc`` at first use.

Importing the package imports torch and numpy only.
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
from .data.loaders import build_epoch_tensors, pad_axis0
from .data.synthetic import gen_rbq10_data, rbq10_columns
from .models.nn import ACTIVATIONS, BatchNorm, Dense, LSTMNet, MLP, construct_nn
from .models.hybrid import SingleNNHybridModel, construct_hybrid_model
from .training.train import fit_input_norm
from .training.inference import make_inference_fn, predict
from .interop import load_jax_params
from .ops.fused_forward import (
    kernel_form,
    make_fused_forward,
    rbq10,
    supports_fused_forward,
)

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
    "fit_input_norm",
    "make_inference_fn",
    "predict",
    "load_jax_params",
    "kernel_form",
    "make_fused_forward",
    "rbq10",
    "supports_fused_forward",
]
