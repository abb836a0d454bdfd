"""Neural-network modules of the hybrid models, as ``torch.nn.Module``s.

PyTorch counterpart of ``easyhybrid_tpu/models/nn.py``. The same names and
semantics, in PyTorch idiom:

* :class:`Dense` keeps torch's ``(out, in)`` weight layout; the JAX package
  stores ``(in, out)``, so carrying weights across transposes them
  (``interop.load_jax_params``).
* :class:`BatchNorm` keeps all three forms of ``input_batchnorm``: False (no
  module), ``"static"`` (frozen pre-fitted statistics) and True (trainable;
  in training mode it normalises with the batch statistics and updates a
  running EMA of the biased variance, unlike ``torch.nn.BatchNorm1d``).
  Statistics are buffers, scale and bias are parameters.
* :class:`LSTMNet` is the JAX package's cell (one bias, gates i, f, g, o)
  with ``wi`` / ``wh`` stored ``(4H, F)`` / ``(4H, H)`` and a Dense head per
  time step; ``construct_nn({"lstm": H}, ...)`` builds it.
* Initialisation draws from an explicit ``torch.Generator``.
* The activations copy JAX's: ``gelu`` is the tanh approximation,
  ``softplus`` has no identity threshold, ``leakyrelu`` has slope 0.01.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Activation",
    "Dense",
    "BatchNorm",
    "MLP",
    "LSTMNet",
    "construct_nn",
    "get_activation",
    "glorot_uniform",
    "ACTIVATIONS",
]


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def _softplus(x):
    # log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|)), with no threshold above
    # which it turns into the identity (torch's F.softplus switches at 20)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _identity(x):
    return x


ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "swish": F.silu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": _softplus,
    "selu": F.selu,
    "elu": F.elu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "identity": _identity,
    "linear": _identity,
}

Activation = Union[str, Callable, None]


def get_activation(act: Activation) -> Callable:
    """Resolve an activation name or callable to a tensor function."""
    if act is None:
        return ACTIVATIONS["identity"]
    if callable(act):
        return act
    key = str(act).lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


def _norm_act(act: Activation):
    """Normalize an activation spec: lowercase known names, keep callables."""
    if act is None:
        return "identity"
    if isinstance(act, str):
        return act.lower()
    return act


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def glorot_uniform(
    fan_in: int,
    fan_out: int,
    *,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Glorot-uniform ``(fan_out, fan_in)`` weight (torch's layout)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty((fan_out, fan_in), dtype=dtype)
    return w.uniform_(-limit, limit, generator=generator)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

class Dense(nn.Module):
    """Affine layer ``act(x @ W.T + b)`` with ``(batch, feat)`` inputs.

    ``compute_dtype`` runs the product in that dtype (e.g. bfloat16) and
    returns float32.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        activation: Activation = "identity",
        use_bias: bool = True,
        dtype=torch.float32,
        compute_dtype=None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.activation = _norm_act(activation)
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            glorot_uniform(self.in_dim, self.out_dim, generator=generator, dtype=dtype)
        )
        self.bias = (
            nn.Parameter(torch.zeros((self.out_dim,), dtype=dtype)) if use_bias else None
        )

    def forward(self, x):
        w = self.weight
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            w = w.to(self.compute_dtype)
        y = F.linear(x, w).to(torch.float32)
        if self.bias is not None:
            y = y + self.bias
        return get_activation(self.activation)(y)


class BatchNorm(nn.Module):
    """BatchNorm over the last (feature) axis of ``(N, F)`` or ``(N, T, F)``.

    ``frozen=True`` is the static input standardisation: the statistics are
    pre-fitted (``training.train.fit_input_norm``) and never updated.
    Otherwise, in training mode, the batch's mean and biased variance
    normalise the batch and move the running statistics by ``momentum``.
    """

    def __init__(
        self,
        in_dim: int,
        momentum: float = 0.1,
        eps: float = 1e-5,
        affine: bool = True,
        frozen: bool = False,
    ):
        super().__init__()
        self.in_dim = int(in_dim)
        self.momentum, self.eps = float(momentum), float(eps)
        self.frozen = bool(frozen)
        if affine:
            self.scale = nn.Parameter(torch.ones((self.in_dim,)))
            self.bias = nn.Parameter(torch.zeros((self.in_dim,)))
        else:
            self.scale = self.bias = None
        self.register_buffer("mean", torch.zeros((self.in_dim,)))
        self.register_buffer("var", torch.ones((self.in_dim,)))

    @property
    def out_dim(self) -> int:
        return self.in_dim

    def forward(self, x):
        if self.training and not self.frozen:
            reduce_dims = tuple(range(x.ndim - 1))
            mean = x.mean(dim=reduce_dims)
            var = x.var(dim=reduce_dims, unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.scale is not None:
            y = y * self.scale + self.bias
        return y


class MLP(nn.Module):
    """Feed-forward stack: optional input BatchNorm → hidden Dense(act) →
    output Dense(output_activation). Input ``(batch, in_dim)`` or ``(batch,
    time, in_dim)``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hidden: Sequence[int] = (32, 32),
        activation: Activation = "tanh",
        output_activation: Activation = "identity",
        input_batchnorm: Any = False,  # True | False | "static"
        dtype=torch.float32,
        compute_dtype=None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.hidden: Tuple[int, ...] = tuple(int(h) for h in hidden)
        self.activation = _norm_act(activation)
        self.output_activation = _norm_act(output_activation)
        self.input_batchnorm = input_batchnorm
        self.dtype, self.compute_dtype = dtype, compute_dtype
        dims = (self.in_dim,) + self.hidden + (self.out_dim,)
        acts = [self.activation] * len(self.hidden) + [self.output_activation]
        self.layers = nn.ModuleList(
            Dense(
                dims[i],
                dims[i + 1],
                acts[i],
                dtype=dtype,
                compute_dtype=compute_dtype,
                generator=generator,
            )
            for i in range(len(dims) - 1)
        )
        self.norm = (
            BatchNorm(self.in_dim, frozen=(input_batchnorm == "static"))
            if input_batchnorm
            else None
        )

    def forward(self, x):
        if self.norm is not None:
            x = self.norm(x)
        for layer in self.layers:
            x = layer(x)
        return x


class LSTMNet(nn.Module):
    """LSTM over ``(batch, time, features)`` returning the full sequence,
    followed by a per-time-step Dense head: ``(batch, time, out_dim)``.

    The cell is the JAX package's: one bias ``b`` (zeros at start), gates in
    the order i, f, g, o along ``4H``, ``h0 = c0 = 0``. ``wi`` is stored
    ``(4H, F)`` and ``wh`` ``(4H, H)`` (the JAX package stores both
    transposed; ``interop.load_jax_params`` carries them across), both
    Glorot-uniform over the ``(F, 4H)`` and ``(H, 4H)`` matrices. The
    recurrence is a loop of two products per step; it is not
    ``torch.nn.LSTM``, which has two biases and another initialisation.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hidden_size: int = 32,
        output_activation: Activation = "identity",
        input_batchnorm: Any = False,  # True | False | "static"
        dtype=torch.float32,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.hidden_size = h = int(hidden_size)
        self.output_activation = _norm_act(output_activation)
        self.input_batchnorm = input_batchnorm
        self.dtype = dtype
        self.wi = nn.Parameter(glorot_uniform(self.in_dim, 4 * h, generator=generator, dtype=dtype))
        self.wh = nn.Parameter(glorot_uniform(h, 4 * h, generator=generator, dtype=dtype))
        self.b = nn.Parameter(torch.zeros((4 * h,), dtype=dtype))
        self.head = Dense(h, self.out_dim, self.output_activation, dtype=dtype,
                          generator=generator)
        self.norm = (
            BatchNorm(self.in_dim, frozen=(input_batchnorm == "static"))
            if input_batchnorm
            else None
        )

    def forward(self, x):
        if x.ndim != 3:
            raise ValueError(
                f"LSTMNet expects (batch, time, features); got shape {tuple(x.shape)}"
            )
        if self.norm is not None:
            x = self.norm(x)
        n, steps, _ = x.shape
        h = x.new_zeros((n, self.hidden_size), dtype=torch.float32)
        c = torch.zeros_like(h)
        hs = []
        for t in range(steps):
            gates = F.linear(x[:, t], self.wi) + F.linear(h, self.wh) + self.b
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return self.head(torch.stack(hs, dim=1))


# --------------------------------------------------------------------------
# constructor
# --------------------------------------------------------------------------

def construct_nn(
    hidden_layers: Union[Sequence[int], nn.Module, dict],
    in_dim: int,
    out_dim: int,
    *,
    activation: Activation = "tanh",
    output_activation: Activation = "identity",
    input_batchnorm: Any = False,
    compute_dtype=None,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build an NN module from a layer-size list, a recurrent spec dict
    ``{"lstm": hidden_size}`` (an :class:`LSTMNet`, which has no hidden
    ``activation`` and refuses a ``compute_dtype``), or pass a module
    through."""
    if isinstance(hidden_layers, nn.Module):
        return hidden_layers
    if isinstance(hidden_layers, dict):
        if "lstm" in hidden_layers:
            if compute_dtype is not None:
                raise ValueError(
                    "compute_dtype is not supported with the {'lstm': n} spec; "
                    "LSTM hybrids run float32"
                )
            return LSTMNet(
                in_dim,
                out_dim,
                hidden_size=int(hidden_layers["lstm"]),
                output_activation=output_activation,
                input_batchnorm=input_batchnorm,
                generator=generator,
            )
        raise ValueError(f"unknown NN spec dict: {hidden_layers!r}")
    return MLP(
        in_dim,
        out_dim,
        hidden=tuple(int(h) for h in hidden_layers),
        activation=activation,
        output_activation=output_activation,
        input_batchnorm=input_batchnorm,
        compute_dtype=compute_dtype,
        generator=generator,
    )
