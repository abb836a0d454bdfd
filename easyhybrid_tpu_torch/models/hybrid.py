"""Hybrid models: a neural network composed with a mechanistic model.

PyTorch counterpart of ``easyhybrid_tpu/models/hybrid.py``.
:class:`SingleNNHybridModel` is an ``nn.Module`` whose ``forward(x,
forcing)`` returns the same outputs dict as the JAX ``apply``:
``{**mechanistic_outputs, "parameters": all_params}``. Where the JAX model
threads ``params`` / ``state`` pytrees, this one holds them:

* the network's weights and the raw (unconstrained) globals are parameters;
* the network's norm statistics and the fixed parameters are buffers;
* ``module.training`` takes the place of the ``training=`` argument;
* the parameter table is ``param_table`` (``nn.Module.parameters`` is
  taken).

MultiNN models (a Mapping of predictors) are not ported yet.
"""

from __future__ import annotations

import inspect
import itertools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..params import (
    ParameterContainer,
    build_parameters,
    scale_param,
    unscale_param,
)
from ..utils.device import default_device
from .nn import construct_nn

__all__ = [
    "SingleNNHybridModel",
    "construct_hybrid_model",
]


def _as_tuple(xs) -> Tuple[str, ...]:
    if xs is None:
        return ()
    if isinstance(xs, str):
        return (xs,)
    return tuple(str(x) for x in xs)


def _call_mechanistic(fn: Callable, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Call the user's mechanistic function with the merged forcing+parameter
    kwargs, passing only what its signature accepts (unless it takes **kw)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None
    if sig is not None:
        has_var_kw = any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
        )
        if not has_var_kw:
            accepted = {
                name
                for name, p in sig.parameters.items()
                if p.kind
                in (
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.KEYWORD_ONLY,
                )
            }
            missing = [
                name
                for name, p in sig.parameters.items()
                if p.default is inspect.Parameter.empty
                and p.kind
                in (
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.KEYWORD_ONLY,
                )
                and name not in kwargs
            ]
            if missing:
                raise KeyError(
                    f"mechanistic model {getattr(fn, '__name__', fn)!r} requires "
                    f"{missing} but only {sorted(kwargs)} are available "
                    "(forcing + parameters)"
                )
            kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    out = fn(**kwargs)
    return _normalize_outputs(out)


def _normalize_outputs(out) -> Dict[str, Any]:
    if isinstance(out, Mapping):
        return dict(out)
    if hasattr(out, "_asdict"):  # NamedTuple
        return dict(out._asdict())
    raise TypeError(
        "mechanistic model must return a dict (or NamedTuple) of named "
        f"outputs; got {type(out).__name__}"
    )


def _freeze_config(cfg: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    def freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(freeze(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, freeze(x)) for k, x in v.items()))
        return v

    return tuple(sorted((k, freeze(v)) for k, v in cfg.items()))


class _Scalars(nn.Module):
    """Named ``(1,)`` float32 scalars, as parameters or as buffers."""

    def __init__(self, values: Mapping[str, float], *, trainable: bool):
        super().__init__()
        self.names = tuple(values)
        for name, v in values.items():
            t = torch.full((1,), float(v), dtype=torch.float32)
            if trainable:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.names}


class SingleNNHybridModel(nn.Module):
    """One NN predicting several physical parameters, plus global and fixed
    parameters, feeding a mechanistic model."""

    def __init__(
        self,
        nn: Optional[nn.Module],
        predictors: Tuple[str, ...],
        forcing: Tuple[str, ...],
        targets: Tuple[str, ...],
        mechanistic_model: Callable,
        parameters: ParameterContainer,
        neural_param_names: Tuple[str, ...],
        global_param_names: Tuple[str, ...],
        fixed_param_names: Tuple[str, ...],
        scale_nn_outputs: bool = False,
        start_from_default: bool = True,
        config: Tuple[Tuple[str, Any], ...] = (),
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.nn = nn
        self.predictors = predictors
        self.forcing = forcing
        self.targets = targets
        self.mechanistic_model = mechanistic_model
        self.param_table = parameters
        self.neural_param_names = neural_param_names
        self.global_param_names = global_param_names
        self.fixed_param_names = fixed_param_names
        self.scale_nn_outputs = scale_nn_outputs
        self.start_from_default = start_from_default
        self.config = config
        self.globals = _Scalars(self._init_globals(generator), trainable=True)
        self.fixed = _Scalars(
            {f: parameters.default_of(f) for f in fixed_param_names},
            trainable=False,
        )

    def _init_globals(self, generator) -> Dict[str, float]:
        """Raw globals seeded at the inverse sigmoid of the table default, or
        uniform in (0, 1) when ``start_from_default`` is off."""
        out = {}
        for g in self.global_param_names:
            if self.start_from_default:
                p = self.param_table
                out[g] = unscale_param(p.default_of(g), p.lower_of(g), p.upper_of(g))
            else:
                out[g] = float(torch.rand((), generator=generator))
        return out

    def _scale_globals(self) -> Dict[str, torch.Tensor]:
        p = self.param_table
        return {
            g: scale_param(raw, p.lower_of(g), p.upper_of(g))
            for g, raw in self.globals.as_dict().items()
        }

    def _split_nn_outputs(self, nn_out) -> Dict[str, torch.Tensor]:
        """Column i of the NN output is parameter ``neural_param_names[i]``,
        optionally sigmoid-scaled into its bounds."""
        out = {}
        for i, name in enumerate(self.neural_param_names):
            col = nn_out[..., i]
            if self.scale_nn_outputs:
                p = self.param_table
                col = scale_param(col, p.lower_of(name), p.upper_of(name))
            out[name] = col
        return out

    def forward(self, x, forcing: Optional[Mapping[str, Any]] = None):
        """Hybrid forward on ``x (N, F)`` and a forcing dict name → ``(N,)``,
        or, for a sequence network, on windows ``x (N, T, F)`` with forcing
        ``(N, T)``: the mechanistic model then runs at every time step.
        Returns ``{**mechanistic_outputs, "parameters": all_params}``."""
        if forcing is not None and not isinstance(forcing, Mapping):
            raise TypeError(
                f"forcing must be a dict name->tensor; got {type(forcing).__name__}"
            )
        global_params = self._scale_globals()
        if self.nn is not None and self.neural_param_names:
            nn_params = self._split_nn_outputs(self.nn(x))
        else:
            nn_params = {}
        all_params = {**nn_params, **global_params, **self.fixed.as_dict()}
        all_kwargs = {**(forcing or {}), **all_params}
        y_pred = _call_mechanistic(self.mechanistic_model, all_kwargs)
        return {**y_pred, "parameters": all_params}

    @property
    def device(self) -> torch.device:
        """The device of the model's tensors (CPU for a model with none)."""
        for t in itertools.chain(self.parameters(), self.buffers()):
            return t.device
        return torch.device("cpu")

    def predict_df(self, df):
        """Eval-mode inference on a DataFrame: a copy with ``<output>_pred``
        columns for every per-sample output. Missing values become NaN and
        no row is dropped."""
        from ..data.prepare import prepare_data

        data = prepare_data(self, df, drop_missing_rows=False)
        dev = self.device
        x = torch.tensor(data.x, device=dev)
        forcing = {k: torch.tensor(v, device=dev) for k, v in data.forcing.items()}
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                outputs = self(x, forcing)
        finally:
            self.train(was_training)
        n = data.n_samples
        out_df = df.copy()
        columns = {k: v for k, v in outputs.items() if not isinstance(v, Mapping)}
        columns.update(outputs.get("parameters", {}))
        for k, v in columns.items():
            arr = np.asarray(v.detach().cpu()) if torch.is_tensor(v) else np.asarray(v)
            if arr.ndim == 1 and arr.shape[0] == n:
                out_df[f"{k}_pred"] = arr
        return out_df


def construct_hybrid_model(
    predictors: Union[Sequence[str], Mapping[str, Sequence[str]]] = (),
    forcing: Sequence[str] = (),
    targets: Sequence[str] = (),
    mechanistic_model: Callable = None,
    parameters: Union[ParameterContainer, Mapping[str, Any]] = None,
    neural_param_names: Optional[Sequence[str]] = None,
    global_param_names: Sequence[str] = (),
    *,
    hidden_layers: Any = (32, 32),
    activation: Any = "tanh",
    scale_nn_outputs: bool = False,
    input_batchnorm: Any = False,
    start_from_default: bool = True,
    compute_dtype: Any = None,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
    **kwargs,
) -> SingleNNHybridModel:
    """Build a hybrid model from a list of predictor names (one NN with
    ``len(neural_param_names)`` outputs). Weights are drawn from
    ``generator`` on the CPU, then the model moves to ``device``: the CUDA
    device when there is one and the caller names none
    (:func:`~easyhybrid_tpu_torch.utils.device.default_device`).

    A mapping of predictors (one NN per parameter) raises: MultiNN models
    are not ported yet.
    """
    if mechanistic_model is None:
        raise ValueError("mechanistic_model is required")
    if isinstance(predictors, Mapping):
        raise NotImplementedError(
            "MultiNNHybridModel (a mapping of predictors) is not ported to "
            "easyhybrid_tpu_torch yet (ROADMAP.md, queue A, item 'MultiNN')"
        )
    parameters = build_parameters(parameters, mechanistic_model)
    all_names = parameters.names

    config = _freeze_config(
        dict(
            hidden_layers=hidden_layers,
            activation=activation,
            scale_nn_outputs=scale_nn_outputs,
            input_batchnorm=input_batchnorm,
            start_from_default=start_from_default,
            compute_dtype=compute_dtype,
            **kwargs,
        )
    )

    global_param_names = _as_tuple(global_param_names)
    for g in global_param_names:
        if g not in all_names:
            raise ValueError(f"global parameter {g!r} not in parameter table")

    predictors = _as_tuple(predictors)
    neural_param_names = _as_tuple(neural_param_names)
    for n in neural_param_names:
        if n not in all_names:
            raise ValueError(f"neural parameter {n!r} not in parameter table")
    if predictors and neural_param_names:
        net = construct_nn(
            hidden_layers,
            len(predictors),
            len(neural_param_names),
            activation=activation,
            input_batchnorm=input_batchnorm,
            compute_dtype=compute_dtype,
            generator=generator,
        )
    else:
        net = None
    fixed = tuple(
        n
        for n in all_names
        if n not in neural_param_names and n not in global_param_names
    )
    model = SingleNNHybridModel(
        nn=net,
        predictors=predictors,
        forcing=_as_tuple(forcing),
        targets=_as_tuple(targets),
        mechanistic_model=mechanistic_model,
        parameters=parameters,
        neural_param_names=neural_param_names,
        global_param_names=global_param_names,
        fixed_param_names=fixed,
        scale_nn_outputs=scale_nn_outputs,
        start_from_default=start_from_default,
        config=config,
        generator=generator,
    )
    return model.to(default_device() if device is None else device)
