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

:class:`MultiNNHybridModel` (a Mapping of predictors) holds one network
per neural parameter in ``nns`` and takes ``x`` as a dict by branch.
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
    "MultiNNHybridModel",
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


class _HybridModel(nn.Module):
    """What every hybrid model shares: the static description, the raw
    trainable globals and the fixed parameters (the JAX package's
    ``AbstractHybridModel``). A subclass registers its networks, then calls
    :meth:`_add_scalars`, so that the networks' parameters come first in
    ``named_parameters``."""

    def __init__(self, forcing, targets, mechanistic_model, parameters, neural_param_names,
                 global_param_names, fixed_param_names, scale_nn_outputs, start_from_default,
                 config):
        super().__init__()
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

    def _add_scalars(self, generator) -> None:
        self.globals = _Scalars(self._init_globals(generator), trainable=True)
        self.fixed = _Scalars(
            {f: self.param_table.default_of(f) for f in self.fixed_param_names},
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

    def _scale_neural(self, name: str, col):
        """Neural parameter ``name``'s column, sigmoid-scaled into its bounds
        when ``scale_nn_outputs`` is on."""
        if self.scale_nn_outputs:
            p = self.param_table
            col = scale_param(col, p.lower_of(name), p.upper_of(name))
        return col

    def _mechanistic(self, nn_params, forcing) -> Dict[str, Any]:
        """The mechanistic outputs and ``"parameters"`` (neural, scaled
        globals, fixed)."""
        if forcing is not None and not isinstance(forcing, Mapping):
            raise TypeError(
                f"forcing must be a dict name->tensor; got {type(forcing).__name__}"
            )
        all_params = {**nn_params, **self._scale_globals(), **self.fixed.as_dict()}
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
        columns for every per-sample output (the targets, then the neural
        and scalar parameters). Missing values become NaN and no row is
        dropped."""
        from ..data.prepare import prepare_data

        data = prepare_data(self, df, drop_missing_rows=False)
        dev = self.device
        if isinstance(data.x, Mapping):
            x = {k: torch.tensor(v, device=dev) for k, v in data.x.items()}
        else:
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


class SingleNNHybridModel(_HybridModel):
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
        super().__init__(forcing, targets, mechanistic_model, parameters, neural_param_names,
                         global_param_names, fixed_param_names, scale_nn_outputs,
                         start_from_default, config)
        self.nn = nn
        self.predictors = predictors
        self._add_scalars(generator)

    def _split_nn_outputs(self, nn_out) -> Dict[str, torch.Tensor]:
        """Column i of the NN output is parameter ``neural_param_names[i]``,
        optionally sigmoid-scaled into its bounds."""
        return {name: self._scale_neural(name, nn_out[..., i])
                for i, name in enumerate(self.neural_param_names)}

    def forward(self, x, forcing: Optional[Mapping[str, Any]] = None):
        """Hybrid forward on ``x (N, F)`` and a forcing dict name → ``(N,)``,
        or, for a sequence network, on windows ``x (N, T, F)`` with forcing
        ``(N, T)``: the mechanistic model then runs at every time step.
        Returns ``{**mechanistic_outputs, "parameters": all_params}``."""
        if self.nn is not None and self.neural_param_names:
            nn_params = self._split_nn_outputs(self.nn(x))
        else:
            nn_params = {}
        return self._mechanistic(nn_params, forcing)


class MultiNNHybridModel(_HybridModel):
    """One single-output NN per neural parameter, each over its own
    predictors (the JAX package's ``MultiNNHybridModel``). The networks sit
    in ``nns``, a ``ModuleDict`` in the order of ``neural_param_names``:
    branch i gives parameter i. ``predictors`` is ``((branch, (pred, ...)),
    ...)`` and ``x`` a dict branch → ``(N, F_b)``."""

    def __init__(
        self,
        nns: Mapping[str, nn.Module],
        predictors: Tuple[Tuple[str, Tuple[str, ...]], ...],
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
        super().__init__(forcing, targets, mechanistic_model, parameters, neural_param_names,
                         global_param_names, fixed_param_names, scale_nn_outputs,
                         start_from_default, config)
        self.nns = nn.ModuleDict(nns)
        self.predictors = predictors
        self._add_scalars(generator)

    @property
    def predictor_dict(self) -> Dict[str, Tuple[str, ...]]:
        return dict(self.predictors)

    def forward(self, x: Mapping[str, Any], forcing: Optional[Mapping[str, Any]] = None):
        """Hybrid forward on ``x``, a dict branch → ``(N, F_b)`` (or ``(N,
        T, F_b)``). Returns ``{**mechanistic_outputs, "parameters":
        all_params, "nn_outputs": {branch: (N, 1)}}``."""
        if self.nns and not isinstance(x, Mapping):
            raise TypeError(f"x must be a dict branch->tensor; got {type(x).__name__}")
        nn_outputs = {name: net(x[name]) for name, net in self.nns.items()}
        nn_params = {pname: self._scale_neural(pname, nn_outputs[branch][..., 0])
                     for branch, pname in zip(self.nns, self.neural_param_names)}
        return {**self._mechanistic(nn_params, forcing), "nn_outputs": nn_outputs}


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
) -> Union[SingleNNHybridModel, MultiNNHybridModel]:
    """Build a hybrid model; dispatches on the type of ``predictors``.
    Weights are drawn from ``generator`` on the CPU, then the model moves to
    ``device``: the CUDA device when there is one and the caller names none
    (:func:`~easyhybrid_tpu_torch.utils.device.default_device`).

    * a list of names → :class:`SingleNNHybridModel`, one NN with
      ``len(neural_param_names)`` outputs;
    * a mapping ``{param_name: [predictor, ...]}`` →
      :class:`MultiNNHybridModel`, one single-output NN per entry; the keys
      become the neural parameter names (``neural_param_names`` is
      ignored). A mapping ``hidden_layers`` is taken per branch only when its
      keys hold every branch name, else it is one spec for every branch
      (``{"lstm": n}``); a mapping ``activation`` is per branch.
    """
    if mechanistic_model is None:
        raise ValueError("mechanistic_model is required")
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

    common = dict(
        forcing=_as_tuple(forcing),
        targets=_as_tuple(targets),
        mechanistic_model=mechanistic_model,
        parameters=parameters,
        global_param_names=global_param_names,
        scale_nn_outputs=scale_nn_outputs,
        start_from_default=start_from_default,
        config=config,
        generator=generator,
    )
    if isinstance(predictors, Mapping):
        neural_param_names = tuple(str(k) for k in predictors)
        for n in neural_param_names:
            if n not in all_names:
                raise ValueError(f"neural parameter {n!r} not in parameter table")
        per_branch_hl = isinstance(hidden_layers, Mapping) and set(predictors) <= set(
            hidden_layers)
        nets, preds_frozen = {}, []
        for name, preds in predictors.items():
            preds = _as_tuple(preds)
            preds_frozen.append((str(name), preds))
            nets[str(name)] = construct_nn(
                hidden_layers[name] if per_branch_hl else hidden_layers,
                len(preds),
                1,
                activation=activation[name] if isinstance(activation, Mapping) else activation,
                input_batchnorm=input_batchnorm,
                compute_dtype=compute_dtype,
                generator=generator,
            )
        model = MultiNNHybridModel(
            nns=nets,
            predictors=tuple(preds_frozen),
            neural_param_names=neural_param_names,
            fixed_param_names=_fixed_names(all_names, neural_param_names, global_param_names),
            **common,
        )
    else:
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
        model = SingleNNHybridModel(
            nn=net,
            predictors=predictors,
            neural_param_names=neural_param_names,
            fixed_param_names=_fixed_names(all_names, neural_param_names, global_param_names),
            **common,
        )
    return model.to(default_device() if device is None else device)


def _fixed_names(all_names, neural, globals_) -> Tuple[str, ...]:
    return tuple(n for n in all_names if n not in neural and n not in globals_)
