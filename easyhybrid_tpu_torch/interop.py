"""Carry parameters from the JAX package into the port.

``load_jax_params(module, params, state)`` takes the JAX package's
``params`` / ``state`` pytrees as nested dicts (and lists) of numpy arrays
and writes them into a port module: a :class:`SingleNNHybridModel` or an
:class:`MLP`. Dense weights are transposed from JAX's ``(in, out)`` to
torch's ``(out, in)``. Any missing, extra or wrongly shaped leaf raises.
This module does not import JAX: the caller converts the leaves with
``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .models.hybrid import SingleNNHybridModel
from .models.nn import MLP

__all__ = ["load_jax_params"]

# leaf path → (destination tensor, transform from the JAX array)
_LeafMap = Dict[str, Tuple[torch.Tensor, Callable[[np.ndarray], np.ndarray]]]


def _same(a):
    return a


def _mlp_leaves(mlp: MLP, prefix: str) -> Tuple[_LeafMap, _LeafMap]:
    params: _LeafMap = {}
    state: _LeafMap = {}
    for i, layer in enumerate(mlp.layers):  # an MLP's layers always have a bias
        params[f"{prefix}layers/{i}/w"] = (layer.weight, np.transpose)
        params[f"{prefix}layers/{i}/b"] = (layer.bias, _same)
    if mlp.norm is not None:  # and its norm is affine
        params[f"{prefix}norm/scale"] = (mlp.norm.scale, _same)
        params[f"{prefix}norm/bias"] = (mlp.norm.bias, _same)
        state[f"{prefix}norm/mean"] = (mlp.norm.mean, _same)
        state[f"{prefix}norm/var"] = (mlp.norm.var, _same)
    return params, state


def _leaf_maps(module) -> Tuple[_LeafMap, _LeafMap]:
    if isinstance(module, MLP):
        return _mlp_leaves(module, "")
    if isinstance(module, SingleNNHybridModel):
        params: _LeafMap = {}
        state: _LeafMap = {}
        if module.nn is not None:
            if not isinstance(module.nn, MLP):
                raise TypeError(
                    f"cannot carry JAX parameters into {type(module.nn).__name__}"
                )
            params, state = _mlp_leaves(module.nn, "nn/")
        for name, t in module.globals.as_dict().items():
            params[f"globals/{name}"] = (t, _same)
        for name, t in module.fixed.as_dict().items():
            state[f"fixed/{name}"] = (t, _same)
        return params, state
    raise TypeError(f"load_jax_params: unsupported module {type(module).__name__}")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def load_jax_params(module, params, state) -> None:
    """Write the JAX ``params`` / ``state`` pytrees into ``module`` in place."""
    want_params, want_state = _leaf_maps(module)
    for kind, want, tree in (
        ("params", want_params, params),
        ("state", want_state, state),
    ):
        got = _flatten(tree)
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise ValueError(
                f"JAX {kind} do not match the module: missing {missing}, "
                f"extra {extra}"
            )
        for path, (dest, transform) in want.items():
            value = np.array(transform(got[path]), np.float32)  # a writable copy
            if tuple(value.shape) != tuple(dest.shape):
                raise ValueError(
                    f"JAX {kind} leaf {path!r} has shape "
                    f"{tuple(got[path].shape)}; the module expects "
                    f"{tuple(dest.shape)} (after the layout transform)"
                )
            with torch.no_grad():
                dest.copy_(torch.from_numpy(value))
