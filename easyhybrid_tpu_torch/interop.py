"""Carry parameters between the JAX package and the port.

``load_jax_params(module, params, state)`` takes the JAX package's
``params`` / ``state`` pytrees as nested dicts (and lists) of numpy arrays
and writes them into a port module: a :class:`SingleNNHybridModel`, a
:class:`MultiNNHybridModel` (``params["nns"][branch]`` and
``state["nns"][branch]``, each a network's leaves), a
:class:`MultiSiteHybridModel` (``params["globals"][g]`` of shape ``(S, 1)``, and
with ``share_nn=False`` every network leaf with a leading site axis), an
:class:`MLP` or an :class:`LSTMNet`. Dense weights, and the LSTM's ``wi``
and ``wh``, are transposed from JAX's ``(in, out)`` to torch's ``(out, in)``. Any missing, extra or wrongly shaped leaf raises.
``export_jax_params(module)`` is its inverse. This module does not import
JAX: the caller converts the leaves with ``np.asarray``.

``load_jax_population(module, params, state)`` and
``export_jax_population(module, params, buffers)`` carry a population's
member axis across: the JAX package's stacked ``(K, …)`` trees (a
``PopulationResults``' ``params`` and ``state``, or ``jax.vmap`` of
``model.init``) against the port's ``{name: (K, …)}`` dicts keyed like
``module.named_parameters()`` and ``module.named_buffers()``, ``module``
giving the layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .models.hybrid import MultiNNHybridModel, SingleNNHybridModel
from .models.nn import MLP, LSTMNet
from .parallel.multisite import MultiSiteHybridModel, SiteNetworks

__all__ = ["load_jax_params", "export_jax_params", "jax_branch_of", "load_jax_population",
           "export_jax_population"]

# leaf path → (destination tensor, transform from the JAX array)
_LeafMap = Dict[str, Tuple[torch.Tensor, Callable[[np.ndarray], np.ndarray]]]


def _same(a):
    return a


def _swap_in_out(a):
    """Dense weights: JAX ``(…, in, out)``, torch ``(…, out, in)``; a leading
    site axis (per-site networks) stays in front."""
    return np.swapaxes(a, -1, -2)


def _mlp_leaves(mlp, prefix: str) -> Tuple[_LeafMap, _LeafMap]:
    params: _LeafMap = {}
    state: _LeafMap = {}
    for i, layer in enumerate(mlp.layers):  # an MLP's layers always have a bias
        params[f"{prefix}layers/{i}/w"] = (layer.weight, _swap_in_out)
        params[f"{prefix}layers/{i}/b"] = (layer.bias, _same)
    _norm_leaves(mlp.norm, prefix, params, state)
    return params, state


def _norm_leaves(norm, prefix: str, params: _LeafMap, state: _LeafMap) -> None:
    if norm is not None:  # a network's input norm is affine
        params[f"{prefix}norm/scale"] = (norm.scale, _same)
        params[f"{prefix}norm/bias"] = (norm.bias, _same)
        state[f"{prefix}norm/mean"] = (norm.mean, _same)
        state[f"{prefix}norm/var"] = (norm.var, _same)


def _lstm_leaves(net, prefix: str) -> Tuple[_LeafMap, _LeafMap]:
    params: _LeafMap = {
        f"{prefix}wi": (net.wi, _swap_in_out),
        f"{prefix}wh": (net.wh, _swap_in_out),
        f"{prefix}b": (net.b, _same),
        f"{prefix}head/w": (net.head.weight, _swap_in_out),
        f"{prefix}head/b": (net.head.bias, _same),
    }
    state: _LeafMap = {}
    _norm_leaves(net.norm, prefix, params, state)
    return params, state


def _network_leaves(net, prefix: str) -> Tuple[_LeafMap, _LeafMap]:
    if isinstance(net, LSTMNet):
        return _lstm_leaves(net, prefix)
    return _mlp_leaves(net, prefix)


def _scalar_leaves(module, params: _LeafMap, state: _LeafMap) -> None:
    for name, t in module.globals.as_dict().items():
        params[f"globals/{name}"] = (t, _same)
    for name, t in module.fixed.as_dict().items():
        state[f"fixed/{name}"] = (t, _same)


def _leaf_maps(module) -> Tuple[_LeafMap, _LeafMap]:
    if isinstance(module, (MLP, LSTMNet)):
        return _network_leaves(module, "")
    if isinstance(module, MultiNNHybridModel):
        params: _LeafMap = {}
        state: _LeafMap = {}
        for branch, net in module.nns.items():
            if not isinstance(net, (MLP, LSTMNet)):
                raise TypeError(f"cannot carry JAX parameters into {type(net).__name__}")
            p, s = _network_leaves(net, f"nns/{branch}/")
            params.update(p)
            state.update(s)
        _scalar_leaves(module, params, state)
        return params, state
    if isinstance(module, (SingleNNHybridModel, MultiSiteHybridModel)):
        params: _LeafMap = {}
        state: _LeafMap = {}
        if module.nn is not None:
            if not isinstance(module.nn, (MLP, LSTMNet, SiteNetworks)):
                raise TypeError(
                    f"cannot carry JAX parameters into {type(module.nn).__name__}"
                )
            params, state = _network_leaves(module.nn, "nn/")
        _scalar_leaves(module, params, state)
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


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/0/c": leaf}`` → nested dicts, with all-digit keys as lists."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(tree)


def export_jax_params(module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`load_jax_params`: ``(params, state)`` of a port
    module as nested dicts and lists of numpy arrays in the JAX package's
    layout (Dense weights ``(in, out)``). A model with a network but no
    norm gets the ``{"nn": {}}`` state entry the JAX model has, and a
    MultiNN model ``{"nns": {branch: {}}}`` for each branch without one."""
    want_params, want_state = _leaf_maps(module)
    out = []
    for want in (want_params, want_state):
        flat = {
            path: np.array(transform(t.detach().cpu().numpy()), np.float32)
            for path, (t, transform) in want.items()
        }
        out.append(_nest(flat))
    params, state = out
    if isinstance(module, (SingleNNHybridModel, MultiSiteHybridModel)) and module.nn is not None:
        state.setdefault("nn", {})
    if isinstance(module, MultiNNHybridModel):
        branches = state.setdefault("nns", {})
        for branch in module.nns:
            branches.setdefault(branch, {})
    return params, state


def jax_branch_of(module) -> Dict[str, str]:
    """``parameter name -> top-level key of the JAX parameter tree`` (``nn``,
    ``nns``, ``globals``) for each of ``module.named_parameters()``; a
    module the JAX layout does not cover keys by its names' first part."""
    try:
        want, _ = _leaf_maps(module)
    except TypeError:
        want = {}
    top = {id(t): path.split("/")[0] for path, (t, _) in want.items()}
    return {name: top.get(id(p), name.split(".")[0]) for name, p in module.named_parameters()}


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


def _named(module) -> Dict[int, Tuple[str, str]]:
    """``id(tensor) -> ("params" or "state", name)`` for every parameter and buffer."""
    out = {id(t): ("params", n) for n, t in module.named_parameters()}
    out.update({id(t): ("state", n) for n, t in module.named_buffers()})
    return out


def load_jax_population(module, params, state) -> Tuple[Dict[str, torch.Tensor],
                                                         Dict[str, torch.Tensor]]:
    """The JAX package's stacked ``(K, …)`` ``params`` / ``state`` trees as
    the port's ``({parameter name: (K, …)}, {buffer name: (K, …)})`` CPU
    float32 tensors, in ``module``'s layout (weights transposed as
    :func:`load_jax_params` does). A buffer the JAX state does not hold
    (none for the hybrid models) keeps ``module``'s value on every member."""
    want_params, want_state = _leaf_maps(module)
    named = _named(module)
    out: Dict[str, Dict[str, torch.Tensor]] = {"params": {}, "state": {}}
    k = None
    for kind, want, tree in (("params", want_params, params), ("state", want_state, state)):
        got = _flatten(tree)
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise ValueError(f"JAX {kind} do not match the module: missing {missing}, extra {extra}")
        for path, (dest, transform) in want.items():
            value = np.array(transform(got[path]), np.float32)
            if k is None:
                k = value.shape[0]
            if tuple(value.shape) != (k,) + tuple(dest.shape):
                raise ValueError(f"JAX {kind} leaf {path!r} has shape {tuple(got[path].shape)}; a "
                                 f"population of {k} expects {(k,) + tuple(dest.shape)} (after the "
                                 "layout transform)")
            out[named[id(dest)][0]][named[id(dest)][1]] = torch.from_numpy(value)
    for name, b in module.named_buffers():
        if name not in out["state"]:
            out["state"][name] = b.detach().cpu().float().expand((k,) + tuple(b.shape)).clone()
    return out["params"], out["state"]


def export_jax_population(module, params: Dict[str, torch.Tensor],
                          buffers: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`load_jax_population`: stacked ``(K, …)`` port
    dicts as the JAX package's ``(params, state)`` trees of numpy arrays."""
    want_params, want_state = _leaf_maps(module)
    named = _named(module)
    source = {"params": params, "state": buffers}
    out = []
    for want in (want_params, want_state):
        flat = {}
        for path, (t, transform) in want.items():
            kind, name = named[id(t)]
            flat[path] = np.array(transform(source[kind][name].detach().cpu().numpy()), np.float32)
        out.append(_nest(flat))
    tree_params, tree_state = out
    if isinstance(module, (SingleNNHybridModel, MultiSiteHybridModel)) and module.nn is not None:
        tree_state.setdefault("nn", {})
    if isinstance(module, MultiNNHybridModel):
        branches = tree_state.setdefault("nns", {})
        for branch in module.nns:
            branches.setdefault(branch, {})
    return tree_params, tree_state
