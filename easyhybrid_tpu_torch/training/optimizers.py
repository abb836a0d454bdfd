"""First-order optimizers that copy optax's update formulas, on torch tensors.

PyTorch counterpart of ``easyhybrid_tpu/training/optimizers.py``.
``torch.optim`` orders its arithmetic differently from optax (and differs in
defaults: adagrad's initial accumulator, where eps sits), so the port does
not use it: each rule below is optax's formula, written per tensor. The
hyperparameter defaults and positional orders are those of the JAX
package's fused kernel (``_OPT_DEFAULTS`` / ``_OPT_POSITIONAL`` in
``easyhybrid_tpu/ops/fused_epoch.py``), which equal the optax constructors'.

``resolve_optimizer(spec)`` takes a name, ``(name, lr, ...)`` or ``(name,
{hyperparameters})`` and returns an :class:`Optimizer` with the optax
protocol: ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``, where ``params`` / ``grads`` / ``updates`` are dicts
``name -> tensor`` and ``new_param = param + update``.

Not ported yet: ``noisy_sgd`` (its optax noise stream), per-branch dict
specs, and the second-order solvers (L-BFGS, zoom linesearch); each raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

__all__ = [
    "OPTIMIZERS",
    "Optimizer",
    "apply_updates",
    "parse_opt_spec",
    "resolve_optimizer",
]

OPT_DEFAULTS: Dict[str, Dict[str, float]] = {
    "adam": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8),
    "adamw": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4),
    "sgd": dict(learning_rate=0.01, momentum=0.0, nesterov=0.0),
    "rmsprop": dict(learning_rate=0.01, decay=0.9, eps=1e-8),
    "adagrad": dict(learning_rate=0.01, initial_accumulator_value=0.1, eps=1e-7),
    "lion": dict(learning_rate=0.01, b1=0.9, b2=0.99, weight_decay=1e-3),
    "adamax": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8),
    "nadam": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
    "adadelta": dict(learning_rate=0.01, rho=0.9, eps=1e-6, weight_decay=0.0),
    "radam": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                  threshold=5.0),
    "amsgrad": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
    "lamb": dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0),
}
OPTIMIZERS = tuple(OPT_DEFAULTS)

_POSITIONAL: Dict[str, Tuple[str, ...]] = {
    "adam": ("learning_rate", "b1", "b2", "eps"),
    "adamw": ("learning_rate", "b1", "b2", "eps"),
    "sgd": ("learning_rate", "momentum", "nesterov"),
    "rmsprop": ("learning_rate", "decay", "eps"),
    "adagrad": ("learning_rate", "initial_accumulator_value", "eps"),
    "lion": ("learning_rate", "b1", "b2"),
    "adamax": ("learning_rate", "b1", "b2", "eps"),
    "nadam": ("learning_rate", "b1", "b2", "eps"),
    "adadelta": ("learning_rate", "rho", "eps"),
    "amsgrad": ("learning_rate", "b1", "b2", "eps"),
    "radam": ("learning_rate", "b1", "b2", "eps"),
    "lamb": ("learning_rate", "b1", "b2", "eps"),
}

# optimizer state slots per rule, besides the step count
_SLOTS: Dict[str, Tuple[str, ...]] = {
    "adam": ("mu", "nu"), "adamw": ("mu", "nu"), "nadam": ("mu", "nu"),
    "radam": ("mu", "nu"), "lamb": ("mu", "nu"), "adamax": ("mu", "nu"),
    "amsgrad": ("mu", "nu", "nu_max"), "sgd": ("trace",), "rmsprop": ("nu",),
    "adagrad": ("sum_of_squares",), "lion": ("mu",), "adadelta": ("e_g", "e_x"),
}

_SECOND_ORDER = ("lbfgs", "l-bfgs", "gd_linesearch", "gradient_descent")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to easyhybrid_tpu_torch yet (ROADMAP.md, queue A, {item})"
    )


def parse_opt_spec(spec) -> Tuple[str, Dict[str, float]]:
    """``(name, hyperparameters)`` of a single-rule spec; raises for specs the
    port does not implement."""
    if isinstance(spec, Mapping):
        raise _not_ported("a per-branch optimizer dict", "item 6")
    if isinstance(spec, str):
        name, rest = spec.lower(), ()
    elif isinstance(spec, tuple) and spec and isinstance(spec[0], str):
        name, rest = spec[0].lower(), spec[1:]
    else:
        raise TypeError(f"cannot resolve optimizer spec {spec!r}")
    if name in _SECOND_ORDER:
        raise _not_ported(f"the second-order solver {name!r}", "item 12")
    if name == "noisy_sgd":
        raise _not_ported("noisy_sgd (its optax noise stream)", "item 6")
    if name not in OPT_DEFAULTS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(OPT_DEFAULTS)}")
    hyper = dict(OPT_DEFAULTS[name])
    if len(rest) == 1 and isinstance(rest[0], Mapping):
        kw = dict(rest[0])
        unknown = set(kw) - set(hyper)
        if unknown:
            raise _not_ported(f"{name} options {sorted(unknown)}", "item 6")
        hyper.update({k: float(v) for k, v in kw.items()})
    else:
        names = _POSITIONAL[name]
        if len(rest) > len(names):
            raise _not_ported(f"{name} with {len(rest)} positional arguments", "item 6")
        hyper.update({k: float(v) for k, v in zip(names, rest)})
    return name, hyper


def _zeros(t):
    return torch.zeros_like(t)


def _leaf_update(name: str, h: Dict[str, float], g, p, s: Dict[str, Any], t):
    """One rule on one tensor: returns ``(update, new_slots)`` with ``update``
    the additive change of the parameter (the learning rate applied).
    ``t`` is the incremented step count as a float32 tensor."""
    lr = h["learning_rate"]
    if name == "sgd":
        mom = h["momentum"]
        if mom == 0.0:
            return -lr * g, s
        tr = g + mom * s["trace"]  # optax.trace
        upd = g + mom * tr if h["nesterov"] else tr
        return -lr * upd, {"trace": tr}
    if name == "rmsprop":
        nu = (1.0 - h["decay"]) * (g * g) + h["decay"] * s["nu"]
        return -lr * (g * torch.rsqrt(nu + h["eps"])), {"nu": nu}
    if name == "adagrad":
        sos = g * g + s["sum_of_squares"]
        inv = torch.where(sos > 0, torch.rsqrt(sos + h["eps"]), torch.zeros_like(sos))
        return -lr * (inv * g), {"sum_of_squares": sos}
    if name == "lion":
        upd = torch.sign((1.0 - h["b1"]) * g + h["b1"] * s["mu"]) + h["weight_decay"] * p
        mu = (1.0 - h["b2"]) * g + h["b2"] * s["mu"]
        return -lr * upd, {"mu": mu}
    if name == "adadelta":
        rho, eps = h["rho"], h["eps"]
        ge = g + h["weight_decay"] * p
        e_g = (1.0 - rho) * (ge * ge) + rho * s["e_g"]
        upd = (torch.sqrt(s["e_x"] + eps) / torch.sqrt(e_g + eps)) * ge
        e_x = (1.0 - rho) * (upd * upd) + rho * s["e_x"]
        return -lr * upd, {"e_g": e_g, "e_x": e_x}

    b1, b2 = h["b1"], h["b2"]
    mu = (1.0 - b1) * g + b1 * s["mu"]
    if name == "adamax":
        nu = torch.maximum(torch.abs(g) + h["eps"], b2 * s["nu"])
        upd = (mu / (1.0 - torch.pow(b1, t))) / nu
        return -lr * upd, {"mu": mu, "nu": nu}
    nu = (1.0 - b2) * (g * g) + b2 * s["nu"]
    eps, eps_root = h["eps"], h.get("eps_root", 0.0)
    nu_hat = nu / (1.0 - torch.pow(b2, t))
    if name == "nadam":
        mu_hat = b1 * (mu / (1.0 - torch.pow(b1, t + 1.0))) + (1.0 - b1) * (
            g / (1.0 - torch.pow(b1, t)))
    else:
        mu_hat = mu / (1.0 - torch.pow(b1, t))
    slots = {"mu": mu, "nu": nu}
    if name == "amsgrad":
        nu_max = torch.maximum(s["nu_max"], nu_hat)
        slots["nu_max"] = nu_max
        return -lr * (mu_hat / (torch.sqrt(nu_max + eps_root) + eps)), slots
    if name == "radam":
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(b2, t)
        ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        rect = r * mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
        return -lr * torch.where(ro >= h["threshold"], rect, mu_hat), slots
    upd = mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
    if name in ("adamw", "lamb"):
        upd = upd + h["weight_decay"] * p
    if name == "lamb":  # optax.scale_by_trust_ratio with min_norm 0
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(upd)
        ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
        upd = upd * ratio
    return -lr * upd, slots


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """One optax rule over a dict of tensors."""

    name: str
    hyper: Tuple[Tuple[str, float], ...]

    @property
    def hyperparameters(self) -> Dict[str, float]:
        return dict(self.hyper)

    @property
    def learning_rate(self) -> float:
        return self.hyperparameters["learning_rate"]

    @property
    def slots(self) -> Tuple[str, ...]:
        """The state slots besides the count (plain sgd keeps none)."""
        if self.name == "sgd" and self.hyperparameters["momentum"] == 0.0:
            return ()
        return _SLOTS[self.name]

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        first = next(iter(params.values()), None)
        device = first.device if first is not None else None
        state: Dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        for slot in self.slots:
            if slot == "sum_of_squares":
                c = self.hyperparameters["initial_accumulator_value"]
                state[slot] = {k: torch.full_like(v, c) for k, v in params.items()}
            else:
                state[slot] = {k: _zeros(v) for k, v in params.items()}
        return state

    def update(self, grads, state, params):
        """``(updates, new_state)`` for gradients ``grads``."""
        h = self.hyperparameters
        count = state["count"] + 1
        t = count.to(torch.float32)
        slots = self.slots
        updates: Dict[str, torch.Tensor] = {}
        new_state: Dict[str, Any] = {"count": count, **{s: {} for s in slots}}
        for k, g in grads.items():
            upd, new = _leaf_update(
                self.name, h, g, params[k], {s: state[s][k] for s in slots}, t
            )
            updates[k] = upd
            for s in slots:
                new_state[s][k] = new[s]
        return updates, new_state


def apply_updates(params, updates):
    """``params + updates``, leaf by leaf (new tensors)."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def resolve_optimizer(spec, params: Optional[Any] = None) -> Optimizer:
    """Resolve an optimizer spec (see the module docstring)."""
    del params  # per-branch label trees are not ported yet
    if isinstance(spec, Optimizer):
        return spec
    name, hyper = parse_opt_spec(spec)
    return Optimizer(name, tuple(sorted(hyper.items())))
