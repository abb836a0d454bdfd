"""Loss specification types and the LoggingLoss config.

PyTorch counterpart of ``easyhybrid_tpu/losses/specs.py``: the same spec
classes, names and aggregations; the reductions run on torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "LossSpec",
    "SymbolicLoss",
    "FunctionLoss",
    "ParameterizedLoss",
    "ElementwiseLoss",
    "ExtraLoss",
    "PerTarget",
    "LoggingLoss",
    "to_loss_spec",
    "loss_name",
    "agg_name",
    "AGGREGATIONS",
    "resolve_agg",
]


def _sum(xs):
    total = 0.0
    for x in xs:
        total = total + x
    return total


def _mean(xs):
    xs = list(xs)
    return _sum(xs) / len(xs)


AGGREGATIONS = {"sum": _sum, "mean": _mean}


def resolve_agg(agg: Union[str, Callable]) -> Callable:
    """Aggregation over the per-target loss list."""
    if callable(agg):
        return agg
    if agg in AGGREGATIONS:
        return AGGREGATIONS[agg]
    raise ValueError(f"unknown aggregation {agg!r}; known: {sorted(AGGREGATIONS)}")


def agg_name(agg: Union[str, Callable]) -> str:
    if isinstance(agg, str):
        return agg
    return getattr(agg, "__name__", "agg").lstrip("_")


class LossSpec:
    """Base class for normalized loss specifications."""


@dataclasses.dataclass(frozen=True)
class SymbolicLoss(LossSpec):
    """A registry metric referenced by name."""

    name: str

    def __call__(self, y_hat, y, mask):
        from .metrics import loss_fn

        return loss_fn(y_hat, y, mask, self.name)


@dataclasses.dataclass(frozen=True)
class FunctionLoss(LossSpec):
    """A bare callable ``f(y_hat, y, mask)``."""

    fn: Callable

    def __call__(self, y_hat, y, mask):
        from .metrics import loss_fn

        return loss_fn(y_hat, y, mask, self.fn)


@dataclasses.dataclass(frozen=True)
class ParameterizedLoss(LossSpec):
    """A callable with extra args/kwargs."""

    fn: Callable
    args: Tuple[Any, ...] = ()
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    def __call__(self, y_hat, y, mask):
        from .metrics import loss_fn

        return loss_fn(y_hat, y, mask, (self.fn, self.args, dict(self.kwargs)))


@dataclasses.dataclass(frozen=True)
class ElementwiseLoss(LossSpec):
    """A per-element loss ``ℓ(ŷᵢ, yᵢ)`` reduced by a masked mean (or sum):
    ``fn(y_hat, y, *args, **kwargs)`` maps same-shape tensors elementwise
    to per-element losses; the framework applies the mask and reduction."""

    fn: Callable
    args: Tuple[Any, ...] = ()
    kwargs: Tuple[Tuple[str, Any], ...] = ()
    normalize: str = "mean"  # "mean" (masked mean) or "sum" (masked sum)
    name: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.kwargs, dict):
            object.__setattr__(self, "kwargs", tuple(sorted(self.kwargs.items())))
        if self.normalize not in ("mean", "sum"):
            raise ValueError(
                f"ElementwiseLoss normalize must be 'mean' or 'sum', got {self.normalize!r}"
            )

    def elementwise(self, y_hat, y):
        """Per-element losses (no mask, no reduction)."""
        return self.fn(y_hat, y, *self.args, **dict(self.kwargs))

    def __call__(self, y_hat, y, mask):
        from .metrics import _sanitize, masked_sum

        if isinstance(y, tuple):
            raise ValueError(
                f"elementwise loss {self.name or self.fn!r} does not support "
                "(y, sigma) targets; use a custom callable f(y_hat, y, mask, sigma=...)"
            )
        yh, ys, m = _sanitize(y_hat, y, mask)
        s = masked_sum(self.elementwise(yh, ys), m)
        if self.normalize == "mean":
            return s / torch.clamp_min(torch.sum(m), 1.0)
        return s


@dataclasses.dataclass(frozen=True)
class ExtraLoss(LossSpec):
    """An additive penalty ``fn(outputs, params) -> scalar`` (or a dict of
    named scalars), e.g. weight decay."""

    fn: Callable

    def __call__(self, outputs, params):
        return self.fn(outputs, params)


@dataclasses.dataclass(frozen=True)
class PerTarget(LossSpec):
    """A different loss spec per target, positionally matched."""

    losses: Tuple[Any, ...]

    def __init__(self, losses: Sequence[Any]):
        object.__setattr__(self, "losses", tuple(to_loss_spec(l) for l in losses))


def to_loss_spec(spec) -> LossSpec:
    """Normalize a user spec (str / callable / tuple / LossSpec) to LossSpec."""
    if isinstance(spec, LossSpec):
        return spec
    if isinstance(spec, str):
        return SymbolicLoss(spec)
    if callable(spec):
        return FunctionLoss(spec)
    if isinstance(spec, tuple):
        f = spec[0]
        args: Tuple[Any, ...] = ()
        kwargs: Tuple[Tuple[str, Any], ...] = ()
        for extra in spec[1:]:
            if isinstance(extra, dict):
                kwargs = tuple(sorted(extra.items()))
            elif isinstance(extra, (tuple, list)):
                args = tuple(extra)
            else:
                raise TypeError(f"bad loss tuple extra: {extra!r}")
        return ParameterizedLoss(f, args, kwargs)
    raise TypeError(f"cannot normalize loss spec {spec!r}")


def loss_name(spec) -> str:
    """Display/history name for a loss spec."""
    if isinstance(spec, str):
        return spec
    if isinstance(spec, SymbolicLoss):
        return spec.name
    if isinstance(spec, FunctionLoss):
        return getattr(spec.fn, "__name__", "custom").replace("<", "").replace(">", "")
    if isinstance(spec, ElementwiseLoss):
        return spec.name or getattr(spec.fn, "__name__", "elementwise")
    if isinstance(spec, ParameterizedLoss):
        return getattr(spec.fn, "__name__", "custom")
    if isinstance(spec, PerTarget):
        return "per_target"
    if isinstance(spec, tuple):
        return loss_name(to_loss_spec(spec))
    if callable(spec):
        return getattr(spec, "__name__", "custom").replace("<", "").replace(">", "")
    return str(spec)


@dataclasses.dataclass(frozen=True)
class LoggingLoss:
    """Loss configuration carried through training and evaluation:
    ``loss_types`` are the metrics reported at eval, ``training_loss`` the
    scalar optimized, ``extra_loss`` an additive penalty, ``agg`` the
    aggregation of per-target losses into one scalar."""

    loss_types: Tuple[Any, ...] = ("mse", "r2")
    training_loss: Any = "mse"
    extra_loss: Optional[Any] = None
    agg: Union[str, Callable] = "sum"
    train_mode: bool = True

    def __post_init__(self):
        lt = self.loss_types
        if isinstance(lt, str) or callable(lt) or isinstance(lt, LossSpec):
            lt = (lt,)
        object.__setattr__(self, "loss_types", tuple(lt))

    @property
    def agg_fn(self) -> Callable:
        return resolve_agg(self.agg)

    @property
    def agg_name(self) -> str:
        return agg_name(self.agg)

    def __repr__(self):
        names = ", ".join(loss_name(l) for l in self.loss_types)
        extra = loss_name(self.extra_loss) if self.extra_loss is not None else "nothing"
        return (
            "LoggingLoss(\n"
            f"  loss_types    = [{names}]\n"
            f"  training_loss = {loss_name(self.training_loss)}\n"
            f"  extra_loss    = {extra}\n"
            f"  agg           = {self.agg_name}\n"
            f"  train_mode    = {self.train_mode}\n"
            ")"
        )
