"""Bounded physical-parameter tables and bound transforms, on torch tensors.

PyTorch counterpart of ``easyhybrid_tpu/params.py``. The table
(:class:`ParameterContainer`) is the same host-side numpy structure; the
transforms accept torch tensors and Python floats. A Python float stays a
Python float (``math``), so seeding a parameter from its table default runs
no tensor op.

Bounds enter the transforms as Python floats, so ``upper - lower`` is taken
in double precision and rounded once to the tensor's dtype, exactly as the
JAX package's weak-typed constants are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "ParameterContainer",
    "build_parameters",
    "scale_param",
    "unscale_param",
    "hard_sigmoid",
    "inv_hard_sigmoid",
    "inv_sigmoid",
    "sigmoid",
]

ParamSpec = Union[
    Tuple[float, float, float],            # (default, lower, upper)
    Mapping[str, float],                   # {"default": d, "lower": l, "upper": u}
    float,                                 # default only → unbounded-ish wide box
]


def _is_scalar(x) -> bool:
    return isinstance(x, (float, int))


def sigmoid(x):
    """Logistic sigmoid ``1 / (1 + exp(-x))``."""
    if _is_scalar(x):
        if x >= 0:
            return 1.0 / (1.0 + math.exp(-x))
        e = math.exp(x)
        return e / (1.0 + e)
    return torch.sigmoid(x)


def hard_sigmoid(x):
    """Piecewise-linear sigmoid ``clamp(0.2x + 0.5, 0, 1)``."""
    if _is_scalar(x):
        return min(max(0.2 * x + 0.5, 0.0), 1.0)
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def inv_hard_sigmoid(y):
    """Inverse of :func:`hard_sigmoid` on the linear region (0, 1).
    Saturated inputs extrapolate linearly."""
    return (y - 0.5) / 0.2


def inv_sigmoid(y):
    """Logit: inverse of the logistic sigmoid.

    A Python scalar at or outside the bounds maps to ±inf / nan as the
    tensor ``log`` would, instead of raising a math-domain error, so a
    parameter whose default equals a bound initialises pinned."""
    if _is_scalar(y):
        if y <= 0.0:
            return -math.inf if y == 0.0 else math.nan
        if y >= 1.0:
            return math.inf if y == 1.0 else math.nan
        return math.log(y / (1.0 - y))
    return torch.log(y / (1.0 - y))


@dataclasses.dataclass(frozen=True)
class ParameterContainer:
    """Bounded parameter table ``name -> (default, lower, upper)``.

    Static model metadata held as host-side float32 numpy arrays; the same
    structure as the JAX package's container.
    """

    names: Tuple[str, ...]
    default: np.ndarray  # float32 (P,)
    lower: np.ndarray    # float32 (P,)
    upper: np.ndarray    # float32 (P,)

    def __post_init__(self):
        object.__setattr__(self, "default", np.asarray(self.default, np.float32))
        object.__setattr__(self, "lower", np.asarray(self.lower, np.float32))
        object.__setattr__(self, "upper", np.asarray(self.upper, np.float32))
        p = len(self.names)
        for field in ("default", "lower", "upper"):
            arr = getattr(self, field)
            if arr.shape != (p,):
                raise ValueError(
                    f"{field} must have shape ({p},); got {arr.shape}"
                )
        if np.any(self.lower >= self.upper):
            bad = [
                self.names[i]
                for i in range(p)
                if self.lower[i] >= self.upper[i]
            ]
            raise ValueError(f"lower >= upper for parameters {bad}")
        if np.any(self.default < self.lower) or np.any(self.default > self.upper):
            bad = [
                self.names[i]
                for i in range(p)
                if not (self.lower[i] <= self.default[i] <= self.upper[i])
            ]
            raise ValueError(f"default outside [lower, upper] for {bad}")

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_dict(table: Mapping[str, ParamSpec]) -> "ParameterContainer":
        names, d, lo, up = [], [], [], []
        for name, spec in table.items():
            names.append(str(name))
            if isinstance(spec, Mapping):
                dv = float(spec["default"])
                lv = float(spec.get("lower", dv - abs(dv) * 10 - 10))
                uv = float(spec.get("upper", dv + abs(dv) * 10 + 10))
            elif isinstance(spec, (tuple, list)):
                if len(spec) != 3:
                    raise ValueError(
                        f"parameter {name!r}: expected (default, lower, upper); got {spec!r}"
                    )
                dv, lv, uv = (float(v) for v in spec)
            else:
                dv = float(spec)
                lv, uv = dv - abs(dv) * 10 - 10, dv + abs(dv) * 10 + 10
            d.append(dv)
            lo.append(lv)
            up.append(uv)
        return ParameterContainer(tuple(names), np.array(d), np.array(lo), np.array(up))

    # -- accessors ---------------------------------------------------------
    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown parameter {name!r}; known: {list(self.names)}"
            ) from None

    def default_of(self, name: str) -> float:
        return float(self.default[self.index(name)])

    def lower_of(self, name: str) -> float:
        return float(self.lower[self.index(name)])

    def upper_of(self, name: str) -> float:
        return float(self.upper[self.index(name)])

    def bounds_of(self, names: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        idx = [self.index(n) for n in names]
        return self.lower[idx], self.upper[idx]

    def subset(self, names: Iterable[str]) -> "ParameterContainer":
        names = tuple(names)
        idx = [self.index(n) for n in names]
        return ParameterContainer(
            names, self.default[idx], self.lower[idx], self.upper[idx]
        )

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            n: {
                "default": float(self.default[i]),
                "lower": float(self.lower[i]),
                "upper": float(self.upper[i]),
            }
            for i, n in enumerate(self.names)
        }

    def __hash__(self):
        return hash(
            (
                self.names,
                self.default.tobytes(),
                self.lower.tobytes(),
                self.upper.tobytes(),
            )
        )

    def __eq__(self, other):
        return (
            isinstance(other, ParameterContainer)
            and self.names == other.names
            and np.array_equal(self.default, other.default)
            and np.array_equal(self.lower, other.lower)
            and np.array_equal(self.upper, other.upper)
        )

    def __len__(self):
        return len(self.names)

    def __contains__(self, name):
        return name in self.names

    def __repr__(self):
        rows = "\n".join(
            f"  {n:<16} default={self.default[i]:<10.4g} "
            f"lower={self.lower[i]:<10.4g} upper={self.upper[i]:<10.4g}"
            for i, n in enumerate(self.names)
        )
        return f"ParameterContainer({len(self)} parameters)\n{rows}"


def build_parameters(
    table: Union[ParameterContainer, Mapping[str, ParamSpec]],
    mechanistic_model=None,
) -> ParameterContainer:
    """Normalize a user parameter spec into a :class:`ParameterContainer`.
    ``mechanistic_model`` is accepted and ignored: the association lives on
    the model."""
    if isinstance(table, ParameterContainer):
        return table
    return ParameterContainer.from_dict(table)


# -- bound transforms ------------------------------------------------------

def scale_param(raw, lower, upper, kind: str = "sigmoid"):
    """Map unconstrained ``raw`` into the physical box ``[lower, upper]``:
    ``lower + (upper - lower) * sigmoid(raw)``; ``kind='hard_sigmoid'`` uses
    the piecewise-linear variant."""
    s = hard_sigmoid(raw) if kind == "hard_sigmoid" else sigmoid(raw)
    return lower + (upper - lower) * s


def unscale_param(value, lower, upper, kind: str = "sigmoid"):
    """Inverse of :func:`scale_param`: physical value → unconstrained raw."""
    frac = (value - lower) / (upper - lower)
    if kind == "hard_sigmoid":
        return inv_hard_sigmoid(frac)
    return inv_sigmoid(frac)
