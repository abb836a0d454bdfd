"""Masked loss metrics on torch tensors.

PyTorch counterpart of ``easyhybrid_tpu/losses/metrics.py``. Every metric
is a masked reduction with static shapes: invalid entries (NaN targets,
padding rows) are zeroed by :func:`_sanitize` and carry a zero weight, so
they touch neither the value nor the gradient.

Custom metrics use the signature ``f(y_hat, y, mask, **kwargs)`` where
``mask`` is a float/bool tensor marking valid samples.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

__all__ = [
    "loss_fn",
    "is_better",
    "best_direction",
    "check_training_loss",
    "register_metric",
    "METRICS",
    "MAXIMIZE_METRICS",
    "masked_mean",
    "masked_sum",
    "masked_var",
    "masked_std",
    "masked_corr",
    "pinball",
    "huber",
]

Tensor = torch.Tensor
_EPS = 1e-12


def _sanitize(y_hat: Tensor, y: Tensor, mask) -> Tuple[Tensor, Tensor, Tensor]:
    """Zero out invalid entries with a ``where`` (NaN * 0 = NaN would leak);
    gradients through masked-out samples are exactly zero."""
    if mask is None:
        mask = torch.isfinite(y)
    m = mask.to(torch.float32)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    y_safe = torch.where(m > 0, y, zero)
    yh_safe = torch.where(m > 0, y_hat, zero.to(y_hat.dtype))
    return yh_safe, y_safe, m


def masked_sum(x: Tensor, m: Tensor) -> Tensor:
    return torch.sum(x * m)


def masked_mean(x: Tensor, m: Tensor) -> Tensor:
    return masked_sum(x, m) / torch.clamp_min(torch.sum(m), 1.0)


def masked_var(x: Tensor, m: Tensor, *, ddof: int = 1) -> Tensor:
    """Masked variance (Bessel-corrected by default, as Julia's ``std``)."""
    n = torch.clamp_min(torch.sum(m), 1.0)
    mu = masked_sum(x, m) / n
    d = x - mu
    ss = masked_sum(d * d, m)
    return ss / torch.clamp_min(n - ddof, 1.0)


def masked_std(x: Tensor, m: Tensor, *, ddof: int = 1) -> Tensor:
    return torch.sqrt(masked_var(x, m, ddof=ddof))


def masked_corr(a: Tensor, b: Tensor, m: Tensor) -> Tensor:
    """Masked Pearson correlation (Bessel factors cancel)."""
    n = torch.clamp_min(torch.sum(m), 1.0)
    mu_a = masked_sum(a, m) / n
    mu_b = masked_sum(b, m) / n
    da = (a - mu_a) * m
    db = (b - mu_b) * m
    cov = torch.sum(da * db)
    denom = torch.sqrt(torch.sum(da * da) * torch.sum(db * db))
    return cov / torch.clamp_min(denom, _EPS)


# --------------------------------------------------------------------------
# metric registry
# --------------------------------------------------------------------------

def _mse(yh, y, m):
    return masked_mean((yh - y) * (yh - y), m)


def _rmse(yh, y, m):
    return torch.sqrt(_mse(yh, y, m))


def _mae(yh, y, m):
    return masked_mean(torch.abs(yh - y), m)


def _pearson(yh, y, m):
    return masked_corr(yh, y, m)


def _sse_over_sst(yh, y, m):
    sse = masked_sum((yh - y) * (yh - y), m)
    mu = masked_mean(y, m)
    sst = masked_sum((y - mu) * (y - mu), m)
    return sse / torch.clamp_min(sst, _EPS)


def _r2(yh, y, m):
    return 1.0 - _sse_over_sst(yh, y, m)


def _pearson_loss(yh, y, m):
    return 1.0 - masked_corr(yh, y, m)


def _nse_loss(yh, y, m):
    return _sse_over_sst(yh, y, m)


def _nse(yh, y, m):
    return 1.0 - _sse_over_sst(yh, y, m)


def _alpha(yh, y, m):
    return masked_std(yh, m) / torch.clamp_min(masked_std(y, m), _EPS)


def _beta(yh, y, m):
    return masked_mean(yh, m) / masked_mean(y, m)


def _kge_loss(yh, y, m):
    r = masked_corr(yh, y, m)
    a = _alpha(yh, y, m)
    b = _beta(yh, y, m)
    return torch.sqrt((r - 1.0) * (r - 1.0) + (a - 1.0) * (a - 1.0) + (b - 1.0) * (b - 1.0))


def _kge(yh, y, m):
    return 1.0 - _kge_loss(yh, y, m)


def _pbkge_loss(yh, y, m):
    r = masked_corr(yh, y, m)
    b = _beta(yh, y, m)
    return torch.sqrt((r - 1.0) * (r - 1.0) + (b - 1.0) * (b - 1.0))


def _pbkge(yh, y, m):
    return 1.0 - _pbkge_loss(yh, y, m)


METRICS: Dict[str, Callable] = {
    "mse": _mse,
    "rmse": _rmse,
    "mae": _mae,
    "pearson": _pearson,
    "r2": _r2,
    "pearsonLoss": _pearson_loss,
    "nseLoss": _nse_loss,
    "nse": _nse,
    "kgeLoss": _kge_loss,
    "kge": _kge,
    "pbkgeLoss": _pbkge_loss,
    "pbkge": _pbkge,
    "alpha": _alpha,
    "beta": _beta,
    "α": _alpha,
    "β": _beta,
}

#: metrics whose best direction is "larger is better"; mutated in place by
#: register_metric so that from-imports of the set see custom metrics too
MAXIMIZE_METRICS = {"pearson", "r2", "nse", "kge", "pbkge"}


def register_metric(name: str, fn: Callable, *, maximize: bool = False) -> None:
    """Register a custom named metric ``fn(y_hat, y, mask) -> scalar``."""
    METRICS[name] = fn
    if maximize:
        MAXIMIZE_METRICS.add(name)


# --------------------------------------------------------------------------
# declarative elementwise losses
# --------------------------------------------------------------------------

def _pinball_elem(y_hat, y, tau):
    r = y_hat - y
    return tau * torch.clamp_min(r, 0.0) + (tau - 1.0) * torch.clamp_max(r, 0.0)


def _huber_elem(y_hat, y, delta):
    r = torch.abs(y_hat - y)
    quad = 0.5 * r * r
    lin = delta * (r - 0.5 * delta)
    return torch.where(r <= delta, quad, lin)


def pinball(tau: float = 0.5, *, normalize: str = "mean"):
    """Quantile (pinball) loss as an :class:`ElementwiseLoss`."""
    from .specs import ElementwiseLoss

    return ElementwiseLoss(
        _pinball_elem, args=(float(tau),), normalize=normalize,
        name=f"pinball(tau={tau})",
    )


def huber(delta: float = 1.0, *, normalize: str = "mean"):
    """Huber loss as an :class:`ElementwiseLoss` (quadratic below ``delta``,
    linear above)."""
    from .specs import ElementwiseLoss

    return ElementwiseLoss(
        _huber_elem, args=(float(delta),), normalize=normalize,
        name=f"huber(delta={delta})",
    )


LossType = Union[str, Callable, tuple]


def _split_extras(loss_type):
    args: tuple = ()
    kwargs: dict = {}
    for extra in loss_type[1:]:
        if isinstance(extra, dict):
            kwargs = dict(extra)
        elif isinstance(extra, tuple):
            args = extra
        else:
            raise TypeError(
                "custom loss tuple extras must be a tuple (args) or dict "
                f"(kwargs); got {type(extra).__name__}"
            )
    return loss_type[0], args, kwargs


def loss_fn(y_hat: Tensor, y, mask, loss_type: LossType):
    """Evaluate one metric on one target. ``loss_type`` is a registry name,
    a callable ``f(y_hat, y, mask, ...)``, or a tuple ``(f, args)``,
    ``(f, kwargs)``, ``(f, args, kwargs)``.

    ``y`` may be an ``(y_obs, sigma)`` tuple: sigma is forwarded to custom
    callables as ``sigma=``, with masked rows set to a neutral 1.0 so NaN
    sigmas there cannot poison the loss; named metrics reject it."""
    sigma = None
    if isinstance(y, tuple):
        y, sigma = y
        if isinstance(loss_type, str):
            raise ValueError(
                f"named metric {loss_type!r} does not support (y, sigma) "
                "targets; use a custom callable f(y_hat, y, mask, sigma=...)"
            )
    yh, ys, m = _sanitize(y_hat, y, mask)
    if sigma is not None:
        sigma = torch.where(m > 0, sigma, torch.ones_like(sigma))
        if callable(loss_type):
            return loss_type(yh, ys, m, sigma=sigma)
        if isinstance(loss_type, tuple):
            f, args, kwargs = _split_extras(loss_type)
            return f(yh, ys, m, *args, sigma=sigma, **kwargs)
        raise TypeError(f"unsupported loss spec for (y, sigma): {loss_type!r}")
    if isinstance(loss_type, str):
        if loss_type not in METRICS:
            raise ValueError(f"unknown loss type {loss_type!r}; known: {sorted(METRICS)}")
        return METRICS[loss_type](yh, ys, m)
    if callable(loss_type):
        return loss_type(yh, ys, m)
    if isinstance(loss_type, tuple):
        f, args, kwargs = _split_extras(loss_type)
        return f(yh, ys, m, *args, **kwargs)
    raise TypeError(f"unsupported loss spec: {loss_type!r}")


# --------------------------------------------------------------------------
# direction traits
# --------------------------------------------------------------------------

def best_direction(loss_type) -> str:
    """'min' or 'max': which direction is better for this metric. Loss-spec
    wrappers resolve through their display name."""
    if not isinstance(loss_type, str):
        from .specs import LossSpec, loss_name

        if isinstance(loss_type, LossSpec):
            loss_type = loss_name(loss_type)
    name = loss_type if isinstance(loss_type, str) else None
    return "max" if name in MAXIMIZE_METRICS else "min"


def is_better(new: float, best: float, loss_type) -> bool:
    if best_direction(loss_type) == "max":
        return new > best
    return new < best


def check_training_loss(loss_type) -> None:
    """Reject maximize-direction metrics as training losses."""
    if best_direction(loss_type) == "max":
        raise ValueError(
            f"Got a metric defined as `to be maximized` as a training loss: "
            f"{loss_type}. Use a true loss (to be minimized), e.g. 'nseLoss' "
            "(1-NSE), 'kgeLoss' (1-KGE), 'pearsonLoss' (1-Pearson), or 'mse'."
        )
