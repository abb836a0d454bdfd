"""Weight extraction and L2 regularization over a model's parameters.

PyTorch counterpart of ``easyhybrid_tpu/utils/weights.py``. Parameters come
as a module or a mapping ``name -> tensor`` (``dict(model.named_parameters())``,
what ``compute_loss`` hands an ``extra_loss``). The JAX key ``"w"`` (the
Dense weight matrices) names the parameters whose last path component is
``weight``; any other key matches that last component literally.
"""

from __future__ import annotations

from typing import Any, List

import torch

__all__ = ["extract_weights", "weight_l2", "l2_extra_loss"]

_KEY_ALIASES = {"w": "weight"}


def extract_weights(params: Any, key: str = "w") -> List[torch.Tensor]:
    """All parameters stored under ``key`` (default the Dense weight
    matrices), in registration order."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    leaf = _KEY_ALIASES.get(key, key)
    return [t for name, t in params.items() if name.rsplit(".", 1)[-1] == leaf]


def weight_l2(params: Any, *, normalize: bool = True, key: str = "w"):
    """Sum of squares over all weight leaves; ``normalize`` divides by the
    total number of weight entries."""
    weights = extract_weights(params, key)
    if not weights:
        return torch.tensor(0.0)
    total = sum(torch.sum(w.to(torch.float32) ** 2) for w in weights)
    if normalize:
        total = total / sum(w.numel() for w in weights)
    return total


def l2_extra_loss(scale: float = 1.0, *, normalize: bool = True, key: str = "w"):
    """An ``extra_loss`` callable ``(outputs, params) -> scalar`` adding
    ``scale · weight_l2(params)``; it carries its spec as ``_l2_spec``."""

    def extra(outputs, params):
        return scale * weight_l2(params, normalize=normalize, key=key)

    extra.__name__ = "weight_l2"
    extra._l2_spec = {"scale": float(scale), "normalize": bool(normalize), "key": key}
    return extra
