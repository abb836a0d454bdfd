"""Custom hybrid-model factory: the ``@hybrid`` macro analog.

PyTorch counterpart of ``easyhybrid_tpu/models/factory.py``.
:func:`make_hybrid` builds a small ``nn.Module`` holding raw trainable
physical scalars and, with predictors, an MLP; the forward pass is the
user's own ``forward(nn_out, forcing, params)``. It has no kernel form, so
``train`` runs it on the torch engine, as the JAX package does.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.device import default_device
from .nn import construct_nn

__all__ = ["make_hybrid", "CustomHybridModel"]


class CustomHybridModel(nn.Module):
    """A hybrid model with a user-defined forward and raw scalar parameters.

    ``forward(nn_out, forcing, params) -> dict`` where ``nn_out`` is the
    ``(N, out_dim)`` NN output (None without predictors), ``forcing`` the
    name → tensor dict and ``params`` the name → ``(1,)`` dict of the
    trainable physical scalars (``phys``, parameters in the order given)."""

    def __init__(
        self,
        name: str,
        predictors: Tuple[str, ...],
        forcing: Tuple[str, ...],
        targets: Tuple[str, ...],
        param_inits: Tuple[Tuple[str, float], ...],
        forward: Callable,
        nn: Any = None,
        nn_out_dim: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.name = name
        self.predictors = predictors
        self.forcing = forcing
        self.targets = targets
        self.param_inits = param_inits
        self.user_forward = forward
        self.nn_out_dim = nn_out_dim
        self.nn = None
        if predictors:
            self.nn = construct_nn(nn if nn is not None else [15, 15], len(predictors),
                                   nn_out_dim, generator=generator)
        self.phys = torch.nn.ParameterDict({
            pname: torch.nn.Parameter(torch.full((1,), float(val), dtype=torch.float32))
            for pname, val in param_inits
        })

    @property
    def device(self) -> torch.device:
        for t in itertools.chain(self.parameters(), self.buffers()):
            return t.device
        return torch.device("cpu")

    def forward(self, x, forcing: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        nn_out = self.nn(x) if self.nn is not None else None
        out = self.user_forward(nn_out, dict(forcing or {}), dict(self.phys.items()))
        if not isinstance(out, Mapping):
            raise TypeError(f"{self.name}.forward must return a dict of named outputs")
        return dict(out)


def make_hybrid(
    name: str,
    predictors: Sequence[str],
    forcing: Sequence[str],
    targets: Sequence[str],
    params: Mapping[str, float],
    forward: Callable,
    *,
    nn: Any = None,
    nn_out_dim: int = 1,
    generator: Optional[torch.Generator] = None,
    device: Any = None,
) -> CustomHybridModel:
    """Build a custom hybrid model (``@hybrid`` parity), on ``device`` or
    the CUDA device when there is one."""
    model = CustomHybridModel(
        name=name,
        predictors=tuple(predictors),
        forcing=tuple(forcing),
        targets=tuple(targets),
        param_inits=tuple((str(k), float(v)) for k, v in params.items()),
        forward=forward,
        nn=nn,
        nn_out_dim=nn_out_dim,
        generator=generator,
    )
    return model.to(default_device() if device is None else device)
