"""The device the port's entry points run on when the caller names none."""

from __future__ import annotations

import torch

__all__ = ["default_device"]


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is available, else ``cpu``. Models built
    without a ``device=`` argument live there, and ``train`` / ``predict``
    follow the model's device; pass ``device="cpu"`` to stay on the host."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
