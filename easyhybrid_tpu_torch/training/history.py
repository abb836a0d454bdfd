"""Epoch snapshots and training history.

A copy of ``easyhybrid_tpu/training/history.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["EpochSnapshot", "TrainingHistory"]


@dataclasses.dataclass
class EpochSnapshot:
    """Per-epoch record: nested metric dicts + (optional) prediction dicts."""

    l_train: Dict[str, Dict[str, float]]
    l_val: Dict[str, Dict[str, float]]
    y_hat_train: Optional[Dict[str, Any]] = None
    y_hat_val: Optional[Dict[str, Any]] = None


def _agg_loss(
    metrics: Dict[str, Dict[str, float]], agg_name: str, metric: Optional[str] = None
) -> float:
    """Aggregated scalar of the monitored metric, looked up BY NAME; the
    first entry only when the name is absent (as the JAX package does)."""
    if metric is not None and metric in metrics:
        return float(metrics[metric][agg_name])
    first = next(iter(metrics.values()))
    return float(first[agg_name])


@dataclasses.dataclass
class TrainingHistory:
    """Epoch-indexed snapshots; index 0 is the initial (untrained) state."""

    snapshots: List[EpochSnapshot] = dataclasses.field(default_factory=list)

    def append(self, snapshot: EpochSnapshot) -> None:
        self.snapshots.append(snapshot)

    def __len__(self):
        return len(self.snapshots)

    def __getitem__(self, i):
        return self.snapshots[i]

    def train_losses(self) -> List[Dict[str, Dict[str, float]]]:
        return [s.l_train for s in self.snapshots]

    def val_losses(self) -> List[Dict[str, Dict[str, float]]]:
        return [s.l_val for s in self.snapshots]

    def series(self, metric: str, which: str = "val") -> Dict[str, List[float]]:
        """Per-target (and agg) loss trajectories for one metric name."""
        out: Dict[str, List[float]] = {}
        for snap in self.snapshots:
            m = (snap.l_val if which == "val" else snap.l_train).get(metric, {})
            for k, v in m.items():
                out.setdefault(k, []).append(float(v))
        return out
