"""Loss assembly: per-target masked losses plus aggregation, in train and
eval modes.

PyTorch counterpart of ``easyhybrid_tpu/losses/compute.py``. The model
holds its parameters, so ``compute_loss(model, batch, logging)`` takes no
``params`` / ``state``: the train mode runs the module's training-mode
forward (trainable BatchNorm updates its running statistics in place, as
the JAX ``new_state`` would carry them); the eval mode runs it in eval mode
without gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from .specs import LoggingLoss, PerTarget, loss_name, to_loss_spec

__all__ = ["compute_loss", "assemble_loss", "align_prediction"]


def align_prediction(y_hat, y):
    """Align a prediction's time axis to the target's trailing output window
    (sequence models); a no-op for per-sample targets."""
    y_arr = y[0] if isinstance(y, tuple) else y
    if y_hat.ndim >= 2 and y_arr.ndim >= 2 and y_hat.shape[1] != y_arr.shape[1]:
        nout = y_arr.shape[1]
        return y_hat[:, -nout:, ...]
    return y_hat


def _get_output(outputs: Mapping[str, Any], target: str):
    if target not in outputs:
        raise KeyError(
            f"mechanistic model did not produce target {target!r}; "
            f"outputs: {sorted(k for k in outputs if k not in ('parameters', 'nn_outputs'))}"
        )
    return outputs[target]


def _target_mask(y, mask, target: str):
    if mask is None:
        y_arr = y[0] if isinstance(y, tuple) else y
        return torch.isfinite(y_arr)
    if isinstance(mask, Mapping):
        return mask[target]
    return mask


def assemble_loss(outputs, y, mask, targets: Tuple[str, ...], spec):
    """Per-target loss list for one spec (or a PerTarget bundle)."""
    spec = to_loss_spec(spec) if not isinstance(spec, PerTarget) else spec
    if isinstance(spec, PerTarget):
        if len(spec.losses) != len(targets):
            raise ValueError(
                f"PerTarget has {len(spec.losses)} losses but there are "
                f"{len(targets)} targets"
            )
        specs = spec.losses
    else:
        specs = (spec,) * len(targets)
    losses = []
    for target, sp in zip(targets, specs):
        y_t = y[target]
        y_arr = y_t[0] if isinstance(y_t, tuple) else y_t
        y_hat_t = align_prediction(_get_output(outputs, target), y_t)
        m_t = _target_mask(y_t, mask, target)
        losses.append(sp(y_hat_t, y_t if isinstance(y_t, tuple) else y_arr, m_t))
    return losses


def compute_loss(model, batch, logging: LoggingLoss):
    """Main loss entry. ``batch = ((x, forcing), (y, mask))`` with ``y`` and
    ``mask`` dicts keyed by target (``mask`` may be None: finiteness).

    * train mode → the scalar loss (a tensor with a graph);
    * eval mode → ``(metrics, outputs)`` with
      ``metrics[loss_name][target]`` and ``metrics[loss_name][agg]``.
    """
    (x, forcing), (y, mask) = batch
    targets = model.targets
    agg = logging.agg_fn
    params = dict(model.named_parameters())

    if logging.train_mode:
        model.train()
        outputs = model(x, forcing)
        losses = assemble_loss(outputs, y, mask, targets, logging.training_loss)
        loss_value = agg(losses)
        if logging.extra_loss is not None:
            extra = logging.extra_loss(outputs, params)
            if isinstance(extra, Mapping):
                loss_value = agg([loss_value, *extra.values()])
            else:
                loss_value = agg([loss_value, extra])
        return loss_value

    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            outputs = model(x, forcing)
            metrics: Dict[str, Dict[str, Any]] = {}
            for lt in logging.loss_types:
                losses = assemble_loss(outputs, y, mask, targets, lt)
                entry = {t: l for t, l in zip(targets, losses)}
                entry[logging.agg_name] = agg(losses)
                metrics[loss_name(lt)] = entry
            if logging.extra_loss is not None:
                extra = logging.extra_loss(outputs, params)
                if not isinstance(extra, Mapping):
                    extra = {"extra": extra}
                entry = dict(extra)
                entry[logging.agg_name] = agg(list(extra.values()))
                metrics["extra_loss"] = entry
    finally:
        model.train(was_training)
    return metrics, outputs
