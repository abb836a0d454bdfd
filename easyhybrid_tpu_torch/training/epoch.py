"""The torch training epoch and the evaluation programs.

PyTorch counterpart of ``easyhybrid_tpu/training/epoch.py``: the plain
engine (``epoch_path == "torch"``) and the reference of the fused kernel's
exactness gate. Each step is autograd over the module's training-mode
forward plus an optax-formula update (``training/optimizers.py``).

* The epoch tensors live on the model's device (:func:`epoch_tensors_to`).
* Shuffles: ``True`` permutes all ``num_batches · batch`` slots, padding
  included (padding rows carry zero masks wherever they land);
  ``"batches"`` permutes the batch order only; ``False`` keeps the order.
  Permutations are a key-sort of uniforms drawn from a ``torch.Generator``
  on the tensors' device (:func:`epoch_permutation`), the JAX package's
  scheme with torch's random stream. An epoch function also takes the
  permutations directly (``perm``), so a test can inject the JAX ones.
* The empty-batch guard: an all-masked batch leaves the parameters, the
  optimizer state and the BatchNorm running statistics unchanged and adds
  0 to the epoch loss. It selects with ``torch.where`` on a device flag,
  so it never waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..data.loaders import EpochTensors
from ..losses.compute import compute_loss
from ..losses.specs import LoggingLoss

__all__ = [
    "epoch_permutation",
    "epoch_tensors_to",
    "shuffle_epoch_tensors",
    "can_skip_empty_guard",
    "make_train_epoch",
    "make_evaluator",
    "make_dual_evaluator",
    "make_loss_fn",
]


def epoch_tensors_to(tensors: EpochTensors, device) -> EpochTensors:
    """The epoch arrays as float32 tensors on ``device`` (one copy each)."""

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return EpochTensors(
        x=put(tensors.x),
        forcing={k: put(v) for k, v in tensors.forcing.items()},
        y={k: put(v) for k, v in tensors.y.items()},
        mask={k: put(v) for k, v in tensors.mask.items()},
        weight=put(tensors.weight),
        n_samples=tensors.n_samples,
    )


def epoch_permutation(generator: torch.Generator, n: int) -> torch.Tensor:
    """Uniform random permutation of ``n`` on the generator's device: one
    key-sort of uniforms, as the JAX package draws it."""
    u = torch.rand((n,), generator=generator, device=generator.device)
    return torch.argsort(u)


def shuffle_epoch_tensors(tensors: EpochTensors, perm) -> EpochTensors:
    """Apply a sample permutation over all ``num_batches · batch`` slots."""
    nb, batch = tensors.weight.shape
    n = nb * batch

    def take(a):
        return a.reshape((n,) + tuple(a.shape[2:]))[perm].reshape(a.shape)

    return EpochTensors(
        x=take(tensors.x),
        forcing={k: take(v) for k, v in tensors.forcing.items()},
        y={k: take(v) for k, v in tensors.y.items()},
        mask={k: take(v) for k, v in tensors.mask.items()},
        weight=take(tensors.weight),
        n_samples=tensors.n_samples,
    )


def _shuffle_batches(tensors: EpochTensors, perm) -> EpochTensors:
    return EpochTensors(
        x=tensors.x[perm],
        forcing={k: v[perm] for k, v in tensors.forcing.items()},
        y={k: v[perm] for k, v in tensors.y.items()},
        mask={k: v[perm] for k, v in tensors.mask.items()},
        weight=tensors.weight[perm],
        n_samples=tensors.n_samples,
    )


def can_skip_empty_guard(tensors: EpochTensors) -> bool:
    """True when no batch can consist entirely of invalid samples under any
    permutation: fewer invalid samples (padding or all-NaN targets) exist
    than one batch holds."""
    if not tensors.mask:
        return False
    batch = tensors.batch_size
    valid_any = None
    for m in tensors.mask.values():
        m = np.asarray(m.cpu() if torch.is_tensor(m) else m)
        per_sample = m.reshape(m.shape[0] * m.shape[1], -1).sum(axis=-1) > 0
        valid_any = per_sample if valid_any is None else (valid_any | per_sample)
    return int((~valid_any).sum()) < batch


def _train_logging(logging: LoggingLoss, train_mode: bool) -> LoggingLoss:
    return LoggingLoss(
        loss_types=logging.loss_types,
        training_loss=logging.training_loss,
        extra_loss=logging.extra_loss,
        agg=logging.agg,
        train_mode=train_mode,
    )


def perms_for_epochs(shuffle, tensors: EpochTensors, epochs: int, *,
                     generator: Optional[torch.Generator] = None, perm=None):
    """``(epochs, n)`` sample permutations (shuffle True), ``(epochs,
    num_batches)`` batch permutations (``"batches"``), or None (no shuffle,
    or one batch). ``perm`` (one permutation or one per epoch) wins over
    drawing from ``generator``."""
    nb, batch = tensors.weight.shape
    if shuffle is True and nb > 1:
        n = nb * batch
    elif shuffle == "batches" and nb > 1:
        n = nb
    elif shuffle in (True, False, "batches"):
        return None
    else:
        raise ValueError(f"shuffle must be True, False or 'batches'; got {shuffle!r}")
    if perm is not None:
        if not torch.is_tensor(perm):
            perm = torch.from_numpy(np.array(perm, dtype=np.int64))
        perm = perm.to(device=tensors.weight.device, dtype=torch.int64)
        perm = perm.reshape(-1, n)
        if perm.shape[0] != epochs:
            raise ValueError(f"{perm.shape[0]} permutations for {epochs} epochs")
        return perm
    if generator is None:
        raise ValueError("a shuffled epoch needs a generator or explicit permutations")
    return torch.stack([epoch_permutation(generator, n) for _ in range(epochs)])


def make_train_epoch(
    model,
    logging: LoggingLoss,
    optimizer,
    *,
    shuffle: Any = True,
    epochs_per_call: int = 1,
    skip_empty_guard: bool = False,
) -> Callable:
    """Build ``epoch_fn(opt_state, tensors, generator=None, perm=None) ->
    (opt_state, mean_batch_loss)``, which trains ``model`` in place.

    ``tensors`` is an :class:`EpochTensors` of torch tensors on the model's
    device. ``epochs_per_call > 1`` runs that many (re-shuffled) epochs and
    returns the last epoch's mean batch loss."""
    train_logging = _train_logging(logging, True)
    epochs = max(1, int(epochs_per_call))

    def one_epoch(opt_state, tensors: EpochTensors, perm):
        if perm is not None:
            tensors = (shuffle_epoch_tensors if shuffle is True else _shuffle_batches)(
                tensors, perm)
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        names = list(params)
        losses = []
        for i in range(tensors.weight.shape[0]):
            batch = (
                (tensors.x[i], {k: v[i] for k, v in tensors.forcing.items()}),
                ({k: v[i] for k, v in tensors.y.items()},
                 {k: v[i] for k, v in tensors.mask.items()}),
            )
            guard = not skip_empty_guard and bool(tensors.mask)
            if guard:
                old_buffers = {k: b.detach().clone() for k, b in buffers.items()}
            loss = compute_loss(model, batch, train_logging)
            grads = torch.autograd.grad(
                loss, [params[k] for k in names], allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                     for k, g in zip(names, grads)}
            with torch.no_grad():
                current = {k: p.detach() for k, p in params.items()}
                updates, new_state = optimizer.update(grads, opt_state, current)
                if guard:
                    valid = sum(m.sum() for m in batch[1][1].values()) > 0
                    for k, p in params.items():
                        p.copy_(torch.where(valid, p + updates[k], p))
                    opt_state = _select(valid, new_state, opt_state)
                    for k, b in buffers.items():
                        b.copy_(torch.where(valid, b, old_buffers[k]))
                    loss = torch.where(valid, loss, torch.zeros_like(loss))
                else:
                    for k, p in params.items():
                        p.add_(updates[k])
                    opt_state = new_state
            losses.append(loss.detach())
        return opt_state, torch.mean(torch.stack(losses))

    def epoch_fn(opt_state, tensors: EpochTensors, generator=None, perm=None):
        perms = perms_for_epochs(shuffle, tensors, epochs, generator=generator, perm=perm)
        loss = None
        for e in range(epochs):
            opt_state, loss = one_epoch(opt_state, tensors, None if perms is None else perms[e])
        return opt_state, loss

    return epoch_fn


def _select(valid, new, old):
    if isinstance(new, dict):
        return {k: _select(valid, v, old[k]) for k, v in new.items()}
    return torch.where(valid, new, old)


def make_evaluator(model, logging: LoggingLoss, *, with_outputs: bool = False) -> Callable:
    """``eval_fn(batch) -> metrics`` (or ``(metrics, outputs)``) over a full
    ``((x, forcing), (y, mask))`` split in eval mode."""
    eval_logging = _train_logging(logging, False)

    def eval_fn(batch):
        metrics, outputs = compute_loss(model, batch, eval_logging)
        return (metrics, outputs) if with_outputs else metrics

    return eval_fn


def make_dual_evaluator(model, logging: LoggingLoss) -> Callable:
    """``eval_fn(train_batch, val_batch) -> ((m_tr, out_tr), (m_va, out_va))``."""
    evaluate = make_evaluator(model, logging, with_outputs=True)

    def eval_fn(train_batch, val_batch):
        return evaluate(train_batch), evaluate(val_batch)

    return eval_fn


def make_loss_fn(model, logging: LoggingLoss) -> Callable:
    """Scalar training-loss closure ``f(batch) -> loss`` (train mode)."""
    train_logging = _train_logging(logging, True)

    def loss_fn(batch):
        return compute_loss(model, batch, train_logging)

    return loss_fn
