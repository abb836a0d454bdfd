"""The deferred (zero-readback) training loop.

PyTorch counterpart of ``easyhybrid_tpu/training/deferred.py``. ``train()``
takes it whenever nothing needs host values in the middle of a run
(:func:`defer_blockers` is empty): the host dispatches every block of
``eval_every`` epochs back to back, early stopping runs on the device
(:class:`~.early_stopping.DeviceStopper`), and one fetch at the end brings
back the whole history. The host then replays the same patience arithmetic
on the fetched rows to cut the history where the eager loop would have
stopped. The results are the eager loop's, bit for bit on the same engine.

* Every evaluation writes one float32 row into a device buffer of
  ``nepochs // eval_every + 1`` rows (:class:`SnapshotRow`): the train and
  val metrics, the tracked globals (scaled into their bounds), the monitored
  parameters' q25/q50/q75 over the valid validation rows, and the gradient
  norms under ``return_gradients``. With ``keep_history`` the predictions of
  both splits go into device buffers of as many rows.
* Blocks after the stop are frozen by the stopper's ``done`` word: a fused
  engine passes its address to the kernel, which returns at entry when it is
  set (its launcher cloned the parameters and slots, so the launch gives back
  its inputs); the torch engine selects ``torch.where(done, old, new)`` over
  the model's leaves, buffers and optimizer slots.
* Under a patience the host learns of the stop without waiting: after each
  block it copies ``done`` into a pinned host word (``non_blocking``) and
  records an event, and before each dispatch it reads the word only if that
  event has completed (:func:`poll_done`, the loop's one host read). Blocks
  queued before it saw the stop halt at once.

Between the first block and the final fetch nothing waits for the device:
no ``.item()``, ``.cpu()``, ``.tolist()``, blocking copy or synchronize.
:data:`SYNC_DEBUG_MODE`, a hook for tests and checks, runs that window
under ``torch.cuda.set_sync_debug_mode``, which turns any such call into a
warning or an error. :func:`loop_record` gives a result's
:class:`LoopRecord`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..params import scale_param
from . import early_stopping
from .early_stopping import DeviceStopper, EarlyStopping
from .history import EpochSnapshot, TrainingHistory, monitored_metric

__all__ = ["can_defer", "defer_blockers", "history_rows_padded", "run_deferred_loop",
           "SnapshotRow", "LoopRecord", "loop_record", "SYNC_DEBUG_MODE", "poll_done"]

#: a hook for tests and checks: ``torch.cuda.set_sync_debug_mode`` inside the
#: dispatch window of a run on the card, 0 (off), ``"warn"`` or ``"error"``
SYNC_DEBUG_MODE: Any = 0

QUANTILES = ("q25", "q50", "q75")


def history_rows_padded(cfg) -> int:
    """The JAX loop's history rows: the snapshots padded up to a power of
    two (at least 16). The port allocates only the snapshots, but bounds
    ``keep_history`` by this count, as the JAX package does."""
    n_rows = cfg.nepochs // max(1, int(cfg.eval_every)) + 1
    return max(16, 1 << (n_rows - 1).bit_length())


def defer_blockers(cfg, n_samples: Optional[int] = None) -> tuple:
    """The settings that force the eager loop, by name; empty when the run
    can defer. ``n_samples`` (train plus val samples, when known) bounds a
    deferred ``keep_history``, whose predictions live in device buffers."""
    blockers = []
    if cfg.show_progress:
        blockers.append("show_progress=True")
    if cfg.plotting:
        blockers.append("plotting=True")
    if not cfg.jit:
        blockers.append("jit=False")
    if (
        cfg.keep_history
        and n_samples is not None
        and n_samples * history_rows_padded(cfg) > 250_000_000
    ):
        blockers.append(
            "keep_history=True with a prediction history too large for "
            "on-device buffers"
        )
    return tuple(blockers)


def can_defer(cfg, n_samples: Optional[int] = None) -> bool:
    """True when no consumer needs host values in the middle of the run."""
    return not defer_blockers(cfg, n_samples)


# ---------------------------------------------------------------------------
# one row a snapshot
# ---------------------------------------------------------------------------

def grad_norms(grads: Mapping[str, torch.Tensor], branch_of: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """The global L2 norm of ``grads`` and one per top-level key of the JAX
    parameter tree (``branch_of``: port name -> key), as optax's
    ``global_norm``: the square root of the leaves' sums of squares."""

    def norm(ts):
        return torch.sqrt(sum(torch.sum(g * g) for g in ts))

    out = {"global": norm(grads.values())}
    for key in sorted(set(branch_of.values())):
        out[key] = norm(g for k, g in grads.items() if branch_of[k] == key)
    return out


def nanquantile(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``torch.nanquantile(a, q)`` of a 1-d ``a`` (linear interpolation, NaN
    ignored), in the same operations as PyTorch's own, none of which waits
    for the device."""
    s = torch.sort(a).values  # NaN last
    rank = q * (torch.logical_not(torch.isnan(s)).sum() - 1)
    rank = rank.masked_fill(rank < 0, 0)
    below = rank.to(torch.int64)
    lo = s.gather(0, below)
    hi = s.gather(0, rank.ceil().to(torch.int64))
    return lo.lerp(hi, rank - below)


def monitoredquantiles(out_va, names, n_val: int) -> Dict[str, torch.Tensor]:
    """``name -> (q25, q50, q75)`` of each monitored per-sample parameter
    over the valid validation rows, NaN ignored, on the outputs' device."""
    out = {}
    params_out = (out_va or {}).get("parameters", {})
    for name in names:
        if name not in params_out:
            continue
        arr = params_out[name]
        if arr.ndim and arr.shape[0] >= n_val:
            arr = arr[:n_val]
        arr = arr.reshape(-1).to(torch.float32)
        if arr.numel() < 1:
            continue
        q = torch.arange(1, 4, dtype=torch.float32, device=arr.device) * 0.25
        out[name] = nanquantile(arr, q)
    return out


class SnapshotRow:
    """Everything one evaluation records, as one float32 row on the device.

    ``take()`` evaluates both splits and returns ``(row, out_tr, out_va)``;
    the row's layout (``keys``) is fixed by the first call. ``unpack(values)``
    turns a row's host values back into ``(l_train, l_val, tracked,
    monitored, grads)`` dicts. Both loops use it, so the eager loop's host
    values are the deferred loop's row, bit for bit."""

    def __init__(self, *, model, evaluator: Callable, train_batch, val_batch, cfg, n_val: int,
                 grad_probe: Optional[Callable] = None, branch_of: Optional[Mapping[str, str]] = None):
        self.model, self.evaluator = model, evaluator
        self.train_batch, self.val_batch = train_batch, val_batch
        self.tracked_names = tuple(cfg.tracked_params or ())
        self.monitor_names = tuple(cfg.monitor_names or ())
        self.n_val = n_val
        self.grad_probe, self.branch_of = grad_probe, branch_of
        self.keys: Optional[List[tuple]] = None

    def _tracked(self) -> Dict[str, torch.Tensor]:
        out = {}
        if not self.tracked_names:
            return out
        table = self.model.param_table
        globals_, fixed = self.model.globals.as_dict(), self.model.fixed.as_dict()
        for name in self.tracked_names:
            if name in globals_:
                v = scale_param(globals_[name].detach(), table.lower_of(name), table.upper_of(name))
                out[name] = v.reshape(-1)[0]
            elif name in fixed:
                out[name] = fixed[name].detach().reshape(-1)[0]
        return out

    def take(self):
        (m_tr, out_tr), (m_va, out_va) = self.evaluator(self.train_batch, self.val_batch)
        values: Dict[tuple, Any] = {}
        for split, metrics in (("train", m_tr), ("val", m_va)):
            for metric, entry in metrics.items():
                for t, v in entry.items():
                    values[(split, metric, t)] = v
        for name, v in self._tracked().items():
            values[("tracked", name)] = v
        for name, q in monitoredquantiles(out_va, self.monitor_names, self.n_val).items():
            for i, qn in enumerate(QUANTILES):
                values[("monitored", name, qn)] = q[i]
        if self.grad_probe is not None:
            for k, v in grad_norms(self.grad_probe(self.train_batch), self.branch_of).items():
                values[("grads", k)] = v
        if self.keys is None:
            self.keys = list(values)
        elif list(values) != self.keys:
            raise RuntimeError(f"a snapshot's layout changed: {list(values)} != {self.keys}")
        row = torch.stack([torch.as_tensor(v).reshape(()).to(torch.float32)
                           for v in values.values()])
        return row, out_tr, out_va

    def index(self, metric: str, agg: str) -> int:
        """The row's column of the monitored val metric's aggregate
        (``history.monitored_metric``, as the host stopper reads it)."""
        names = dict.fromkeys(k[1] for k in self.keys if k[0] == "val")
        return self.keys.index(("val", monitored_metric(names, metric), agg))

    def unpack(self, values) -> Tuple[dict, dict, dict, dict, Optional[dict]]:
        l_train: Dict[str, Dict[str, float]] = {}
        l_val: Dict[str, Dict[str, float]] = {}
        tracked: Dict[str, float] = {}
        monitored: Dict[str, Dict[str, float]] = {}
        grads: Optional[Dict[str, float]] = {} if self.grad_probe is not None else None
        for key, v in zip(self.keys, values):
            v = float(v)
            if key[0] in ("train", "val"):
                (l_train if key[0] == "train" else l_val).setdefault(key[1], {})[key[2]] = v
            elif key[0] == "tracked":
                tracked[key[1]] = v
            elif key[0] == "monitored":
                monitored.setdefault(key[1], {})[key[2]] = v
            else:
                grads[key[1]] = v
        return l_train, l_val, tracked, monitored, grads


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoopRecord:
    """What a deferred run did, for measurement: blocks dispatched, those
    dispatched after the stop (halted launches), the stop's snapshot index
    (None: no stop), and the host's seconds dispatching the blocks and
    waiting for the final fetch."""

    blocks: int = 0
    blocks_after_stop: int = 0
    stop_index: Optional[int] = None
    dispatch_s: float = 0.0
    fetch_s: float = 0.0


def loop_record(result) -> Optional[LoopRecord]:
    """The :class:`LoopRecord` of the run that gave ``result`` (a
    ``TrainResults``); None for the eager loop."""
    return getattr(result, "_loop_record", None)


class _DonePoll:
    """The stopper's ``done`` word on its way to the host: a pinned host
    word and an event on the card, the word itself on the CPU."""

    def __init__(self, done: torch.Tensor):
        self.done = done
        self.cuda = done.is_cuda
        self.event = None
        if self.cuda:
            self.host = torch.zeros((), dtype=torch.int32, pin_memory=True)
            self.event = torch.cuda.Event()
            self.recorded = False

    def start(self) -> None:
        """Queue the copy of the newest ``done`` behind the block's work."""
        if self.cuda:
            self.host.copy_(self.done, non_blocking=True)
            self.event.record()
            self.recorded = True


def poll_done(poll: _DonePoll) -> bool:
    """Whether the host has seen the stop: on the card, the pinned word once
    the event of its newest copy has completed (``event.query()`` never
    waits), else False; on the CPU, the word itself. The deferred loop's one
    host read between the first block and the final fetch."""
    if not poll.cuda:
        return bool(poll.done.item())
    if not poll.recorded or not poll.event.query():
        return False
    return bool(poll.host.item())


@contextlib.contextmanager
def _sync_debug(device: torch.device):
    if device.type != "cuda" or not SYNC_DEBUG_MODE:
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(SYNC_DEBUG_MODE)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _buffers(outputs, n_rows: int):
    """Device buffers of ``n_rows`` rows for an evaluation's outputs."""
    def buf(v):
        b = torch.zeros((n_rows,) + tuple(v.shape), dtype=v.dtype, device=v.device)
        b[0].copy_(v)
        return b

    return {k: ({kk: buf(vv) for kk, vv in v.items()} if isinstance(v, Mapping) else buf(v))
            for k, v in outputs.items()}


def _put(buffers, outputs, i: int) -> None:
    for k, v in outputs.items():
        if isinstance(v, Mapping):
            for kk, vv in v.items():
                buffers[k][kk][i].copy_(vv)
        else:
            buffers[k][i].copy_(v)


def _host_row(buffers, i: int, n: int):
    """Row ``i`` of fetched prediction buffers, cut to ``n`` samples, as
    ``train._outputs_to_host`` gives it."""
    def cut(a):
        a = a[i]
        return a[:n] if a.ndim >= 1 and a.shape[0] >= n else a

    return {k: ({kk: cut(vv) for kk, vv in v.items()} if isinstance(v, Mapping) else cut(v))
            for k, v in buffers.items()}


def run_deferred_loop(*, cfg, run, rows: SnapshotRow, eval_every: int, n_train: int, n_val: int):
    """The whole run with no host read between the first block and the
    final fetch. ``run`` is the engine (``block(halt)``, ``kept()``);
    ``rows`` the snapshot layout. Returns a dict: ``history``, ``tracked``,
    ``monitored``, ``grad_history``, ``best_epoch``, ``best_loss``,
    ``best`` (the kept tensors of the best snapshot, on the device) and
    ``record`` (its :class:`LoopRecord`)."""
    metric, agg = early_stopping.monitored(cfg)
    keep_history = bool(cfg.keep_history)
    n_rows = cfg.nepochs // eval_every + 1

    row0, out_tr0, out_va0 = rows.take()
    col = rows.index(metric, agg)
    hist = torch.zeros((n_rows, row0.numel()), dtype=torch.float32, device=row0.device)
    hist[0].copy_(row0)
    ytr = yva = None
    if keep_history:
        ytr, yva = _buffers(out_tr0, n_rows), _buffers(out_va0, n_rows)
    stopper = DeviceStopper(row0[col], run.kept(), cfg)
    poll = _DonePoll(stopper.done) if cfg.patience is not None else None  # no patience: no stop

    record = LoopRecord()
    t0 = time.perf_counter()
    with _sync_debug(row0.device):
        for i in range(1, n_rows):
            if poll is not None and poll_done(poll):
                break
            run.block(halt=stopper.done)
            row, out_tr, out_va = rows.take()
            hist[i].copy_(row)
            if keep_history:
                _put(ytr, out_tr, i)
                _put(yva, out_va, i)
            stopper.update(row[col], i * eval_every, run.kept())
            if poll is not None:
                poll.start()
            record.blocks = i
    t1 = time.perf_counter()

    # ---- the one fetch ----
    hist_np = hist[: record.blocks + 1].cpu().numpy()
    device_best_epoch = int(stopper.best_epoch.cpu())
    if keep_history:
        ytr = {k: ({kk: vv.cpu().numpy() for kk, vv in v.items()} if isinstance(v, Mapping)
                   else v.cpu().numpy()) for k, v in ytr.items()}
        yva = {k: ({kk: vv.cpu().numpy() for kk, vv in v.items()} if isinstance(v, Mapping)
                   else v.cpu().numpy()) for k, v in yva.items()}
    record.fetch_s = time.perf_counter() - t1
    record.dispatch_s = t1 - t0

    # ---- the host replay: the eager loop's stopper over the fetched rows ----
    tracked: Dict[str, list] = {}
    monitored: Dict[str, list] = {}
    grad_history: list = []

    def snapshot(i: int) -> EpochSnapshot:
        l_train, l_val, tracked_i, monitored_i, grads_i = rows.unpack(hist_np[i].tolist())
        for k, v in tracked_i.items():
            tracked.setdefault(k, []).append(v)
        for k, v in monitored_i.items():
            monitored.setdefault(k, []).append(v)
        if grads_i is not None:
            grad_history.append(grads_i)
        snap = EpochSnapshot(l_train, l_val)
        if keep_history:
            snap.y_hat_train = _host_row(ytr, i, n_train)
            snap.y_hat_val = _host_row(yva, i, n_val)
        return snap

    history = TrainingHistory([snapshot(0)])
    host = EarlyStopping(history[0], {}, {}, cfg)
    for i in range(1, record.blocks + 1):
        host.update(history, snapshot(i), {}, {}, i * eval_every, keep_history)
        if host.done:
            record.stop_index = i
            record.blocks_after_stop = record.blocks - i
            break
    if host.best_epoch != device_best_epoch:
        raise RuntimeError(f"the device's early stopper kept epoch {device_best_epoch}, the "
                           f"host's replay of its rows epoch {host.best_epoch}")
    return dict(history=history, tracked=tracked, monitored=monitored,
                grad_history=grad_history, best_epoch=host.best_epoch, best_loss=host.best_loss,
                best=stopper.kept, record=record)
