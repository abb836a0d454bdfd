"""Population training: K sweep, ensemble or fold members trained side by side.

PyTorch counterpart of ``easyhybrid_tpu/training/population.py``. A
hyperparameter sweep, a seed ensemble or a k-fold cross-validation trains as
one population: per-member parameters, optimizer state and optimizer
numbers, stacked ``(K, …)``, over data shared by every member (a sweep, an
ensemble) or one fold a member (cross-validation). The run is a fixed epoch
budget, ``(nepochs // eval_every) * eval_every`` epochs, evaluated after
every block of ``eval_every`` epochs, with each member's best score, epoch
and parameters kept on the device (``torch.where``) and the history rows
written into device buffers: nothing is read back between the first block
and one fetch at the end, the discipline of ``training/deferred.py``.

Two engines (``PopulationResults.epoch_path``):

* ``"population_vmap_fused"`` (``"population_vmap_cv_fused"``): a fused
  kernel's member axis. Kernel 2's (``ops/fused_epoch.py``,
  :meth:`FusedEpoch.members`) for an MLP hybrid one block holds, kernel 4's
  (``ops/fused_epoch_lstm.py``, the same method of :class:`FusedLSTMEpoch`)
  for an LSTM hybrid on windows: one launch per block trains every member, a
  thread-block cluster each, each member with its own optimizer numbers (a
  sweep of any hyperparameter ``parse_opt_spec`` knows), row index and data.
  Kernel 3's (``ops/fused_wide.py``, :meth:`FusedWideEpoch.members`) for a
  wider MLP hybrid: one launcher call per block, each of a step's launches
  over every member (the member a grid dimension), each member with its own
  workspace, running statistics, optimizer numbers, row index and data.
  Kernel 5's (``ops/fused_multisite.py``, :meth:`FusedMultisiteEpoch.members`)
  for a seed ensemble of a ``share_nn`` ``MultiSiteHybridModel``, as the JAX
  package vmaps its multi-site kernel: one launcher call per block, a row of
  site blocks each member, each with its own site permutations, over the
  sites they share (``engine_reason`` begins ``"multisite kernel: "``). On
  the card with ``use_kernel="auto"`` (or anywhere with ``use_kernel=True``,
  where a CPU model runs the member axis's plain version) for a model,
  optimizer and loss the kernel takes, behind the exactness gate on member
  0's spec and a member self-check (:func:`member_selfcheck`), each once per
  configuration and process. A kernel that fails to build or launch raises:
  there is no fallback that hides it. A failed gate or self-check raises
  under ``use_kernel=True``; under ``"auto"`` it runs the torch engine and
  says so in ``engine_reason``.
* ``"population_vmap"`` (``"population_vmap_cv"``): the torch engine, one
  step for every member at once with ``torch.func.vmap`` over
  ``torch.func.functional_call`` and ``torch.func.grad``, the update by
  ``Optimizer.update`` with the members' numbers as tensors (the counterpart
  of ``optax.inject_hyperparams``). A model whose training forward updates
  buffers in place (trainable BatchNorm's running statistics), which
  ``vmap`` cannot take, steps member by member instead. Models that go to
  kernel 4's cluster-split form run here too (its member axis: ROADMAP
  queue B, item 5), and so do a multi-site model's sweeps and
  cross-validations, which the JAX package also keeps off its multi-site
  kernel.

Evaluation runs the dual evaluator under ``vmap`` for every member at once.
A pure sweep (no ``seeds``) gives every member the same permutation each
block, so members differ only by their hyperparameters; a seed ensemble
draws each member's own. Members start from :func:`init_member_params`,
``torch.Generator(seed)`` through the model's own constructor, the port's
stream (the JAX package's keys give other numbers; tests carry the JAX inits
across by swapping that function).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.loaders import EpochTensors, build_epoch_tensors, pad_axis0
from ..data.prepare import HybridData, prepare_data
from ..data.split import split_data
from ..losses.metrics import MAXIMIZE_METRICS, best_direction
from ..losses.specs import LoggingLoss, loss_name
from ..losses.compute import compute_loss
from ..params import scale_param
from . import deferred
from .epoch import _train_logging, epoch_tensors_to, map_x, perms_for_epochs, select_state
from .optimizers import OPT_DEFAULTS, member_scalars, parse_opt_spec, resolve_optimizer

__all__ = ["population_train", "population_cross_validate", "PopulationResults",
           "init_member_params", "member_selfcheck"]

log = logging.getLogger("easyhybrid_tpu_torch")

# per-process verdicts of the fused engine's gate and member self-check, by
# configuration: a repeat population (a tune loop) launches neither again
_VERDICTS: Dict[Any, Tuple[bool, str]] = {}


@dataclasses.dataclass
class PopulationResults:
    """Stacked results of a population run. Every parameter and state leaf
    is a CPU tensor keyed like ``named_parameters()`` / ``named_buffers()``
    with the member axis (K) in front, as ``TrainResults`` keys a model's."""

    hyper: Dict[str, np.ndarray]          #: per-member swept hyperparameters
    seeds: np.ndarray                     #: per-member init seeds (fold ids in CV)
    params: Dict[str, torch.Tensor]       #: FINAL params, stacked (K, ...)
    best_params: Dict[str, torch.Tensor]  #: best-val params, stacked
    state: Dict[str, torch.Tensor]        #: final buffers (statistics, fixed values), stacked
    best_losses: np.ndarray               #: best monitored val value (K,)
    best_epochs: np.ndarray               #: epoch of the best (K,), 0: the start
    train_history: Dict[str, np.ndarray]  #: metric -> (n_evals, K)
    val_history: Dict[str, np.ndarray]    #: metric -> (n_evals, K)
    epochs: np.ndarray                    #: epoch index per history row
    best_member: int                      #: argbest of best_losses
    monitor: str                          #: metric best_losses tracks
    epoch_path: str = "population_vmap"
    engine_reason: Optional[str] = None   #: why that engine was selected
    kernel_launches: int = 0              #: member launches the loop made (0: no kernel)

    def member_params(self, i: int, *, best: bool = True) -> Dict[str, torch.Tensor]:
        """Member ``i``'s (best) parameters, keyed and shaped like a single
        ``train()`` result's ``params``."""
        tree = self.best_params if best else self.params
        return {k: v[i] for k, v in tree.items()}

    def param_spread(self, model=None, *, best: bool = True):
        """Across-member mean and std of every GLOBAL parameter: physical-
        parameter uncertainty from a seed or hyper ensemble. With ``model``
        given, in PHYSICAL units (``scale_param`` into the parameter's
        bounds), else raw. Returns ``{name: (mean, std)}``."""
        tree = self.best_params if best else self.params
        out = {}
        for key, raw in tree.items():
            if not key.startswith("globals."):
                continue
            name = key[len("globals."):]
            vals = raw.detach().cpu().float().reshape(len(self.seeds), -1)
            if model is not None:
                table = model.param_table
                vals = scale_param(vals, table.lower_of(name), table.upper_of(name))
            vals = vals.numpy()
            out[name] = (vals.mean(axis=0).squeeze(), vals.std(axis=0).squeeze())
        return out


def _monitor_setup(training_loss, loss_types, agg):
    """Shared loss/monitor plumbing: the LoggingLoss, the monitored metric
    name, its direction sign, and the metrics→aggregated-scalar extractor
    (keyed by the LoggingLoss's own agg name, the scalar train()'s history
    tracks)."""
    if loss_name(training_loss) in MAXIMIZE_METRICS:
        raise ValueError(
            f"training_loss {training_loss!r} is a maximize-direction "
            "metric; pick a minimize-direction loss"
        )
    lt = tuple(loss_types) if loss_types else (training_loss,)
    logging_loss = LoggingLoss(training_loss=training_loss, loss_types=lt, agg=agg)
    monitor = loss_name(lt[0])
    sign = -1.0 if best_direction(monitor) == "max" else 1.0
    agg_key = logging_loss.agg_name

    def scalars(metrics: Mapping[str, Mapping[str, Any]]):
        return {k: v[agg_key] for k, v in metrics.items()}

    return logging_loss, monitor, sign, scalars


def _member_count(hyper: Mapping[str, Sequence], seeds) -> int:
    sizes = {len(np.atleast_1d(np.asarray(v))) for v in hyper.values()}
    if seeds is not None:
        sizes.add(len(np.atleast_1d(np.asarray(seeds))))
    sizes.discard(1)
    if len(sizes) > 1:
        raise ValueError(
            f"population member counts disagree: {sorted(sizes)} "
            "(every hyper array and `seeds` must have the same length, "
            "or length 1 to broadcast)"
        )
    return sizes.pop() if sizes else 1


def _pad_epoch_tensors(t: EpochTensors, nb: int, n_samples: int) -> EpochTensors:
    """Pad an EpochTensors' batch axis to ``nb`` with all-zero batches (zero
    weight and masks: exact no-ops through the masked pipeline, the
    semantics of the partial-batch padding)."""
    return EpochTensors(
        x=map_x(lambda a: pad_axis0(a, nb), t.x),
        forcing={k: pad_axis0(v, nb) for k, v in t.forcing.items()},
        y={k: pad_axis0(v, nb) for k, v in t.y.items()},
        mask={k: pad_axis0(v, nb) for k, v in t.mask.items()},
        weight=pad_axis0(t.weight, nb),
        n_samples=n_samples,
    )


def _pad_batch_rows(batch, n: int):
    """Pad a ``((x, forcing), (y, mask))`` eval batch of numpy arrays to
    ``n`` rows with zero-mask rows (metrics unaffected)."""
    def pad(node):
        if isinstance(node, Mapping):
            return {k: pad(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(pad(v) for v in node)
        return pad_axis0(node, n)

    return pad(batch)


# --------------------------------------------------------------------------
# members
# --------------------------------------------------------------------------

def init_member_params(model, seed: int) -> Dict[str, torch.Tensor]:
    """A member's initial parameters, keyed like ``model.named_parameters()``
    on the model's device: the model built again by its own constructor with
    weights drawn from ``torch.Generator().manual_seed(seed)`` (a
    ``MultiSiteHybridModel``'s base first, then its per-site networks)."""
    from ..models.hybrid import MultiNNHybridModel, SingleNNHybridModel, construct_hybrid_model
    from ..parallel.multisite import MultiSiteHybridModel
    from .tune import model_to_kwargs

    g = torch.Generator().manual_seed(int(seed))
    if isinstance(model, MultiSiteHybridModel):
        base = construct_hybrid_model(**model_to_kwargs(model.base), generator=g, device="cpu")
        twin = MultiSiteHybridModel(base, model.n_sites, model.share_nn, generator=g, device="cpu")
    elif isinstance(model, (SingleNNHybridModel, MultiNNHybridModel)):
        twin = construct_hybrid_model(**model_to_kwargs(model), generator=g, device="cpu")
    else:
        raise TypeError(f"population members of a {type(model).__name__} cannot be drawn: "
                        "init_member_params rebuilds hybrid and multi-site models")
    return {k: p.detach().to(model.device) for k, p in twin.named_parameters()}


def _stack(dicts) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([d[k] for d in dicts]).contiguous() for k in dicts[0]}


def _member_specs(optimizer: str, hyper_arr, static_hyper, k: int):
    """Each member's optimizer spec, as the JAX package injects it: the
    static hyperparameters with the member's swept values over them, or the
    rule's defaults (learning rate 0.01) when neither is given."""
    if not hyper_arr and not static_hyper:
        return [optimizer] * k
    return [(optimizer, {**static_hyper, **{h: float(v[i]) for h, v in hyper_arr.items()}})
            for i in range(k)]


def _structure(optimizers):
    """The optimizer whose slots and static options the torch engine keeps
    for every member: sgd keeps its momentum trace when any member has one."""
    for o in optimizers:
        if o.slots:
            return o
    return optimizers[0]


class _Bound(nn.Module):
    """``forward(batch)``: the loss (train mode) or the metrics (eval mode)
    of ``model`` on a batch, for ``torch.func.functional_call``."""

    def __init__(self, model, logging: LoggingLoss):
        super().__init__()
        self.model = model
        self.logging = logging

    def forward(self, batch):
        return compute_loss(self.model, batch, self.logging)


def _prefixed(d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"model.{k}": v for k, v in d.items()}


def _mutates_buffers(model) -> bool:
    """Whether the model's training forward updates buffers in place (a
    trainable input norm's running statistics)."""
    return any(getattr(m, "frozen", True) is False for m in model.modules())


def _map_batch(fn, batch):
    if isinstance(batch, Mapping):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(_map_batch(fn, v) for v in batch)
    return fn(batch)


def _flat_split(tensors: EpochTensors, members: bool):
    """``((x, forcing), (y, mask))`` of an epoch's arrays flattened to rows,
    the members' rows one after another where each has its own (kernel 2's
    member data): a member row index (:func:`member_row_index`) gathers a
    batch from it."""
    def flat(a):
        lead = a.shape[0] * a.shape[1] * a.shape[2] if members else a.shape[0] * a.shape[1]
        return a.reshape((lead,) + tuple(a.shape[3 if members else 2:]))

    return ((map_x(flat, tensors.x), {k: flat(v) for k, v in tensors.forcing.items()}),
            ({k: flat(v) for k, v in tensors.y.items()}, {k: flat(v) for k, v in tensors.mask.items()}))


class _TorchPopulation:
    """The torch engine: ``block(state) -> state`` trains every member
    ``eval_every`` epochs; ``state`` is ``(params, buffers, opt_state)``,
    each stacked ``(K, …)``; ``leaves(state)`` gives the evaluator's
    ``(params, buffers)``. The loop keeps each member's best ``state[0]``."""

    launches = 0  # kernel launches: none

    def __init__(self, model, logging: LoggingLoss, optimizers, *, tensors: EpochTensors,
                 per_member_data: bool, shuffle, eval_every: int, shared_perms: bool, generator,
                 members: int):
        self.model, self.k, self.epochs = model, members, eval_every
        self.opt = _structure(optimizers)
        self.scalars = member_scalars(optimizers, device=model.device)
        self.per_member_data = per_member_data
        self.shuffle, self.shared_perms, self.generator = shuffle, shared_perms, generator
        first = tensors.weight[0] if per_member_data else tensors.weight
        self.nb, self.batch = (int(v) for v in first.shape)
        self.flat = _flat_split(tensors, per_member_data)
        self.bound = _Bound(model, _train_logging(logging, True))
        self.looped = _mutates_buffers(model)
        self._vstep = None

    def init_opt_state(self, params):
        state = self.opt.init(params)
        state["count"] = torch.zeros((self.k,), dtype=torch.int32, device=self.model.device)
        return state

    def _rows(self) -> torch.Tensor:
        from ..ops.fused_epoch import member_row_index

        return member_row_index(self.shuffle, self.epochs, self.nb, self.batch, self.k,
                                self.model.device, per_member_data=self.per_member_data,
                                generator=self.generator, shared_perms=self.shared_perms)

    def _step(self, p, b, o, h, batch):
        """One member's step: the gradient, the update with the member's
        numbers, the batch-validity gate."""
        def loss_of(p_):
            return torch.func.functional_call(self.bound, _prefixed({**p_, **b}), (batch,))

        grads, _ = torch.func.grad_and_value(loss_of)(p)
        valid = sum(m.sum() for m in batch[1][1].values()) > 0
        upd, new_o = self.opt.update(grads, o, p, scalars=h)
        new_p = {k: torch.where(valid, p[k] + upd[k], p[k]) for k in p}
        return new_p, select_state(valid, new_o, o)

    def _looped_step(self, params, buffers, opt_state, batch, shared: bool):
        """Member by member, for a model whose training forward updates its
        buffers in place: each member's buffers are views of the stacked
        ones, written where the batch is valid."""
        new_p, new_o = [], []
        for i in range(self.k):
            p = {k: v[i].detach().requires_grad_(True) for k, v in params.items()}
            b = {k: v[i] for k, v in buffers.items()}
            old_b = {k: v.clone() for k, v in b.items()}
            o = _index_state(opt_state, i)
            h = {k: (v[i] if torch.is_tensor(v) else v) for k, v in self.scalars.items()}
            mb = batch if shared else _map_batch(lambda a: a[i], batch)
            loss = torch.func.functional_call(self.bound, _prefixed({**p, **b}), (mb,))
            names = list(p)
            grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(p[k])) for k, g in zip(names, grads)}
            with torch.no_grad():
                current = {k: v.detach() for k, v in p.items()}
                valid = sum(m.sum() for m in mb[1][1].values()) > 0
                upd, o2 = self.opt.update(grads, o, current, scalars=h)
                new_p.append({k: torch.where(valid, current[k] + upd[k], current[k]) for k in p})
                new_o.append(select_state(valid, o2, o))
                for k, v in b.items():
                    v.copy_(torch.where(valid, v, old_b[k]))
        return _stack(new_p), _stack_state(new_o)

    def block(self, state):
        params, buffers, opt_state = state
        rows = self._rows()
        if self._vstep is None and not self.looped:
            in_h = {k: (0 if torch.is_tensor(v) else None) for k, v in self.scalars.items()}
            self._vstep = {
                shared: torch.func.vmap(self._step, in_dims=(0, 0, 0, in_h, None if shared else 0))
                for shared in (True, False)}
        for e in range(self.epochs):
            idx_e = rows[e] if rows.dim() == 2 else rows[:, e]
            for i in range(self.nb):
                idx = idx_e[..., i * self.batch:(i + 1) * self.batch].long()
                shared = idx.dim() == 1
                batch = _map_batch(lambda a: a[idx], self.flat)
                if self.looped:
                    params, opt_state = self._looped_step(params, buffers, opt_state, batch, shared)
                else:
                    params, opt_state = self._vstep[shared](params, buffers, opt_state,
                                                            self.scalars, batch)
        return params, buffers, opt_state

    def leaves(self, state):
        return state[0], state[1]


def _index_state(opt_state, i):
    return {k: (_index_state(v, i) if isinstance(v, dict) else v[i]) for k, v in opt_state.items()}


def _stack_state(states):
    first = states[0]
    return {k: (_stack_state([s[k] for s in states]) if isinstance(first[k], dict)
                else torch.stack([s[k] for s in states])) for k in first}


class _FusedPopulation:
    """A fused kernel's member axis as the loop drives it (kernel 2's
    :class:`FusedEpoch`, kernel 3's :class:`FusedWideEpoch`, kernel 4's
    :class:`FusedLSTMEpoch` or kernel 5's :class:`FusedMultisiteEpoch`):
    ``block(state)`` is one launch (launcher call) for every member;
    ``state`` is ``(packed, opt_state)``, each with the member axis in
    front, turned into the evaluator's leaves by views (``leaves``). The
    loop keeps each member's best ``state[0]``."""

    def __init__(self, fn, model, base_buffers, *, tensors, per_member_data: bool, specs,
                 shared_perms: bool, generator, members: int):
        from ..ops.fused_epoch import member_opt_rows

        self.fn, self.plan, self.k = fn, fn.plan, members
        self.data = fn.member_data(tensors)
        self.per_member_data, self.specs = per_member_data, specs
        # made before the loop: a CUDA tensor made from host data is a blocking copy
        self.member_opt = (None if specs is None
                           else member_opt_rows(self.plan, specs, self.data.x.device))
        self.shared_perms, self.generator = shared_perms, generator
        self.base_buffers = base_buffers
        self.norm_names = _norm_buffer_names(model)
        self.launches = 0  # on CPU tensors a block runs the plain version

    def pack(self, params, buffers):
        return _pack_members(self.plan, self.norm_names, params, buffers)

    def block(self, state):
        packed, opt_state = state
        rows = self.fn.member_rows(self.data, self.k, per_member_data=self.per_member_data,
                                   generator=self.generator, shared_perms=self.shared_perms)
        packed, opt_state, _ = self.fn.members(packed, opt_state, self.data, rows, specs=self.specs,
                                               member_opt=self.member_opt)
        if self.data.x.device.type == "cuda":
            self.launches += 1
        return packed, opt_state

    def leaves(self, state):
        packed = state[0]
        params = {name: packed.params[:, off:off + math.prod(shape)].reshape((self.k,) + shape)
                  for name, off, shape in self.plan.segments}
        buffers = dict(self.base_buffers)
        col = 0
        f = packed.bn.shape[1] // 2
        for m, v in self.norm_names:
            width = buffers[m].shape[1]
            buffers[m] = packed.bn[:, col:col + width]
            buffers[v] = packed.bn[:, f + col:f + col + width]
            col += width
        return params, buffers


def _pack_members(plan, norm_names, params, buffers):
    """Stacked leaves in the kernels' packed layout: ``FusedParams`` of ``(K,
    n_params)`` parameters and ``(K, 2 F)`` norm statistics. A multi-site
    model's row is its shared leaves, then each global's ``S`` per-site
    values (its ``(K, S, 1)`` leaf), as kernel 5 packs them."""
    from ..ops.fused_epoch import FusedParams

    k = next(iter(params.values())).shape[0]
    p = torch.cat([params[name].reshape(k, -1) for name, _, _ in plan.segments], dim=1)
    if norm_names:
        bn = torch.cat([buffers[m] for m, _ in norm_names] + [buffers[v] for _, v in norm_names],
                       dim=1)
    else:
        bn = p.new_zeros((k, 0))
    return FusedParams(p.float().contiguous(), bn.float().contiguous())


def _norm_buffer_names(model):
    """``[(mean name, var name)]`` of every network's input norm, in
    kernel 2's packed order."""
    from ..ops.fused_forward import model_branches

    return [(f"{prefix}.norm.mean", f"{prefix}.norm.var")
            for prefix, net in model_branches(model) if getattr(net, "norm", None) is not None]


def _where_tree(cond, new, old):
    """``torch.where`` by member over a FusedParams or a dict of stacked tensors."""
    def sel(a, b):
        return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    if isinstance(new, dict):
        return {k: sel(new[k], old[k]) for k in new}
    return type(new)(*(sel(a, b) for a, b in zip(new, old)))


def _make_evaluator(model, logging: LoggingLoss, scalars_fn, per_member_data: bool):
    """``evaluate(params, buffers) -> (train metrics, val metrics)``, each
    ``{metric: (K,)}``, the dual evaluator under ``vmap``."""
    bound = _Bound(model, _train_logging(logging, False))

    def one(p, b, tr, va):
        def metrics(batch):
            m, _ = torch.func.functional_call(bound, _prefixed({**p, **b}), (batch,))
            return scalars_fn(m)

        return metrics(tr), metrics(va)

    data_dim = 0 if per_member_data else None
    return torch.func.vmap(one, in_dims=(0, 0, data_dim, data_dim))


def _run_population(engine, evaluate, monitor: str, sign: float, k: int, *, nepochs: int,
                    eval_every: int, state, tr_batch, va_batch, device):
    """The population loop: blocks of ``eval_every`` epochs, each followed
    by the dual evaluation, the history rows into device buffers and the
    best score, epoch and kept state of every member by ``torch.where``.
    Nothing is read back before the final fetch."""
    n_evals = int(nepochs) // int(eval_every)
    if n_evals < 1:
        raise ValueError(
            f"nepochs={nepochs} < eval_every={eval_every}: no eval block "
            "fits the budget (train() would run zero evaluated epochs too)"
        )
    with deferred._sync_debug(device), torch.no_grad():
        _, m_va0 = evaluate(*engine.leaves(state), tr_batch, va_batch)
        best_score = sign * m_va0[monitor]
        best_kept = state[0]
        best_ep = torch.zeros((k,), dtype=torch.int32, device=device)
        h_tr = h_va = None
        for i in range(n_evals):
            with torch.enable_grad():
                state = engine.block(state)
            m_tr, m_va = evaluate(*engine.leaves(state), tr_batch, va_batch)
            if h_tr is None:
                h_tr = {m: torch.empty((n_evals, k), dtype=v.dtype, device=device)
                        for m, v in m_tr.items()}
                h_va = {m: torch.empty((n_evals, k), dtype=v.dtype, device=device)
                        for m, v in m_va.items()}
            for m, v in m_tr.items():
                h_tr[m][i] = v
            for m, v in m_va.items():
                h_va[m][i] = v
            score = sign * m_va[monitor]
            better = score < best_score
            best_score = torch.where(better, score, best_score)
            best_ep = torch.where(better, (i + 1) * int(eval_every), best_ep)
            best_kept = _where_tree(better, state[0], best_kept)
    final_params, final_buffers = engine.leaves(state)
    best_params, _ = engine.leaves((best_kept,) + tuple(state[1:]))

    def host(d):
        return {name: v.detach().cpu().clone() for name, v in d.items()}

    return dict(
        params=host(final_params), best_params=host(best_params), state=host(final_buffers),
        best_losses=(sign * best_score).cpu().numpy(), best_epochs=best_ep.cpu().numpy(),
        train_history={m: v.cpu().numpy() for m, v in h_tr.items()},
        val_history={m: v.cpu().numpy() for m, v in h_va.items()},
        kernel_launches=engine.launches,
    )


def _assemble_results(hyper_arr, seeds_arr, monitor, sign, eval_every, out, *, epoch_path,
                      engine_reason) -> PopulationResults:
    best_losses = out["best_losses"]
    n_evals = next(iter(out["val_history"].values())).shape[0]
    best_i = int(np.argmax(best_losses) if sign < 0 else np.argmin(best_losses))
    log.info(
        "population: %d members, %d epochs (eval every %d); best member %d "
        "(%s) with val %s=%.6g at epoch %d",
        len(best_losses), n_evals * eval_every, eval_every, best_i,
        {k: float(v[best_i]) for k, v in hyper_arr.items()},
        monitor, best_losses[best_i], int(out["best_epochs"][best_i]),
    )
    return PopulationResults(
        hyper=hyper_arr, seeds=seeds_arr, params=out["params"], best_params=out["best_params"],
        state=out["state"], best_losses=best_losses, best_epochs=out["best_epochs"],
        train_history=out["train_history"], val_history=out["val_history"],
        epochs=np.arange(1, n_evals + 1) * int(eval_every), best_member=best_i, monitor=monitor,
        epoch_path=epoch_path, engine_reason=engine_reason,
        kernel_launches=out["kernel_launches"],
    )


# --------------------------------------------------------------------------
# engine choice: kernel 2's member axis behind its gate and self-check
# --------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    """Equal bits (NaN payloads too) of two float32 or int32 tensors."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def member_selfcheck(fn, packed, opt_state, tensors, *, specs, per_member_data: bool,
                     shared_perms: bool) -> Optional[str]:
    """The member axis held against itself once per configuration: on the
    first 2 batches, K = 3 members in one launch (a sweep: its first and last
    members' specs and a duplicate of the first; an ensemble or folds: two
    identical members, the first's parameters and data, and the second's).
    The duplicate must give its twin's bits, and every member the bits of a
    launch of it alone (K = 1, its spec in the kernel's shared struct, its
    row index and data), on parameters, statistics, slots, step count and
    loss. Returns None, or what differed. Build and launch failures raise.
    ``fn`` is kernel 2's :class:`FusedEpoch`, kernel 4's
    :class:`FusedLSTMEpoch` or kernel 5's :class:`FusedMultisiteEpoch` (an
    ensemble's members over shared sites); :meth:`alone` launches a member
    alone."""
    from ..ops.fused_epoch import FusedParams, _head
    from ..ops.fused_multisite import FusedMultisiteEpoch

    if per_member_data:
        heads = [_head(t, 2) for t in tensors[:2]]
        data = fn.member_data([heads[0], heads[0], heads[1]])
    else:
        data = fn.member_data(_head(tensors, 2))
    if specs is not None:  # a sweep: the extremes and a duplicate of the first
        trio_specs, pick, twin = [specs[0], specs[-1], specs[0]], [0, 0, 0], 2
    else:  # two identical members and a third
        trio_specs, pick, twin = None, [0, 0, min(1, packed.params.shape[0] - 1)], 1
    trio = FusedParams(packed.params[pick].contiguous(), packed.bn[pick].contiguous())
    trio_opt = {k: v[pick].contiguous() for k, v in opt_state.items()}
    gen = torch.Generator(device=data.x.device).manual_seed(0)
    shape_only = EpochTensors(x=None, forcing={}, y={}, mask={}, n_samples=0,
                              weight=torch.empty((data.n_batches, data.batch),
                                                 device=data.x.device))
    perms = perms_for_epochs(fn.shuffle, shape_only, fn.epochs, generator=gen)
    if perms is not None and not shared_perms:
        second = perms_for_epochs(fn.shuffle, shape_only, fn.epochs, generator=gen)
        # the duplicate reads its twin's rows, the other member its own
        perms = torch.stack([perms, perms, second] if twin == 1 else [perms, second, perms])
    rows = fn.member_rows(data, 3, per_member_data=per_member_data, perms=perms)
    got = fn.members(trio, trio_opt, data, rows, specs=trio_specs)

    def fields(out, i):
        p, o, loss = out
        return {"params": p.params[i], "bn": p.bn[i], **{k: v[i] for k, v in o.items()},
                "loss": loss[i].reshape(1)}

    for name, a in fields(got, 0).items():
        if not _bits_equal(a, fields(got, twin)[name]):
            return f"the duplicate member differs from its twin in {name}"
    # a row index of its own for every member: kernel 2's (K, E, n), kernel 5's (K, E, nb, batch)
    own = rows.dim() == (4 if isinstance(fn, FusedMultisiteEpoch) else 3)
    for i in range(3):
        alone = fn.alone(FusedParams(trio.params[i], trio.bn[i]),
                         {k: v[i] for k, v in trio_opt.items()}, data, rows[i] if own else rows,
                         None if trio_specs is None else trio_specs[i])
        want = {"params": alone[0].params, "bn": alone[0].bn, **alone[1], "loss": alone[2]}
        for name, a in fields(got, i).items():
            if not _bits_equal(a, want[name]):
                return f"member {i} differs in {name} from a launch of it alone"
    return None


def _verdict_key(engine: str, fn, specs, per_member_data, shared_perms, batch):
    """The memo key of a verdict: the engine (the kernel whose member axis
    runs) and everything of the configuration its checks saw."""
    plan = fn.plan
    form = getattr(plan.form, "header_hash", None) or getattr(plan.form, "form_id", None)
    loss_form = getattr(plan.loss_form, "header", None)
    extremes = None if specs is None else (repr(specs[0]), repr(specs[-1]))
    return (engine, plan.args_bytes, getattr(plan, "n_sites", 0), form, loss_form, extremes,
            per_member_data, shared_perms, fn.shuffle, fn.epochs, batch, str(plan.consts.device))


# the fused engines with a member axis, by the epoch path train() gives their models
_MEMBER_AXES = {"cuda_fused_epoch": "kernel 2", "cuda_fused_wide": "kernel 3",
                "cuda_fused_lstm": "kernel 4", "cuda_fused_multisite": "kernel 5"}


def _select_engine(model, params0, buffers0, specs, logging: LoggingLoss, tensors, gate_tensors,
                   *, use_kernel, eval_every: int, shuffle, per_member_data: bool,
                   shared_perms: bool, sweep: bool):
    """``(fused epoch or None, reason)``: kernel 2's member axis (a
    :class:`FusedEpoch`), kernel 3's (a :class:`FusedWideEpoch`), kernel 4's
    (a :class:`FusedLSTMEpoch`) or kernel 5's (a :class:`FusedMultisiteEpoch`),
    or why the torch engine runs the
    population (the JAX package's wording where it has it). ``params0`` /
    ``buffers0``: the stacked initial leaves (member 0's take the gate)."""
    from ..ops.fused_epoch import fused_engine, fused_exactness_check, optimizer_reason

    if use_kernel not in ("auto", None) and use_kernel is not True and use_kernel is not False:
        use_kernel = bool(use_kernel)
    if use_kernel is False:
        return None, "use_kernel disabled (use_kernel=False)"
    device = model.device
    if use_kernel is not True and device.type != "cuda":
        return None, (f"the model is on {device.type!r}, not cuda (use_kernel=True overrides)")
    engine = fused_engine(model, gate_tensors)
    if engine.epoch_path not in _MEMBER_AXES:
        return None, (f"the model goes to {engine.epoch_path}, whose member axis is not ported "
                      "yet (ROADMAP.md, queue B, item 5): the torch engine runs the population")
    multisite = engine.epoch_path == "cuda_fused_multisite"
    if multisite and per_member_data:
        return None, ("multi-site cross-validation runs the torch engine: its folds re-index the "
                      "sites, so the JAX package keeps it off the multi-site kernel too")
    if multisite and sweep:
        return None, ("a sweep of a multi-site model runs the torch engine: the JAX package's "
                      "sweep engine streams per-member optimizer numbers into kernel 2's "
                      "single-series kernel only")
    if sweep:
        bad = [s for s in specs if optimizer_reason(s) is not None]
        if bad:
            return None, ("a sweep member's hyperparameters fall outside the fused kernel "
                          f"envelope: {optimizer_reason(bad[0])}")
    spec0 = specs[0] if specs is not None else None
    args = (model, spec0, logging, gate_tensors)
    reason = engine.unsupported_reason(*args, shuffle=shuffle)
    if reason is not None:
        if engine.unsupported_reason(*args, shuffle=False) is None:
            return None, engine.shuffle_refusal.format(shuffle)
        return None, ("model/optimizer/loss outside the fused-kernel envelope "
                      f"({engine.envelope}): {reason}")
    if engine.epoch_path == "cuda_fused_wide":  # every member's workspace on the card at once
        from ..ops.fused_wide import fused_wide_unsupported_reason

        k = next(iter(params0.values())).shape[0]
        reason = fused_wide_unsupported_reason(*args, members=k)
        if reason is not None:
            return None, f"the population does not fit kernel 3's member axis: {reason}"
    fn = engine.make_epoch(model, spec0, logging, shuffle=shuffle, epochs_per_call=eval_every)
    key = _verdict_key(engine.epoch_path, fn, specs if sweep else None, per_member_data,
                       shared_perms, int(gate_tensors.weight.shape[1]))
    if key not in _VERDICTS:
        twin = copy.deepcopy(model)
        with torch.no_grad():
            for name, t in twin.named_parameters():
                t.copy_(params0[name][0])
            for name, t in twin.named_buffers():
                t.copy_(buffers0[name][0])
        ok, gdiff = fused_exactness_check(twin, spec0, logging, gate_tensors,
                                          epochs_per_call=eval_every, shuffle=shuffle)
        if not ok:
            _VERDICTS[key] = (False, f"runtime exactness gate FAILED (max grad diff {gdiff:.2e})")
        else:
            packed = _pack_members(fn.plan, _norm_buffer_names(model), params0, buffers0)
            opt0 = _stacked_opt_state(packed, spec0, packed.params.shape[0])
            failed = member_selfcheck(fn, packed, opt0, tensors, specs=specs if sweep else None,
                                      per_member_data=per_member_data, shared_perms=shared_perms)
            _VERDICTS[key] = ((False, f"member self-check failed: {failed}") if failed else
                              (True, f"exactness gate (max grad diff {gdiff:.2e}) + member "
                                     "self-check passed"))
    ok, why = _VERDICTS[key]
    kernel = _MEMBER_AXES[engine.epoch_path]
    if not ok and use_kernel is True:
        raise RuntimeError(f"use_kernel=True, but {kernel}'s member axis was refused: {why}")
    if not ok:
        log.warning("population: %s's member axis refused (%s); the torch engine runs", kernel, why)
        return None, why
    # the JAX package's wording (easyhybrid_tpu/training/population.py:280-283)
    return fn, ("multisite kernel: " if multisite else "") + why


def _stacked_opt_state(packed, spec, k: int):
    """Kernel 2's zero opt state for every member, ``t`` ``(K, 1)``."""
    from ..ops.fused_epoch import init_fused_opt_state

    state = init_fused_opt_state(type(packed)(packed.params[0], packed.bn[0]), spec)
    return {name: (v.expand((k,) + tuple(v.shape)).contiguous()) for name, v in state.items()}


def _full_batch_host(data: HybridData):
    """The whole split as one ``((x, forcing), (y, mask))`` batch of numpy arrays."""
    t = build_epoch_tensors(data, None)
    return ((map_x(lambda a: np.asarray(a[0]), t.x), {k: np.asarray(v[0]) for k, v in t.forcing.items()}),
            ({k: np.asarray(v[0]) for k, v in t.y.items()}, {k: np.asarray(v[0]) for k, v in t.mask.items()}))


def _batch_to(batch, device):
    return _map_batch(lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device), batch)


def _stack_batches(batches):
    first = batches[0]
    if isinstance(first, Mapping):
        return {k: _stack_batches([b[k] for b in batches]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack_batches([b[i] for b in batches]) for i in range(len(first)))
    return np.stack(batches)


def _stacked_epoch_tensors(ts) -> EpochTensors:
    """Folds' epoch tensors (padded to one shape) with the member axis in front."""
    return EpochTensors(
        x=({k: np.stack([np.asarray(t.x[k]) for t in ts]) for k in ts[0].x}
           if isinstance(ts[0].x, Mapping) else np.stack([np.asarray(t.x) for t in ts])),
        forcing={k: np.stack([np.asarray(t.forcing[k]) for t in ts]) for k in ts[0].forcing},
        y={k: np.stack([np.asarray(t.y[k]) for t in ts]) for k in ts[0].y},
        mask={k: np.stack([np.asarray(t.mask[k]) for t in ts]) for k in ts[0].mask},
        weight=np.stack([np.asarray(t.weight) for t in ts]),
        n_samples=ts[0].n_samples,
    )


def _run(template, logging, monitor, sign, scalars_fn, k, *, fused, specs, sweep, params0,
         buffers0, train_tensors, fold_tensors, per_member_data, shared_perms, shuffle, nepochs,
         eval_every, seed, tr_batch, va_batch):
    """Run the chosen engine over the population; returns the fetched results.
    ``specs``: every member's optimizer spec; the kernel reads them as member
    rows only in a ``sweep`` (else its plan's, the shared one)."""
    device = template.device
    generator = torch.Generator(device=device).manual_seed(int(seed))
    if fused is not None:
        engine = _FusedPopulation(fused, template, buffers0, tensors=fold_tensors or train_tensors,
                                  per_member_data=per_member_data,
                                  specs=specs if sweep else None, shared_perms=shared_perms,
                                  generator=generator, members=k)
        packed = engine.pack(params0, buffers0)
        state = (packed, _stacked_opt_state(packed, specs[0], k))
    else:
        optimizers = [resolve_optimizer(s) for s in specs]
        engine = _TorchPopulation(template, logging, optimizers, tensors=train_tensors,
                                  per_member_data=per_member_data, shuffle=shuffle,
                                  eval_every=eval_every, shared_perms=shared_perms,
                                  generator=generator, members=k)
        params = {n: v.clone() for n, v in params0.items()}
        buffers = {n: v.clone() for n, v in buffers0.items()}
        state = (params, buffers, engine.init_opt_state(params))
    evaluate = _make_evaluator(template, logging, scalars_fn, per_member_data)
    return _run_population(engine, evaluate, monitor, sign, k, nepochs=nepochs,
                           eval_every=eval_every, state=state, tr_batch=tr_batch,
                           va_batch=va_batch, device=device)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (members sharded over several devices) is not ported to easyhybrid_tpu_torch "
            "yet (ROADMAP.md, queue A, item 15)")


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPT_DEFAULTS:
        parse_opt_spec(optimizer)  # NotImplementedError for a rule the port lacks
        raise ValueError(f"unknown optimizer {optimizer!r}; known: {sorted(OPT_DEFAULTS)}")


def population_train(
    model,
    data,
    *,
    hyper: Optional[Mapping[str, Sequence[float]]] = None,
    seeds: Optional[Sequence[int]] = None,
    optimizer: str = "adam",
    static_hyper: Optional[Mapping[str, Any]] = None,
    nepochs: int = 100,
    batchsize: int = 32,
    eval_every: int = 1,
    training_loss: Any = "mse",
    loss_types: Optional[Sequence[Any]] = None,
    agg: Any = "sum",
    shuffle_each_epoch: bool = True,
    seed: int = 42,
    split_data_at: float = 0.8,
    split_by_id=None,
    folds=None,
    val_fold: Optional[int] = None,
    shuffleobs: bool = False,
    sequence_kwargs: Optional[dict] = None,
    data_seed: Optional[int] = None,
    mesh=None,
    use_kernel: Any = "auto",
) -> PopulationResults:
    """Train a population of K members of ``model``.

    ``hyper`` maps optimizer hyperparameters to per-member values (e.g.
    ``{"learning_rate": [1e-3, 3e-3, 1e-2]}``); ``seeds`` gives per-member
    init seeds (a seed ensemble); omitted, every member starts from the same
    ``seed`` init. ``optimizer`` is a rule name; ``static_hyper`` passes
    hyperparameters that are not swept; with neither ``hyper`` nor
    ``static_hyper`` the rule's defaults apply (learning rate 0.01, as in
    ``train()``). Exactly ``(nepochs // eval_every) * eval_every`` epochs
    run. ``use_kernel`` chooses the engine as ``train()``'s does (see the
    module docstring). ``mesh`` is not ported (queue A, item 15). The model
    itself is left as it was.

    Returns :class:`PopulationResults`, with per-member best tracking done
    on the device and one fetch at the end."""
    _check_mesh(mesh)
    hyper = dict(hyper or {})
    static_hyper = dict(static_hyper or {})
    _check_optimizer(optimizer)
    k = _member_count(hyper, seeds)
    hyper_arr = {h: np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (k,)).copy()
                 for h, v in hyper.items()}
    seeds_arr = (np.broadcast_to(np.asarray(seeds, np.int64).reshape(-1), (k,)).copy()
                 if seeds is not None else np.full((k,), int(seed), np.int64))
    logging_loss, monitor, sign, scalars_fn = _monitor_setup(training_loss, loss_types, agg)
    specs = _member_specs(optimizer, hyper_arr, static_hyper, k)
    for s in specs:
        parse_opt_spec(s)  # a dict without learning_rate raises as the optax constructor does

    train_data, val_data = split_data(
        data, model, split_data_at=split_data_at, split_by_id=split_by_id, folds=folds,
        val_fold=val_fold, shuffleobs=shuffleobs, sequence_kwargs=sequence_kwargs, seed=data_seed,
    )
    from .train import fit_input_norm

    device = model.device
    template = copy.deepcopy(model)
    fit_input_norm(template, train_data)
    host_tensors = build_epoch_tensors(train_data, batchsize)
    train_tensors = epoch_tensors_to(host_tensors, device)
    tr_batch = _batch_to(_full_batch_host(train_data), device)
    va_batch = _batch_to(_full_batch_host(val_data), device)

    params0 = _stack([init_member_params(template, int(s)) for s in seeds_arr])
    buffers0 = {n: b.detach().expand((k,) + tuple(b.shape)).clone()
                for n, b in template.named_buffers()}
    sweep = any(np.unique(v).size > 1 for v in hyper_arr.values())
    fused, reason = _select_engine(
        template, params0, buffers0, specs, logging_loss, train_tensors, train_tensors,
        use_kernel=use_kernel, eval_every=eval_every, shuffle=shuffle_each_epoch,
        per_member_data=False, shared_perms=seeds is None, sweep=sweep)
    if fused is None:
        log.info("population engine: torch (vmap) — %s", reason)
    out = _run(template, logging_loss, monitor, sign, scalars_fn, k, fused=fused, specs=specs,
               sweep=sweep, params0=params0, buffers0=buffers0, train_tensors=train_tensors,
               fold_tensors=None, per_member_data=False,
               # a pure hyper sweep (uniform seeds): every member sees the same
               # data order, so members differ only by their hyperparameters
               shared_perms=seeds is None, shuffle=shuffle_each_epoch, nepochs=nepochs,
               eval_every=eval_every, seed=seed, tr_batch=tr_batch, va_batch=va_batch)
    return _assemble_results(
        hyper_arr, seeds_arr, monitor, sign, eval_every, out,
        epoch_path="population_vmap_fused" if fused is not None else "population_vmap",
        engine_reason=reason)


def population_cross_validate(
    model,
    data,
    *,
    k: int = 5,
    optimizer: Any = ("adam", 0.01),
    nepochs: int = 100,
    batchsize: int = 32,
    eval_every: int = 1,
    training_loss: Any = "mse",
    loss_types: Optional[Sequence[Any]] = None,
    agg: Any = "sum",
    shuffle_each_epoch: bool = True,
    shuffle_folds: bool = True,
    seed: int = 42,
    sequence_kwargs: Optional[dict] = None,
    data_seed: Optional[int] = None,
    mesh=None,
    use_kernel: Any = "auto",
) -> PopulationResults:
    """K-fold cross-validation as one population: member i is fold i+1, with
    its own epoch tensors and eval batches (folds of unequal size zero-mask
    padded to one shape: exact no-ops), its own input-norm statistics fitted
    on its own training split, and the same init (``seed``). ``optimizer``
    is any spec ``train()`` takes; every fold shares it. ``seeds`` of the
    result holds the fold ids; ``list(best_losses)`` is the CV score vector."""
    from ..utils.folds import make_folds
    from .train import fit_input_norm

    _check_mesh(mesh)
    kk = int(k)
    if kk < 2:
        raise ValueError(
            f"population_cross_validate needs k >= 2, got k={kk} "
            "(k=1 would leave a fold's train split empty)"
        )
    logging_loss, monitor, sign, scalars_fn = _monitor_setup(training_loss, loss_types, agg)
    parse_opt_spec(optimizer)

    # prepare (and window) ONCE, then fold over the prepared samples
    prepared = prepare_data(model, data, drop_missing_rows=(sequence_kwargs is None))
    if sequence_kwargs is not None:
        from ..data.sequences import filter_sequences, split_into_sequences

        defaults = dict(input_window=10, output_window=1, output_shift=1, lead_time=1)
        prepared = filter_sequences(split_into_sequences(prepared, **{**defaults, **sequence_kwargs}))
    n = prepared.n_samples
    fold_ids = make_folds(range(n), k=kk, shuffle=shuffle_folds, seed=data_seed or 0)
    splits = [(prepared.take(np.nonzero(fold_ids != i)[0]), prepared.take(np.nonzero(fold_ids == i)[0]))
              for i in range(1, kk + 1)]
    fold_host = [build_epoch_tensors(tr, batchsize) for tr, _ in splits]
    nb = max(int(np.asarray(t.weight).shape[0]) for t in fold_host)
    ns = max(t.n_samples for t in fold_host)
    fold_host = [_pad_epoch_tensors(t, nb, ns) for t in fold_host]
    device = model.device
    fold_tensors = [epoch_tensors_to(t, device) for t in fold_host]
    stacked = epoch_tensors_to(_stacked_epoch_tensors(fold_host), device)

    tr_full = [_full_batch_host(tr) for tr, _ in splits]
    va_full = [_full_batch_host(va) for _, va in splits]
    n_tr = max(tr.n_samples for tr, _ in splits)
    n_va = max(va.n_samples for _, va in splits)
    tr_batch = _batch_to(_stack_batches([_pad_batch_rows(b, n_tr) for b in tr_full]), device)
    va_batch = _batch_to(_stack_batches([_pad_batch_rows(b, n_va) for b in va_full]), device)

    # the same init every fold; each fold's input norm fitted on its own train split
    template = copy.deepcopy(model)
    init = init_member_params(template, int(seed))
    params0 = {name: v.expand((kk,) + tuple(v.shape)).contiguous() for name, v in init.items()}
    fold_buffers = []
    for tr, _ in splits:
        fit_input_norm(template, tr)
        fold_buffers.append({name: b.detach().clone() for name, b in template.named_buffers()})
    buffers0 = _stack(fold_buffers)
    specs = [optimizer] * kk
    fused, reason = _select_engine(
        template, params0, buffers0, specs, logging_loss, fold_tensors, fold_tensors[0],
        use_kernel=use_kernel, eval_every=eval_every, shuffle=shuffle_each_epoch,
        per_member_data=True, shared_perms=False, sweep=False)
    if fused is None:
        log.info("population CV engine: torch (vmap) — %s", reason)
    out = _run(template, logging_loss, monitor, sign, scalars_fn, kk, fused=fused, specs=specs,
               sweep=False, params0=params0, buffers0=buffers0, train_tensors=stacked,
               fold_tensors=fold_tensors, per_member_data=True, shared_perms=False, shuffle=shuffle_each_epoch,
               nepochs=nepochs, eval_every=eval_every, seed=seed, tr_batch=tr_batch,
               va_batch=va_batch)
    return _assemble_results(
        {}, np.arange(1, kk + 1, dtype=np.int64), monitor, sign, eval_every, out,
        epoch_path="population_vmap_cv_fused" if fused is not None else "population_vmap_cv",
        engine_reason=reason)
