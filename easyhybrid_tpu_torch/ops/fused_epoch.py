"""Fused training epochs: a hand-written CUDA kernel for Hopper (kernel 2).

Counterpart of ``easyhybrid_tpu/ops/fused_epoch.py`` (``make_fused_epoch``
with ``kernel_body``). One launch of ``csrc/fused_epoch.cu`` runs
``epochs_per_call`` epochs × ``num_batches`` SGD steps of a SingleNN MLP
hybrid: the permutation gather, the input norm (trainable BatchNorm with
its running-statistics EMA, static, or none), the MLP forward with the
activation derivatives saved, sigmoid bound scaling, the mechanistic model
in a kernel form with its hand-written partials, the masked mse and its
cotangent, the hand-written backward, the batch-validity gate and the
update by any optax rule the JAX kernel runs (adam, adamw, sgd with or
without momentum, rmsprop, adagrad, lion, adamax, nadam, adadelta, radam,
amsgrad, lamb; :data:`_OPTS`). Parameters, the optimizer's slots, the step
counter and the BatchNorm statistics are read once, kept in shared memory,
and written back once.

A launch is a chain of dependent steps, so the kernel is laid out for
latency, and the plan chooses how per batch size
(:meth:`FusedEpochPlan.geometry`, a pure function): one row a thread with
the whole batch in flight (up to 512 threads a block), a thread-block
cluster of up to 8 blocks over the batch's rows when one block cannot hold
them, the step's rows staged in shared memory by asynchronous copies and the
next step's prefetched, tiles walked serially only for a batch or a model
beyond that. Every sum has a fixed tree shape, so two runs give the same
bits. ``csrc/fused_epoch.cu`` says what each choice is for.

Everything works on one packed layout (:class:`FusedEpochPlan`):

* ``params``: ``[norm scale (F), norm bias (F)]`` when the model has an
  input norm, then per layer ``W`` (``(out, in)`` row-major) and ``b``,
  then the raw globals (G);
* ``bn``: the norm's running ``[mean (F), var (F)]`` (empty without norm);
* ``opt_state``: ``{"m", "v"}`` shaped like ``params`` (and ``"u"`` for
  amsgrad) and the step counter ``"t"`` (int32, ``(1,)``), in the JAX
  kernel's slot conventions (:func:`init_fused_opt_state`);
* ``consts``: neural lower bounds and spans, global lower bounds and
  spans, fixed values.

:func:`fused_epoch_reference` is the same algorithm in plain PyTorch on the
same layout (the permutation gather, the hand-written backward through the
form's partials, the optax update). On CPU tensors the wrapper computes it;
on CUDA tensors it launches the kernel or raises. It never falls back.
:func:`fused_exactness_check` (the port of the JAX gate) holds the kernel
against the torch epoch before ``train()`` trusts it.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..data.loaders import EpochTensors
from ..losses.specs import LoggingLoss, SymbolicLoss
from ..training.epoch import make_train_epoch, perms_for_epochs
from ..training.optimizers import parse_opt_spec, resolve_optimizer
from . import _build
from .fused_forward import (
    MAX_ARGS,
    MAX_FORCING,
    MAX_LAYERS,
    MAX_WIDTH,
    _ACT_IDS,
    _SRC_FORCING,
    _SRC_NEURAL,
    _SRC_SCALAR,
    _WIDTHS,
    _arg_sources,
    _form_of,
    _probe_outputs,
    fused_forward_unsupported_reason,
)

__all__ = [
    "FusedEpoch",
    "FusedEpochPlan",
    "FusedParams",
    "fused_epoch_reference",
    "fused_epoch_unsupported_reason",
    "fused_exactness_check",
    "init_fused_opt_state",
    "launch_fused_epoch",
    "make_fused_epoch",
    "supports_fused_epoch",
]

# caps of the kernel; they must equal the EH_* defines of csrc/fused_epoch.cu
MAX_TARGETS = 4
MAX_SMEM_BYTES = 227 * 1024
_TILE_ROWS = (128, 64, 32)
# threads a block of kernel 2 may have, by the kernel's width (EHE_MAX_THREADS
# in csrc/fused_epoch.cu), and the largest thread-block cluster it is given
_MAX_THREADS = {16: 512, 32: 512, 64: 256}
MAX_CLUSTER = 8
# rows a block takes while the cluster has room for more blocks: at the main
# shape two warps a scheduler on two multiprocessors ran a step faster than
# four on one
_BLOCK_ROWS = 256
_NORM_NONE, _NORM_STATIC, _NORM_TRAIN = 0, 1, 2
# the rules of the training kernels, by their id in csrc/eh_device.cuh (OPT_*)
_OPTS = {"sgd": 0, "adam": 1, "adamw": 2, "rmsprop": 3, "adagrad": 4, "lion": 5, "adamax": 6,
         "nadam": 7, "adadelta": 8, "radam": 9, "amsgrad": 10, "lamb": 11}
MAX_LEAVES = 40  # EH_MAX_LEAVES: leaves of a packed vector lamb takes its norms over
SHUFFLES = (True, False, "batches")


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

def _loss_name(training_loss):
    if isinstance(training_loss, SymbolicLoss):
        return training_loss.name
    return training_loss if isinstance(training_loss, str) else None


def _layout_sizes(model) -> Tuple[int, int]:
    """(packed parameter count, residual floats per row)."""
    net = model.nn
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    f = dims[0]
    norm = net.norm is not None
    n_params = (2 * f if norm else 0) + sum(
        dims[i + 1] * (dims[i] + 1) for i in range(len(dims) - 1)
    ) + len(model.global_param_names)
    res = (3 * f if norm else f) + sum(dims[1:]) + sum(dims[1:-1]) + len(
        model.global_param_names)
    return n_params, res


def _envelope_floats(n_params, f, n_consts, g, k, t, tile_rows, res) -> int:
    """The floats that decide the envelope: the state four times over (the
    parameters, two moments, a gradient), the small vectors and a tile of
    ``tile_rows`` residual rows with a pad column."""
    return (4 * n_params + 2 * f + n_consts + 2 * g + k + 3 * f + t + 4 + tile_rows
            + max(res, f + t) * (tile_rows + 1))


def _tile_rows(model) -> Optional[int]:
    """The envelope's tile: the largest of 128, 64 and 32 residual rows that
    fit beside the state, or None when not even 32 do. It decides which
    models kernel 2 takes (and kernel 3 the others); the rows a block really
    takes at once are chosen per batch by :meth:`FusedEpochPlan.geometry`."""
    n_params, res = _layout_sizes(model)
    f = model.nn.in_dim
    p, g, k = model.nn.out_dim, len(model.global_param_names), len(model.fixed_param_names)
    t = len(model.targets)
    for rows in _TILE_ROWS:
        if 4 * _envelope_floats(n_params, f, 2 * p + 2 * g + k, g, k, t, rows,
                                res) <= MAX_SMEM_BYTES:
            return rows
    return None


_UNIT_TABLE = 128  # gradient units the kernel describes once a launch, 8 ints each


def gradient_units(dims, has_norm: bool, n_globals: int) -> int:
    """Units the kernel cuts a step's gradient sum into (``ehe_n_units`` in
    csrc/fused_epoch.cu): every layer's 4 x 4 weight blocks and, per four
    outputs, a bias block; the norm's scales one by one and its biases by
    four; the globals by four."""
    def by4(n):
        return -(-n // 4)

    n = sum(by4(dims[i + 1]) * (by4(dims[i]) + 1) for i in range(len(dims) - 1))
    if has_norm:
        n += dims[0] + by4(dims[0])
    return n + by4(n_globals)


def _smem_floats(*, n_padded, n_params, f, p, g, k, t, n_forcing, threads, res, stages,
                 moments_shared, n_unit_table) -> int:
    """Shared-memory floats of one launch of ``threads`` threads;
    ``ehe_smem_floats`` in csrc/fused_epoch.cu computes the same."""
    nw = threads // 32
    cols = f + n_forcing + 2 * t
    return (n_padded + (1 + 2 * moments_shared) * n_params + nw * (1 + t + 2 * f) + 2 * f + (2 * p + 2 * g + k)
            + 2 * g + k + 2 * f + t + 8 + 8 * n_unit_table + threads * (res + stages * cols))


class Geometry(NamedTuple):
    """How one launch of kernel 2 is cut: ``cluster`` blocks of ``threads``
    threads share a batch's rows, ``block_rows`` each; a block takes ``tile``
    rows at once (one a thread) and walks ``tiles`` of them a step; with
    ``stages`` 2 a step's rows are staged in shared memory and the next
    step's prefetched, with 0 they are read in place. The optimizer's slots
    live in shared memory beside the parameters, in pairs: ``moments_shared``
    1 holds m and v, 2 also amsgrad's u (and a pad of the same size); with 0
    the state leaves no room for 32 rows and one block updates them in
    device memory."""

    threads: int
    tile: int
    stages: int
    cluster: int
    block_rows: int
    moments_shared: int = 1

    @property
    def tiles(self) -> int:
        return -(-self.block_rows // self.tile)


def fused_epoch_unsupported_reason(model, optimizer, logging: LoggingLoss,
                                   tensors=None) -> Optional[str]:
    """Why the fused epoch kernel cannot train ``model`` with this
    optimizer and loss, or None when it can.

    The envelope: a SingleNN MLP hybrid in float32 inside the fused
    forward's model envelope, with any of the three input-norm forms;
    ``training_loss="mse"`` with ``agg`` sum or mean and no ``extra_loss``;
    a single-rule optimizer spec the kernels run (:func:`optimizer_reason`);
    parameters, moments and a 32-row tile of residuals within the 227 KB of
    shared memory (:func:`_tile_rows`, the same for every rule). Any batch
    size and any number of epochs per call: the plan picks threads, tile,
    stages and cluster for the batch (:meth:`FusedEpochPlan.geometry`), and
    where the padded parameter rows would push a model near the limit out,
    its optimizer slots stay in device memory instead."""
    del tensors  # every batch size fits: the plan's geometry follows the batch
    reason = fused_forward_unsupported_reason(model, training=True)
    if reason is not None:
        return reason
    if len(model.targets) > MAX_TARGETS:
        return f"{len(model.targets)} targets exceed the kernel's cap of {MAX_TARGETS}"
    reason = training_spec_reason(optimizer, logging, ("mse",))
    if reason is not None:
        return reason
    if _tile_rows(model) is None:
        return ("the packed parameters, moments and a 32-row residual tile exceed "
                f"the kernel's {MAX_SMEM_BYTES // 1024} KB of shared memory")
    return None


def optimizer_reason(optimizer) -> Optional[str]:
    """Why the training kernels cannot run this optimizer spec, or None: they
    run a single rule of :data:`_OPTS` with optax's hyperparameters, as the
    JAX kernel does. ``noisy_sgd``, per-branch dicts and options outside the
    defaults are not ported (ROADMAP queue A, item 6); radam with a
    threshold below 4 stays off the kernel, as the JAX kernel leaves it."""
    try:
        name, hyper = parse_opt_spec(optimizer)
    except (NotImplementedError, ValueError, TypeError) as e:
        return f"optimizer {optimizer!r}: {e}"
    if name not in _OPTS:
        return f"optimizer {name!r} (the kernels run {', '.join(_OPTS)})"
    if name == "radam" and hyper["threshold"] < 4.0:
        return (f"radam with threshold {hyper['threshold']} < 4 (optax's rectified branch takes "
                "the square root of a negative number there; the JAX kernel refuses it too)")
    return None


def training_spec_reason(optimizer, logging: LoggingLoss, losses) -> Optional[str]:
    """Why a training kernel that trains ``losses`` cannot run this loss and
    optimizer, or None: ``agg`` sum or mean, no ``extra_loss``, an optimizer
    the kernels run (:func:`optimizer_reason`)."""
    if _loss_name(logging.training_loss) not in losses:
        return f"training_loss={logging.training_loss!r} (the kernel trains {', '.join(losses)})"
    if logging.agg_name not in ("sum", "mean"):
        return f"agg={logging.agg!r} (the kernel aggregates sum or mean)"
    if logging.extra_loss is not None:
        return "an extra_loss (the kernel adds none)"
    return optimizer_reason(optimizer)


def supports_fused_epoch(model, optimizer, logging: LoggingLoss, tensors=None) -> bool:
    return fused_epoch_unsupported_reason(model, optimizer, logging, tensors) is None


# --------------------------------------------------------------------------
# plan: the packed layout and the kernel's static arguments
# --------------------------------------------------------------------------

class FusedParams(NamedTuple):
    """The trainable parameters and the BatchNorm running statistics in the
    packed layout (see the module docstring)."""

    params: torch.Tensor
    bn: torch.Tensor


class _Optimizer(ctypes.Structure):
    """Mirror of ``struct EhOptimizer`` in csrc/eh_device.cuh, which every
    training kernel's argument struct embeds as ``optimizer``."""

    _fields_ = [
        ("rule", ctypes.c_int),
        ("nesterov", ctypes.c_int),
        ("lr", ctypes.c_float),
        ("b1", ctypes.c_float),
        ("b2", ctypes.c_float),
        ("one_minus_b1", ctypes.c_float),
        ("one_minus_b2", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("eps_root", ctypes.c_float),
        ("weight_decay", ctypes.c_float),
        ("trace_decay", ctypes.c_float),
        ("accumulator0", ctypes.c_float),
        ("threshold", ctypes.c_float),
        ("ro_inf", ctypes.c_float),
        ("rect_den", ctypes.c_float),
        ("n_leaves", ctypes.c_int),
        ("leaf_end", ctypes.c_int * MAX_LEAVES),
    ]


def optimizer_struct(plan) -> _Optimizer:
    """The plan's rule and hyperparameters as the kernels read them, with
    the packed vector's leaves (``plan.segments``) for lamb's norms."""
    h = dict(plan.hyper)
    o = _Optimizer()
    o.rule = _OPTS[plan.opt_name]
    o.lr = h["learning_rate"]
    b1 = h.get("b1", 0.0)
    b2 = h.get("b2", h.get("decay", h.get("rho", 0.0)))  # the second slot's decay
    o.b1, o.b2 = b1, b2
    o.one_minus_b1, o.one_minus_b2 = 1.0 - b1, 1.0 - b2  # rounded once, as optax's
    o.eps, o.eps_root = h.get("eps", 0.0), h.get("eps_root", 0.0)
    o.weight_decay = h.get("weight_decay", 0.0)
    o.trace_decay, o.nesterov = h.get("momentum", 0.0), int(h.get("nesterov", 0.0) != 0.0)
    o.accumulator0 = h.get("initial_accumulator_value", 0.0)
    if plan.opt_name == "radam":
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        o.threshold, o.ro_inf, o.rect_den = h["threshold"], ro_inf, (ro_inf - 4.0) * (ro_inf - 2.0)
    ends = [off + math.prod(shape) for _, off, shape in plan.segments]
    if len(ends) > MAX_LEAVES:
        raise ValueError(f"{len(ends)} parameter leaves exceed the kernels' {MAX_LEAVES}")
    o.n_leaves = len(ends)
    o.leaf_end[: len(ends)] = ends
    return o


class _Args(ctypes.Structure):
    """Mirror of ``struct EhFusedEpochArgs`` in csrc/fused_epoch.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("forcing", ctypes.c_void_p * MAX_FORCING),
        ("y", ctypes.c_void_p * MAX_TARGETS),
        ("mask", ctypes.c_void_p * MAX_TARGETS),
        ("perm", ctypes.c_void_p),
        ("params", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("u", ctypes.c_void_p),
        ("bn", ctypes.c_void_p),
        ("t", ctypes.c_void_p),
        ("consts", ctypes.c_void_p),
        ("loss", ctypes.c_void_p),
        ("n_rows", ctypes.c_int64),
        ("n_epochs", ctypes.c_int),
        ("n_batches", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("acts", ctypes.c_int * MAX_LAYERS),
        ("norm_mode", ctypes.c_int),
        ("norm_eps", ctypes.c_float),
        ("momentum", ctypes.c_float),
        ("one_minus_momentum", ctypes.c_float),
        ("n_params", ctypes.c_int),
        ("p_off_w", ctypes.c_int * MAX_LAYERS),
        ("p_off_b", ctypes.c_int * MAX_LAYERS),
        ("p_off_g", ctypes.c_int),
        ("n_globals", ctypes.c_int),
        ("n_fixed", ctypes.c_int),
        ("scale_nn_outputs", ctypes.c_int),
        ("form", ctypes.c_int),
        ("n_args", ctypes.c_int),
        ("arg_src", ctypes.c_int * MAX_ARGS),
        ("arg_idx", ctypes.c_int * MAX_ARGS),
        ("arg_const", ctypes.c_float * MAX_ARGS),
        ("n_targets", ctypes.c_int),
        ("target_out", ctypes.c_int * MAX_TARGETS),
        ("agg_scale", ctypes.c_float),
        ("optimizer", _Optimizer),
        ("tile_rows", ctypes.c_int),
        ("res_floats", ctypes.c_int),
        ("r_off_xhat", ctypes.c_int),
        ("r_off_d0", ctypes.c_int),
        ("r_off_g", ctypes.c_int),
        ("r_off_h", ctypes.c_int * MAX_LAYERS),
        ("r_off_d", ctypes.c_int * MAX_LAYERS),
        ("r_off_out", ctypes.c_int),
        ("r_off_dsc", ctypes.c_int),
        ("r_off_one", ctypes.c_int),
        ("n_forcing", ctypes.c_int),
        ("n_padded", ctypes.c_int),
        ("pp_off_w", ctypes.c_int * MAX_LAYERS),
        ("pp_off_b", ctypes.c_int * MAX_LAYERS),
        ("pp_off_g", ctypes.c_int),
        ("block_rows", ctypes.c_int),
        ("stages", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("moments_shared", ctypes.c_int),
        ("n_unit_table", ctypes.c_int),
        ("stamps", ctypes.c_void_p),
    ]


class PackedLayout:
    """What every training plan shares: the model's trainable parameters as
    named segments ``(param name, offset, shape)`` of one packed vector, and
    the input norm's running statistics beside it."""

    @property
    def has_norm(self) -> bool:
        return self.norm_mode != _NORM_NONE

    def pack(self, model) -> FusedParams:
        """The model's current parameters and norm statistics, packed."""
        named = dict(model.named_parameters())
        params = torch.cat([named[name].detach().reshape(-1) for name, _, _ in self.segments])
        if self.has_norm:
            bn = torch.cat([model.nn.norm.mean.detach(), model.nn.norm.var.detach()])
        else:
            bn = params.new_zeros((0,))
        return FusedParams(params.float().contiguous(), bn.float().contiguous())

    def unpack(self, packed: FusedParams, model) -> None:
        """Write packed parameters and norm statistics into ``model``."""
        named = dict(model.named_parameters())
        with torch.no_grad():
            for name, offset, shape in self.segments:
                n = math.prod(shape)
                named[name].copy_(packed.params[offset : offset + n].view(shape))
            if self.has_norm:
                f = self.n_features
                model.nn.norm.mean.copy_(packed.bn[:f])
                model.nn.norm.var.copy_(packed.bn[f:])

    def leaves(self, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``param name -> slice`` of a packed parameter-shaped vector."""
        return {name: packed[o : o + math.prod(s)] for name, o, s in self.segments}


def param_offsets(dims, has_norm: bool) -> Dict[str, Any]:
    """Offsets of every layer's weight (``p_w``) and bias (``p_b``) and of
    the first global (``p_g``) in the packed parameter vector."""
    off = 2 * dims[0] if has_norm else 0
    p_w, p_b = [], []
    for i in range(len(dims) - 1):
        p_w.append(off)
        off += dims[i + 1] * dims[i]
        p_b.append(off)
        off += dims[i + 1]
    return dict(p_w=p_w, p_b=p_b, p_g=off)


def padded_offsets(dims, has_norm: bool, n_globals: int) -> Dict[str, Any]:
    """The layout kernel 2 keeps its parameters in: the packed order with
    every weight row padded to a multiple of 4 floats and every weight matrix
    starting on a multiple of 4, so that a row is read 16 bytes at a time.
    Offsets of every layer's weight (``pp_w``) and bias (``pp_b``), of the
    first global (``pp_g``) and the padded size (``n_padded``, a multiple
    of 4)."""
    def up4(n):
        return -(-n // 4) * 4

    off = 2 * dims[0] if has_norm else 0
    pp_w, pp_b = [], []
    for i in range(len(dims) - 1):
        off = up4(off)
        pp_w.append(off)
        off += dims[i + 1] * up4(dims[i])
        pp_b.append(off)
        off += dims[i + 1]
    return dict(pp_w=pp_w, pp_b=pp_b, pp_g=off, n_padded=up4(off + n_globals))


def fill_common_args(a, plan) -> None:
    """Set the fields every training kernel's argument struct has: the norm
    mode, the kernel form and its argument sources, the targets and the
    optimizer's hyperparameters."""
    a.norm_mode = plan.norm_mode
    a.norm_eps = plan.norm_eps
    a.n_globals, a.n_fixed = len(plan.global_names), len(plan.fixed_names)
    a.scale_nn_outputs = int(plan.scale_nn_outputs)
    a.form = plan.form.form_id
    a.n_args = len(plan.arg_sources)
    for i, (src, idx, const) in enumerate(plan.arg_sources):
        a.arg_src[i], a.arg_idx[i], a.arg_const[i] = src, idx, const
    a.n_targets = len(plan.target_names)
    a.target_out[: len(plan.target_out)] = plan.target_out
    a.optimizer = optimizer_struct(plan)


@dataclasses.dataclass(frozen=True)
class FusedEpochPlan(PackedLayout):
    """Static layout of one model's packed parameters, plus what the kernel
    and its plain version read besides them."""

    dims: Tuple[int, ...]
    acts: Tuple[str, ...]
    norm_mode: int
    norm_eps: float
    momentum: float
    scale_nn_outputs: bool
    forcing_names: Tuple[str, ...]
    neural_names: Tuple[str, ...]
    global_names: Tuple[str, ...]
    fixed_names: Tuple[str, ...]
    target_names: Tuple[str, ...]
    target_out: Tuple[int, ...]
    form: Any
    arg_sources: Tuple[Tuple[int, int, float], ...]
    segments: Tuple[Tuple[str, int, Tuple[int, ...]], ...]  # (param name, offset, shape)
    n_params: int
    consts: torch.Tensor
    agg_scale: float
    opt_name: str
    hyper: Tuple[Tuple[str, float], ...]
    width: int
    tile_rows: int  # the envelope's tile: residual rows the first kernels held beside the state
    res_floats: int  # floats a row keeps for the backward
    loss: str = "mse"
    n_sites: int = 0  # a multi-site plan: every global is one (n_sites, 1) leaf
    cluster: int = 0  # kernel 2's cluster size when set (a measurement's), else by the batch

    @property
    def tile_floats(self) -> int:
        """Floats a row has in kernel 2's tile: the backward's residuals,
        the network's outputs, the bound scaling's derivative, and 1."""
        return self.res_floats + 2 * self.dims[-1] + 1

    @property
    def n_unit_table(self) -> int:
        return min(_UNIT_TABLE,
                   gradient_units(self.dims, self.has_norm, len(self.global_names)))

    def smem_bytes(self, threads: int, stages: int, moments_shared: int) -> int:
        """Shared memory of one launch of kernel 2 with ``threads`` threads."""
        return 4 * _smem_floats(
            n_padded=padded_offsets(self.dims, self.has_norm, len(self.global_names))["n_padded"],
            n_params=self.n_params, f=self.dims[0], p=self.dims[-1], g=len(self.global_names),
            k=len(self.fixed_names), t=len(self.target_names),
            n_forcing=len(self.forcing_names), threads=threads, res=self.tile_floats,
            stages=stages, moments_shared=moments_shared, n_unit_table=self.n_unit_table)

    def geometry(self, batch: int) -> Geometry:
        """How kernel 2 cuts a launch over batches of ``batch`` rows: a pure
        function of the plan and the batch. One row a thread; blocks of up to
        ``_BLOCK_ROWS`` rows while the cluster (a power of two up to
        ``MAX_CLUSTER``) has room, then of as many as the width's registers
        and the shared memory beside the state allow; rows staged and
        prefetched where a block holds its rows at once and the two stages
        fit. A batch beyond that walks tiles and reads its rows in place."""
        def fits(threads, stages, shared):
            return self.smem_bytes(threads, stages, shared) <= MAX_SMEM_BYTES

        pairs = 2 if self.opt_name == "amsgrad" else 1  # u needs a second pair
        shared = pairs if fits(32, 0, pairs) else 0
        most = _MAX_THREADS[self.width]
        while most > 32 and not fits(most, 0, shared):
            most -= 32
        if not fits(most, 0, shared):
            raise ValueError("the model's parameters and 32 residual rows exceed the kernel's "
                             f"{MAX_SMEM_BYTES // 1024} KB of shared memory")
        cluster = self.cluster if shared else 1
        if not cluster:
            cluster = 1
            while cluster < MAX_CLUSTER and cluster * min(most, _BLOCK_ROWS) < batch:
                cluster *= 2
        block_rows = -(-batch // cluster)
        threads = min(most, -(-block_rows // 32) * 32)
        stages = 2 if threads >= block_rows and fits(threads, 2, shared) else 0
        return Geometry(threads, threads, stages, cluster, block_rows, shared)

    @property
    def n_features(self) -> int:
        return self.dims[0]

    def offsets(self) -> Dict[str, Any]:
        """Offsets of every parameter segment (``p_*``) and of every residual
        block of a tile row (``r_*``)."""
        dims, f = self.dims, self.dims[0]
        r = 0
        r_xhat = r_d0 = 0
        if self.has_norm:
            r_xhat, r_d0, r = 0, f, 2 * f
        r_h = [r]
        r += f
        r_d = []
        for i in range(1, len(dims)):
            r_d.append(r)
            r += dims[i]
            if i < len(dims) - 1:
                r_h.append(r)
                r += dims[i]
        return dict(**param_offsets(dims, self.has_norm), r_xhat=r_xhat, r_d0=r_d0, r_h=r_h,
                    r_d=r_d, r_g=r)

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernel's static arguments, packed once; each launch fills in
        the pointers and the sizes."""
        a = _Args()
        dims = self.dims
        a.n_layers = len(dims) - 1
        a.dims[: len(dims)] = dims
        a.acts[: len(self.acts)] = [_ACT_IDS[act] for act in self.acts]
        fill_common_args(a, self)
        a.momentum = self.momentum
        a.one_minus_momentum = 1.0 - self.momentum
        a.n_params = self.n_params
        o = self.offsets()
        a.p_off_w[: len(o["p_w"])] = o["p_w"]
        a.p_off_b[: len(o["p_b"])] = o["p_b"]
        a.p_off_g = o["p_g"]
        a.agg_scale = self.agg_scale
        # the backward's residuals, then the network's outputs, the bound scaling's
        # derivative and a feature of ones
        a.res_floats = self.tile_floats
        a.r_off_xhat, a.r_off_d0, a.r_off_g = o["r_xhat"], o["r_d0"], o["r_g"]
        a.r_off_h[: len(o["r_h"])] = o["r_h"]
        a.r_off_d[: len(o["r_d"])] = o["r_d"]
        a.r_off_out, a.r_off_dsc = self.res_floats, self.res_floats + dims[-1]
        a.r_off_one = self.res_floats + 2 * dims[-1]
        a.n_forcing = len(self.forcing_names)
        pp = padded_offsets(dims, self.has_norm, len(self.global_names))
        a.pp_off_w[: len(pp["pp_w"])] = pp["pp_w"]
        a.pp_off_b[: len(pp["pp_b"])] = pp["pp_b"]
        a.pp_off_g, a.n_padded = pp["pp_g"], pp["n_padded"]
        a.n_unit_table = self.n_unit_table
        return bytes(a)


def plan_fused_epoch(model, optimizer, logging: LoggingLoss) -> FusedEpochPlan:
    """Check the envelope and the kernel form (its outputs and partials on
    probe values) and lay out the model's parameters."""
    reason = fused_epoch_unsupported_reason(model, optimizer, logging)
    if reason is not None:
        raise ValueError(f"model not supported by the fused epoch kernel: {reason}")
    return build_plan(model, optimizer, logging, tile_rows=_tile_rows(model))


def shared_plan_fields(model, optimizer, logging: LoggingLoss, names) -> Dict[str, Any]:
    """The fields every training plan has, for a model already found inside
    a training kernel's envelope: the kernel form checked on probe values,
    its argument sources, the bounds and fixed values, the loss and the
    optimizer, and the parameters ``names`` (then the globals) laid out as
    segments of one packed vector."""
    net = model.nn
    form = _form_of(model.mechanistic_model)
    arg_sources, _ = _arg_sources(model, form)
    outputs = _probe_outputs(model, form, arg_sources)
    missing = [t for t in model.targets if t not in outputs]
    if missing:
        raise ValueError(f"targets {missing} are not outputs {list(outputs)} of the kernel form")
    norm_mode = (_NORM_NONE if net.norm is None
                 else _NORM_TRAIN if net.input_batchnorm is True else _NORM_STATIC)
    segments: List[Tuple[str, int, Tuple[int, ...]]] = []
    offset = 0
    named = dict(model.named_parameters())
    names = ((["nn.norm.scale", "nn.norm.bias"] if net.norm is not None else []) + list(names)
             + [f"globals.{g}" for g in model.global_param_names])
    for name in names:
        shape = tuple(named[name].shape)
        segments.append((name, offset, shape))
        offset += math.prod(shape)
    table = model.param_table
    neural, globals_ = model.neural_param_names, model.global_param_names
    consts = [table.lower_of(n) for n in neural] + [
        table.upper_of(n) - table.lower_of(n) for n in neural]
    consts += [table.lower_of(g) for g in globals_] + [
        table.upper_of(g) - table.lower_of(g) for g in globals_]
    consts += [float(model.fixed.as_dict()[f].item()) for f in model.fixed_param_names]
    name, hyper = parse_opt_spec(optimizer)
    return dict(
        norm_mode=norm_mode,
        norm_eps=net.norm.eps if net.norm is not None else 0.0,
        momentum=net.norm.momentum if net.norm is not None else 0.0,
        scale_nn_outputs=bool(model.scale_nn_outputs),
        forcing_names=tuple(model.forcing),
        neural_names=tuple(neural),
        global_names=tuple(globals_),
        fixed_names=tuple(model.fixed_param_names),
        target_names=tuple(model.targets),
        target_out=tuple(outputs.index(t) for t in model.targets),
        form=form,
        arg_sources=tuple(arg_sources),
        segments=tuple(segments),
        n_params=offset,
        consts=torch.tensor(consts, dtype=torch.float32, device=model.device),
        agg_scale=1.0 / len(model.targets) if logging.agg_name == "mean" else 1.0,
        opt_name=name,
        hyper=tuple(sorted(hyper.items())),
        loss=_loss_name(logging.training_loss),
    )


def build_plan(model, optimizer, logging: LoggingLoss, *, tile_rows: int,
               n_sites: int = 0) -> FusedEpochPlan:
    """Lay out the parameters of an MLP hybrid already found inside a
    training kernel's envelope, and check its kernel form on probe values. A
    multi-site model's globals are ``(n_sites, 1)`` leaves, packed after the
    shared parameters like the scalar globals of a single-series model."""
    net = model.nn
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    names = [f"nn.layers.{i}.{leaf}" for i in range(len(net.layers)) for leaf in ("weight", "bias")]
    return FusedEpochPlan(
        dims=dims,
        acts=tuple(layer.activation for layer in net.layers),
        width=next(w for w in _WIDTHS if w >= max(dims)),
        tile_rows=tile_rows,
        res_floats=_layout_sizes(model)[1],
        n_sites=n_sites,
        **shared_plan_fields(model, optimizer, logging, names),
    )


def init_fused_opt_state(packed: FusedParams, optimizer=None) -> Dict[str, torch.Tensor]:
    """Zero slots and step counter for the packed parameters, as the JAX
    kernel's ``init_fused_opt_state``: ``m`` and ``v`` for every rule (a rule
    leaves the slots it does not keep at zero; adagrad's ``v`` sums the
    squares from zero, its initial accumulator added where it is read), and
    ``u`` when ``optimizer`` names amsgrad."""
    p = packed.params
    state = {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
             "t": torch.zeros((1,), dtype=torch.int32, device=p.device)}
    if optimizer is not None and parse_opt_spec(optimizer)[0] == "amsgrad":
        state["u"] = torch.zeros_like(p)
    return state


def opt_slots(opt_state) -> Dict[str, torch.Tensor]:
    """The slot tensors of a fused opt state (``m``, ``v`` and ``u`` when
    present), without the step counter."""
    return {k: opt_state[k] for k in ("m", "v", "u") if k in opt_state}


# --------------------------------------------------------------------------
# data and permutations
# --------------------------------------------------------------------------

class FusedData(NamedTuple):
    """The padded epoch arrays flattened to rows: ``x (n, F)`` and one
    ``(n,)`` column per forcing, target and mask."""

    x: torch.Tensor
    forcing: Tuple[torch.Tensor, ...]
    y: Tuple[torch.Tensor, ...]
    mask: Tuple[torch.Tensor, ...]
    n_batches: int
    batch: int


def fused_data(plan: FusedEpochPlan, tensors: EpochTensors) -> FusedData:
    nb, batch = tensors.weight.shape
    n = nb * batch

    def rows(a):
        return a.reshape(n).contiguous()

    return FusedData(
        x=tensors.x.reshape(n, plan.n_features).contiguous(),
        forcing=tuple(rows(tensors.forcing[f]) for f in plan.forcing_names),
        y=tuple(rows(tensors.y[t]) for t in plan.target_names),
        mask=tuple(rows(tensors.mask[t]) for t in plan.target_names),
        n_batches=int(nb),
        batch=int(batch),
    )


def row_index(shuffle, perms, n_batches: int, batch: int, epochs: int, device) -> torch.Tensor:
    """``(epochs, n)`` int32 row index of every step's rows: a sample
    permutation (shuffle True), batch permutations expanded to rows
    (``"batches"``), or the identity (no shuffle, or ``perms`` None)."""
    n = n_batches * batch
    if perms is None:
        return torch.arange(n, dtype=torch.int32, device=device).expand(epochs, n).contiguous()
    perms = perms.to(device=device, dtype=torch.int64)
    if shuffle == "batches":
        base = torch.arange(batch, device=device)
        perms = (perms[:, :, None] * batch + base).reshape(epochs, n)
    return perms.to(torch.int32).contiguous()


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _act_and_grad(name: str, z):
    """Activation value and derivative, as the kernel computes them."""
    if name == "tanh":
        y = torch.tanh(z)
        return y, 1.0 - y * y
    if name == "relu":
        return torch.where(z < 0, torch.zeros_like(z), z), (z > 0).to(z.dtype)
    if name == "sigmoid":
        s = torch.sigmoid(z)
        return s, s * (1.0 - s)
    if name in ("swish", "silu"):
        s = torch.sigmoid(z)
        return z * s, s + z * (s * (1.0 - s))
    if name == "gelu":
        k = 0.7978845608028654
        th = torch.tanh(k * (z + 0.044715 * z * z * z))
        cdf = 0.5 * (1.0 + th)
        return z * cdf, cdf + z * (0.5 * (1.0 - th * th) * k * (1.0 + 3.0 * 0.044715 * z * z))
    if name == "softplus":
        return (torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z))),
                torch.sigmoid(z))
    if name == "selu":
        a, s = 1.6732632423543772, 1.0507009873554805
        return (s * torch.where(z > 0, z, a * torch.expm1(z)),
                s * torch.where(z > 0, torch.ones_like(z), a * torch.exp(z)))
    if name == "elu":
        return torch.where(z > 0, z, torch.expm1(z)), torch.where(z > 0, torch.ones_like(z), torch.exp(z))
    if name == "leakyrelu":
        return (torch.where(z >= 0, z, 0.01 * z),
                torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, 0.01)))
    return z, torch.ones_like(z)  # identity / linear


class _Forward(NamedTuple):
    """What :func:`reference_forward` keeps for the backward."""

    neural: torch.Tensor    # (rows, P) bound-scaled network outputs
    dneural: torch.Tensor   # their derivative with respect to the raw outputs
    hs: List[torch.Tensor]  # every layer's input
    dacts: List[torch.Tensor]
    xhat: Optional[torch.Tensor]
    new_bn: torch.Tensor


def split_consts(plan, consts):
    """``(neural lo, neural span, global lo, global span, fixed)``."""
    n, g = len(plan.neural_names), len(plan.global_names)
    return (consts[:n], consts[n : 2 * n], consts[2 * n : 2 * n + g],
            consts[2 * n + g : 2 * n + 2 * g], consts[2 * n + 2 * g :])


def reference_forward(plan, p, bn, consts, x) -> _Forward:
    """The input norm, the MLP and the bound scaling on the rows of ``x``,
    as the kernels compute them, with what the backward needs."""
    dims, f = plan.dims, plan.n_features
    o = plan.offsets()
    bsz = x.shape[0]
    new_bn = bn
    xhat = None
    h = x
    if plan.has_norm:
        if plan.norm_mode == _NORM_TRAIN:
            mean = x.sum(0) / bsz
            var = ((x - mean) * (x - mean)).sum(0) / bsz
            mom = plan.momentum
            new_bn = torch.cat([(1.0 - mom) * bn[:f] + mom * mean, (1.0 - mom) * bn[f:] + mom * var])
        else:
            mean, var = bn[:f], bn[f:]
        xhat = (x - mean) * torch.rsqrt(var + plan.norm_eps)
        h = xhat * p[:f] + p[f : 2 * f]
    hs, dacts = [h], []
    for i, act in enumerate(plan.acts):
        w = p[o["p_w"][i] : o["p_b"][i]].view(dims[i + 1], dims[i])
        b = p[o["p_b"][i] : o["p_b"][i] + dims[i + 1]]
        h, d = _act_and_grad(act, h @ w.T + b)
        hs.append(h)
        dacts.append(d)
    nlo, nspan = split_consts(plan, consts)[:2]
    raw = hs[-1]
    if plan.scale_nn_outputs:
        s = torch.sigmoid(raw)
        neural, dneural = nlo + nspan * s, nspan * (s * (1.0 - s))
    else:
        neural, dneural = raw, torch.ones_like(raw)
    return _Forward(neural, dneural, hs, dacts, xhat, new_bn)


def form_args(plan, neural, forcing, scalars):
    """The kernel form's arguments, in its order. ``scalars`` holds the
    scaled globals, then the fixed values; each entry has one element, or
    one per row."""
    bsz = neural.shape[0]
    args = []
    for src, idx, const in plan.arg_sources:
        if src == _SRC_FORCING:
            args.append(forcing[idx])
        elif src == _SRC_NEURAL:
            args.append(neural[:, idx])
        elif src == _SRC_SCALAR:
            args.append(scalars[idx].expand(bsz))
        else:
            args.append(torch.full((bsz,), const, dtype=neural.dtype, device=neural.device))
    return args


def reference_cotangents(plan, neural, parts, cots):
    """Pull the targets' cotangents ``cots`` back through the form's
    partials: ``(dn (rows, P), dg_rows (rows, G))``, the cotangents of the
    scaled neural outputs and, per row, of the scaled globals."""
    bsz, n_glob = neural.shape[0], len(plan.global_names)
    dn = torch.zeros_like(neural)
    dg_rows = torch.zeros((bsz, n_glob), dtype=neural.dtype, device=neural.device)
    for i, (src, idx, _) in enumerate(plan.arg_sources):
        if src not in (_SRC_NEURAL, _SRC_SCALAR) or (src == _SRC_SCALAR and idx >= n_glob):
            continue
        c = torch.zeros((bsz,), dtype=neural.dtype, device=neural.device)
        for j in range(len(plan.target_names)):
            c = c + cots[j] * parts[plan.target_out[j]][i]
        if src == _SRC_NEURAL:
            dn[:, idx] += c
        else:
            dg_rows[:, idx] += c
    return dn, dg_rows


def reference_backward(plan, p, fwd: _Forward, dn) -> List[torch.Tensor]:
    """The hand-written MLP backward: the gradients of the norm's scale and
    bias and of every layer's weight and bias, in packed order."""
    dims = plan.dims
    o = plan.offsets()
    D = dn * fwd.dneural
    layer_grads = []
    for i in range(len(plan.acts) - 1, -1, -1):
        D = D * fwd.dacts[i]
        layer_grads.append((D.T @ fwd.hs[i], D.sum(0)))
        if i > 0 or plan.has_norm:
            w = p[o["p_w"][i] : o["p_b"][i]].view(dims[i + 1], dims[i])
            D = D @ w
    grads = []
    if plan.has_norm:
        grads += [(D * fwd.xhat).sum(0), D.sum(0)]
    for gw, gb in reversed(layer_grads):
        grads += [gw.reshape(-1), gb]
    return grads


def reference_grads(plan, p, bn, consts, x, forcing, y, mask, scale=None):
    """One step's forward and hand-written backward on one batch: returns
    ``(grad, batch_loss, valid, new_bn)`` with ``grad`` packed like ``p``
    and ``new_bn`` the EMA-updated statistics (trainable norm) or ``bn``.
    ``scale`` holds each target's loss scale ``agg_scale / max(Σ mask, 1)``
    where the caller made it before the step; the plan's loss is mse or
    mae."""
    o = plan.offsets()
    bsz = x.shape[0]
    if scale is None:
        scale = [plan.agg_scale / torch.clamp_min(m.sum(), 1.0) for m in mask]
    valid = sum(m.sum() for m in mask) > 0

    fwd = reference_forward(plan, p, bn, consts, x)
    _, _, glo, gspan, fixed = split_consts(plan, consts)
    sg = torch.sigmoid(p[o["p_g"] :])
    scalars = torch.cat([glo + gspan * sg, fixed])
    dglob = gspan * (sg * (1.0 - sg))
    args = form_args(plan, fwd.neural, forcing, scalars)
    outs = plan.form.torch_fn(*args)
    parts = plan.form.partials_fn(*args)

    loss_rows = torch.zeros((bsz,), dtype=x.dtype, device=x.device)
    cots = []
    for j, t in enumerate(plan.target_names):
        diff = (outs[plan.target_out[j]] - y[j]) * mask[j]
        if plan.loss == "mae":
            loss_rows = loss_rows + scale[j] * diff.abs()
            cots.append(scale[j] * torch.sign(diff))
        else:
            loss_rows = loss_rows + scale[j] * diff * diff
            cots.append((2.0 * scale[j]) * diff)
    batch_loss = loss_rows.sum()

    dn, dg_rows = reference_cotangents(plan, fwd.neural, parts, cots)
    grads = reference_backward(plan, p, fwd, dn)
    grads.append(dg_rows.sum(0) * dglob)
    return torch.cat(grads), batch_loss, valid, fwd.new_bn


def _reference_direction(plan, h, p, g, slots, tc):
    """The rule's direction (the update is ``-lr`` times it, times lamb's
    trust ratio) and its new slots, as the JAX kernel's ``make_update_leaf``
    writes them; ``tc`` is the step count after the step, clamped at 1."""
    name = plan.opt_name
    m, v = slots["m"], slots["v"]
    new = dict(slots)
    if name == "sgd":
        mom = h["momentum"]
        if mom == 0.0:
            return g, new
        new["m"] = g + mom * m  # optax.trace
        return (g + mom * new["m"] if h["nesterov"] else new["m"]), new
    if name == "rmsprop":
        new["v"] = h["decay"] * v + (1.0 - h["decay"]) * g * g
        return g / torch.sqrt(new["v"] + h["eps"]), new  # eps inside the root
    if name == "adagrad":  # v sums the squares from zero; the accumulator's start added here
        new["v"] = v + g * g
        acc = new["v"] + h["initial_accumulator_value"]
        inv = torch.where(acc > 0.0, torch.rsqrt(acc + h["eps"]), torch.zeros_like(acc))
        return inv * g, new
    b1 = h.get("b1", 0.0)
    if name == "lion":  # the sign of the mix before the momentum's update
        d = torch.sign((1.0 - b1) * g + b1 * m) + h["weight_decay"] * p
        new["m"] = h["b2"] * m + (1.0 - h["b2"]) * g
        return d, new
    if name == "adadelta":  # v is E[g^2], m is E[dx^2]; weight decay first
        rho, eps = h["rho"], h["eps"]
        ge = g + h["weight_decay"] * p
        new["v"] = rho * v + (1.0 - rho) * ge * ge
        d = (torch.sqrt(m + eps) / torch.sqrt(new["v"] + eps)) * ge
        new["m"] = rho * m + (1.0 - rho) * d * d
        return d, new
    b2, eps = h["b2"], h["eps"]
    c1 = 1.0 - torch.pow(b1, tc)
    if name == "adamax":  # the infinity moment in v
        new["m"] = b1 * m + (1.0 - b1) * g
        new["v"] = torch.maximum(torch.abs(g) + eps, b2 * v)
        return (new["m"] / c1) / torch.where(new["v"] > 0.0, new["v"], torch.ones_like(v)), new
    m_new = (1.0 - b1) * g + b1 * m
    v_new = (1.0 - b2) * (g * g) + b2 * v
    new["m"], new["v"] = m_new, v_new
    c2 = 1.0 - torch.pow(b2, tc)
    eps_root = h.get("eps_root", 0.0)
    if name in ("adam", "adamw"):
        d = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        return (d + h["weight_decay"] * p if name == "adamw" else d), new
    if name == "nadam":  # the momentum corrected at t + 1, the gradient at t
        m_hat = b1 * (m_new / (1.0 - torch.pow(b1, tc + 1.0))) + (1.0 - b1) * (g / c1)
        return m_hat / (torch.sqrt(v_new / c2 + eps_root) + eps), new
    m_hat = m_new / c1
    if name == "radam":
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(b2, tc)
        ro = ro_inf - 2.0 * tc * b2t / (1.0 - b2t)
        rad = (ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)
        rect = torch.sqrt(torch.clamp_min(rad, 0.0)) * m_hat / (
            torch.sqrt(v_new / c2 + eps_root) + eps)
        return torch.where(ro >= h["threshold"], rect, m_hat), new
    if name == "amsgrad":
        new["u"] = torch.maximum(slots["u"], v_new / c2)
        return m_hat / (torch.sqrt(new["u"] + eps_root) + eps), new
    # lamb, before its trust ratio
    return m_hat / (torch.sqrt(v_new / c2 + eps_root) + eps) + h["weight_decay"] * p, new


def _reference_update(plan, p, slots, t, g, valid):
    """The optax formula of the plan's rule on packed vectors in the JAX
    kernel's slot conventions (``slots``: ``m``, ``v`` and amsgrad's ``u``;
    :func:`init_fused_opt_state`), gated by the batch validity; ``t`` is the
    float step count before this step. Lamb's trust ratio is taken per leaf
    (``plan.leaves``), as optax's. Returns ``(p, slots, t)``."""
    h = dict(plan.hyper)
    t_new = t + valid.to(torch.float32)
    d, new = _reference_direction(plan, h, p, g, slots, torch.clamp_min(t_new, 1.0))
    if plan.opt_name == "lamb":
        ratios = []
        for pl, dl in zip(plan.leaves(p).values(), plan.leaves(d).values()):
            pn, dn = torch.linalg.vector_norm(pl), torch.linalg.vector_norm(dl)
            r = torch.where((pn > 0.0) & (dn > 0.0), pn / torch.where(dn > 0.0, dn, 1.0),
                            torch.ones_like(pn))
            ratios.append(r.expand(pl.shape[0]))
        d = torch.cat(ratios) * d
    p_new = p + (-h["learning_rate"] * d)
    return (torch.where(valid, p_new, p),
            {k: torch.where(valid, new[k], slots[k]) for k in slots}, t_new)


def fused_epoch_reference(plan: FusedEpochPlan, packed: FusedParams, opt_state, data: FusedData,
                          rows: torch.Tensor):
    """The plain PyTorch version of the kernel: ``rows.shape[0]`` epochs of
    ``data.n_batches`` steps over the rows ``rows[e, i·B : (i+1)·B]``.
    Returns ``(packed, opt_state, mean_loss)``; the loss is the last epoch's
    mean batch loss (empty batches count 0)."""
    p, bn = packed.params, packed.bn
    slots = opt_slots(opt_state)
    t = opt_state["t"].to(torch.float32)
    consts = plan.consts.to(p.device)
    nb, batch = data.n_batches, data.batch
    epoch_loss = None
    for e in range(rows.shape[0]):
        epoch_loss = torch.zeros((), dtype=p.dtype, device=p.device)
        for i in range(nb):
            idx = rows[e, i * batch : (i + 1) * batch].long()
            g, loss, valid, new_bn = reference_grads(
                plan, p, bn, consts, data.x[idx],
                [c[idx] for c in data.forcing], [c[idx] for c in data.y],
                [c[idx] for c in data.mask],
            )
            p, slots, t = _reference_update(plan, p, slots, t, g, valid)
            bn = torch.where(valid, new_bn, bn)
            epoch_loss = epoch_loss + torch.where(valid, loss, torch.zeros_like(loss))
    new_state = {**slots, "t": t.round().to(torch.int32)}
    return FusedParams(p, bn), new_state, epoch_loss / nb


# --------------------------------------------------------------------------
# kernel launch and the epoch function
# --------------------------------------------------------------------------

def slot_u(plan, opt_state) -> Optional[int]:
    """The address of amsgrad's ``u`` slot for a launch (None for the other
    rules); raises when an amsgrad state lacks it."""
    if plan.opt_name != "amsgrad":
        return None
    if "u" not in opt_state:
        raise ValueError("amsgrad needs the opt state's u slot: "
                         "init_fused_opt_state(packed, optimizer)")
    return opt_state["u"].data_ptr()


def launch_fused_epoch(plan: FusedEpochPlan, packed: FusedParams, opt_state, data: FusedData,
                       rows: torch.Tensor, loss: torch.Tensor, *, lib=None, stamps=None) -> None:
    """Launch the CUDA kernel once over ``rows.shape[0]`` epochs, updating
    ``packed`` and ``opt_state`` in place and writing the mean loss into
    ``loss``; raises if the launch is refused. Counts launches in
    ``launch_fused_epoch.launches``. ``lib`` is a measuring build of the
    kernel (:func:`stage_cycles`) in place of the package's library, and
    ``stamps`` the int64 tensor its stage cycles go to."""
    main_lib = _build.load_library()
    measuring = lib is not None  # not a launch of the package's kernel: not counted
    lib = lib or main_lib
    if lib.eh_fused_epoch_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_epoch_args_size()} != {ctypes.sizeof(_Args)}"
        )
    a = _Args.from_buffer_copy(plan.args_bytes)
    a.x = data.x.data_ptr()
    for i, c in enumerate(data.forcing):
        a.forcing[i] = c.data_ptr()
    for i, (yc, mc) in enumerate(zip(data.y, data.mask)):
        a.y[i], a.mask[i] = yc.data_ptr(), mc.data_ptr()
    a.perm = rows.data_ptr()
    a.params, a.bn = packed.params.data_ptr(), packed.bn.data_ptr()
    a.m, a.v, a.t = opt_state["m"].data_ptr(), opt_state["v"].data_ptr(), opt_state["t"].data_ptr()
    a.u = slot_u(plan, opt_state)
    a.consts = plan.consts.data_ptr()
    a.loss = loss.data_ptr()
    a.n_rows = data.x.shape[0]
    a.n_epochs = rows.shape[0]
    a.n_batches, a.batch = data.n_batches, data.batch
    geometry = plan.geometry(data.batch)
    a.tile_rows, a.stages, a.cluster = geometry.tile, geometry.stages, geometry.cluster
    a.block_rows, a.moments_shared = geometry.block_rows, geometry.moments_shared
    a.stamps = stamps.data_ptr() if stamps is not None else None
    with torch.cuda.device(data.x.device):
        stream = torch.cuda.current_stream(data.x.device).cuda_stream
        rc = lib.eh_fused_epoch(ctypes.byref(a), plan.width, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused epoch kernel launch failed: {main_lib.eh_cuda_error_string(rc).decode()}")
    if not measuring:
        launch_fused_epoch.launches += 1


launch_fused_epoch.launches = 0

# the stamped build's stages; the first four are "gather and statistics"
STAGES = ("wait for the staged rows", "counts and mean", "start the next step's copies",
          "variance", "forward to loss", "backward", "gradient sum", "update")


def stage_cycles(fn: "FusedEpoch", packed: FusedParams, opt_state, tensors: EpochTensors,
                 perms=None) -> Dict[str, int]:
    """One launch of the stamped build of the kernel on CUDA tensors: the
    ``clock64()`` cycles thread 0 of the first block spent in each stage
    (:data:`STAGES`), summed over the launch's steps, and ``"kernel"``, the
    cycles of the whole launch. For measurement only; the result of the
    launch is dropped."""
    plan = fn.plan
    data = fn._make_data(plan, tensors)
    rows = fn.rows(tensors, perms)
    packed = FusedParams(packed.params.clone(), packed.bn.clone())
    opt_state = {k: v.clone() for k, v in opt_state.items()}
    loss = torch.empty((1,), dtype=torch.float32, device=data.x.device)
    stamps = torch.zeros((len(STAGES) + 1,), dtype=torch.int64, device=data.x.device)
    launch_fused_epoch(plan, packed, opt_state, data, rows, loss,
                       lib=_build.measuring_library("fused_epoch.cu", "eh_fused_epoch",
                                                    "-DEHE_STAMPS"),
                       stamps=stamps)
    return dict(zip(STAGES + ("kernel",), stamps.tolist()))


class FusedEpoch:
    """``fn(model_or_packed, opt_state, tensors, perms=None, generator=None)
    -> (model_or_packed, opt_state, mean_loss)``: ``epochs_per_call`` epochs
    in one launch on CUDA tensors, the plain version on CPU tensors.

    ``perms`` are the shuffles (``(E, n)`` sample or ``(E, num_batches)``
    batch permutations, or one of them when E is 1); without them they are
    drawn from ``generator`` (:func:`training.epoch.epoch_permutation`).
    A model is packed before the run and written back after it; packed
    parameters (:class:`FusedParams`) are returned as new tensors.

    A subclass for another kernel names its own plan, data layout, plain
    version and launcher."""

    _make_plan = staticmethod(plan_fused_epoch)
    _make_data = staticmethod(fused_data)
    _reference = staticmethod(fused_epoch_reference)
    _launch = staticmethod(launch_fused_epoch)

    def __init__(self, model, optimizer, logging: LoggingLoss, *, shuffle: Any = True,
                 epochs_per_call: int = 1):
        if shuffle not in SHUFFLES:
            raise ValueError(f"fused epoch supports shuffle=True/False/'batches', got {shuffle!r}")
        self.plan = self._make_plan(model, optimizer, logging)
        self.shuffle = shuffle
        self.epochs = max(1, int(epochs_per_call))

    def rows(self, tensors: EpochTensors, perms=None, generator=None) -> torch.Tensor:
        perms = perms_for_epochs(self.shuffle, tensors, self.epochs, generator=generator, perm=perms)
        nb, batch = tensors.weight.shape
        return row_index(self.shuffle, perms, int(nb), int(batch), self.epochs,
                         tensors.weight.device)

    def __call__(self, model_or_packed, opt_state, tensors: EpochTensors, perms=None,
                 generator=None):
        plan = self.plan
        model = None if isinstance(model_or_packed, FusedParams) else model_or_packed
        packed = plan.pack(model) if model is not None else model_or_packed
        data = self._make_data(plan, tensors)
        rows = self.rows(tensors, perms, generator)
        dev = data.x.device
        for name, t in (("parameters", packed.params), ("moments", opt_state["m"]),
                        ("rows", rows), ("constants", plan.consts)):
            if t.device != dev:
                raise ValueError(f"the {name} are on {t.device}, the data on {dev}")
        if dev.type == "cpu":
            packed, opt_state, loss = self._reference(plan, packed, opt_state, data, rows)
        elif dev.type == "cuda":
            packed = FusedParams(packed.params.clone(), packed.bn.clone())
            opt_state = {k: v.clone() for k, v in opt_state.items()}
            loss = torch.empty((1,), dtype=torch.float32, device=dev)
            self._launch(plan, packed, opt_state, data, rows, loss)
            loss = loss[0]
        else:
            raise ValueError(f"the fused epoch runs on CUDA or CPU tensors; got {dev}")
        if model is not None:
            plan.unpack(packed, model)
            return model, opt_state, loss
        return packed, opt_state, loss

    def reference(self, packed: FusedParams, opt_state, tensors: EpochTensors, perms=None,
                  generator=None):
        """The plain version on the tensors' device (no launch)."""
        return self._reference(self.plan, packed, opt_state, self._make_data(self.plan, tensors),
                               self.rows(tensors, perms, generator))


def make_fused_epoch(model, optimizer, logging: LoggingLoss, *, shuffle: Any = True,
                     epochs_per_call: int = 1) -> FusedEpoch:
    """Build the fused epoch of ``model`` (see :class:`FusedEpoch`); raises if
    the model, optimizer or loss is outside the envelope or the kernel
    form's probe check fails."""
    return FusedEpoch(model, optimizer, logging, shuffle=shuffle, epochs_per_call=epochs_per_call)


# --------------------------------------------------------------------------
# runtime exactness gate
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _full_precision():
    """float32 products without TF32, for both paths of phase A."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _head(tensors: EpochTensors, nb: int) -> EpochTensors:
    return EpochTensors(
        x=tensors.x[:nb], forcing={k: v[:nb] for k, v in tensors.forcing.items()},
        y={k: v[:nb] for k, v in tensors.y.items()},
        mask={k: v[:nb] for k, v in tensors.mask.items()},
        weight=tensors.weight[:nb], n_samples=tensors.n_samples,
    )


class FusedEngine(NamedTuple):
    """One fused training engine as ``train()`` and the gate see it."""

    epoch_path: str  # ``TrainResults.epoch_path`` when it runs
    envelope: str  # the name of its ``supports_*`` function, for ``engine_reason``
    make_epoch: Callable  # returns a callable with a ``plan``, called like :class:`FusedEpoch`
    #: ``(model, optimizer, logging, tensors, *, shuffle)`` -> a sentence or None
    unsupported_reason: Callable
    shuffle_refusal: str  # ``engine_reason`` when only the shuffle mode disqualifies; takes it


def _refusing_other_shuffles(reason_fn):
    """A single-series envelope with the shuffle mode checked beside it."""
    def reason(model, optimizer, logging, tensors=None, *, shuffle=False):
        if shuffle not in SHUFFLES:
            return f"shuffle={shuffle!r} (the kernel takes True, False or 'batches')"
        return reason_fn(model, optimizer, logging, tensors)

    return reason


def fused_engine(model) -> FusedEngine:
    """The fused engine of a model, the one place that tells them apart: the
    multi-site one for a :class:`MultiSiteHybridModel`, the LSTM one for a
    hybrid over an :class:`LSTMNet`, else a single-series MLP one, by size
    alone: kernel 2, whose blocks keep the whole state in shared memory,
    where that holds the model (widths up to 64 and parameters, moments and
    a residual tile within 227 KB), the wide kernel (``ops/fused_wide.py``)
    for any other MLP."""
    from ..models.nn import MLP, LSTMNet
    from ..parallel.multisite import MultiSiteHybridModel

    if isinstance(model, MultiSiteHybridModel):
        from .fused_multisite import fused_multisite_unsupported_reason, make_fused_multisite_epoch

        return FusedEngine(
            "cuda_fused_multisite", "supports_fused_multisite", make_fused_multisite_epoch,
            fused_multisite_unsupported_reason,
            "minibatched multisite with shuffle_each_epoch={!r}: the fused multisite kernel "
            "supports shuffle_each_epoch in (True, False, 'batches')")
    single = "shuffle_each_epoch={!r} outside the fused envelope"
    if isinstance(getattr(model, "nn", None), LSTMNet):
        from .fused_epoch_lstm import fused_epoch_lstm_unsupported_reason, make_fused_lstm_epoch

        return FusedEngine(
            "cuda_fused_lstm", "supports_fused_epoch_lstm", make_fused_lstm_epoch,
            _refusing_other_shuffles(fused_epoch_lstm_unsupported_reason), single)
    if isinstance(getattr(model, "nn", None), MLP) and not _fits_one_block(model):
        from .fused_wide import fused_wide_unsupported_reason, make_fused_wide_epoch

        return FusedEngine(
            "cuda_fused_wide", "supports_fused_wide", make_fused_wide_epoch,
            _refusing_other_shuffles(fused_wide_unsupported_reason), single)
    return FusedEngine("cuda_fused_epoch", "supports_fused_epoch", make_fused_epoch,
                       _refusing_other_shuffles(fused_epoch_unsupported_reason), single)


def _fits_one_block(model) -> bool:
    """Whether kernel 2 can hold an MLP hybrid: its widths within the
    one-block kernels' cap and its state within their shared memory."""
    net = model.nn
    return (max((net.in_dim,) + net.hidden + (net.out_dim,)) <= MAX_WIDTH
            and _tile_rows(model) is not None)


def fused_exactness_check(model, optimizer, logging: LoggingLoss, tensors: EpochTensors, *,
                          n_batches: int = 2, tol: float = 3e-2, epochs_per_call: int = 1,
                          shuffle: Any = False) -> Tuple[bool, float]:
    """Hold the fused epoch (single-series or multi-site, by the model)
    against the torch epoch on the first batches of the actual data before
    trusting it; the model is left as it was. A multi-site model's batches
    are site batches: the sites outside the first ``n_batches`` see no data
    and still take every optimizer step, on both sides.

    **Phase A (gradient content):** both run plain SGD at lr 1e-3 over the
    first ``n_batches`` batches without shuffling, with TF32 off; the
    implied per-leaf gradients ``(p0 - p) / lr`` must agree within ``tol``
    under per-leaf normalisation ``max |Δg| / max(|g_leaf|, 3%·g_max, 1e-6)``
    and the epoch losses within 1%.

    **Phase B (the production variant):** the real optimizer, shuffle mode
    and up to 4 epochs per call on the same batches, with the same injected
    permutations (skipped only where that is phase A's run again: plain sgd,
    one epoch, unshuffled); the loss trajectories must agree within 20% and
    no leaf of more than 4 elements may have more than half its elements
    apart by more than half a learning rate.

    Returns ``(ok, worst relative difference)``. Unlike the JAX gate this
    one does not catch a build or launch error: those raise."""
    lr = 1e-3
    sub = _head(tensors, min(n_batches, int(tensors.weight.shape[0])))
    make_epoch = fused_engine(model).make_epoch
    plan = make_epoch(model, optimizer, logging).plan
    p0 = plan.pack(model)

    def torch_run(spec, sh, epochs, perms):
        twin = copy.deepcopy(model)
        opt = resolve_optimizer(spec)
        fn = make_train_epoch(twin, logging, opt, shuffle=sh, epochs_per_call=epochs)
        _, loss = fn(opt.init(dict(twin.named_parameters())), sub, perm=perms)
        return plan.pack(twin).params, loss

    def fused_run(spec, sh, epochs, perms):
        fn = make_epoch(model, spec, logging, shuffle=sh, epochs_per_call=epochs)
        packed, _, loss = fn(p0, init_fused_opt_state(p0, spec), sub, perms=perms)
        return packed.params, loss

    with _full_precision():
        p_f, loss_f = fused_run(("sgd", lr), False, 1, None)
        p_x, loss_x = torch_run(("sgd", lr), False, 1, None)
    g_leaf = {k: float((a - b).abs().max()) / lr
              for (k, a), b in zip(plan.leaves(p0.params).items(), plan.leaves(p_x).values())}
    gmax = max([1e-6, *g_leaf.values()])
    rel = 0.0
    for (k, a), b in zip(plan.leaves(p_f).items(), plan.leaves(p_x).values()):
        d = float((a - b).abs().max()) / lr
        rel = max(rel, d / max(g_leaf[k], 0.03 * gmax, 1e-6))
    loss_rel = abs(float(loss_f) - float(loss_x)) / (abs(float(loss_x)) + 1e-6)

    name, hyper = parse_opt_spec(optimizer)
    e_gate = max(1, min(int(epochs_per_call), 4))
    frac_bad = ploss_rel = 0.0
    if name != "sgd" or hyper["momentum"] != 0.0 or e_gate > 1 or shuffle is not False:
        gen = torch.Generator(device=sub.weight.device).manual_seed(0)
        perms = perms_for_epochs(shuffle, sub, e_gate, generator=gen)
        pp_f, pl_f = fused_run(optimizer, shuffle, e_gate, perms)
        pp_x, pl_x = torch_run(optimizer, shuffle, e_gate, perms)
        prod_lr = hyper.get("learning_rate", lr)
        for a, b in zip(plan.leaves(pp_f).values(), plan.leaves(pp_x).values()):
            if a.numel() <= 4:
                continue
            frac_bad = max(frac_bad, float(((a - b).abs() > 0.5 * prod_lr).float().mean()))
        ploss_rel = abs(float(pl_f) - float(pl_x)) / (abs(float(pl_x)) + 1e-6)
    ok = (math.isfinite(rel) and rel < tol and loss_rel < 1e-2
          and math.isfinite(frac_bad) and frac_bad <= 0.5
          and math.isfinite(ploss_rel) and ploss_rel < 0.2)
    return bool(ok), max(rel, loss_rel, ploss_rel)
