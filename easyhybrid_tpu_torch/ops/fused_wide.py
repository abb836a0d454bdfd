"""Fused training epochs of a wide MLP hybrid: hand-written CUDA kernels for
Hopper (kernel 3).

Counterpart of the fused epoch of ``easyhybrid_tpu/ops/fused_epoch.py`` for
an MLP hybrid too wide for one block: its batch-chunked half
(``kernel_body_elem``, chosen by ``_pick_batch_chunks`` for the tower
[1024, 512, 256, 128, 64] at batch 1,024) and its unchunked ``kernel_body``
on such a tower (batch 64: the reference's GPU tutorial). What those kernels
compute, with the TPU's chunking stripped: per optimizer step, the
whole-batch gradient of the masked loss (mse, mae, a traced ElementwiseLoss,
nseLoss, rmse, pearsonLoss, kgeLoss or pbkgeLoss) of an MLP hybrid with no,
a static or a trainable input norm, summed in a fixed order over batch
tiles, then one gated update of every parameter and of the norm's running
statistics.

A model this wide does not fit one block's shared memory, so parameters,
moments and the activations live in device memory, and one call of the
launcher of ``csrc/fused_wide.cu`` enqueues every step's kernels of
``epochs_per_call`` epochs × ``num_batches`` batches on the stream with no
host synchronisation in between: under a trainable norm the batch's
statistics and the running statistics' EMA, the row gather with the input
norm, a tiled product per layer forward, a head kernel (bound scaling, the
mechanistic model in its kernel form, the loss and its cotangent; rmse and
the statistic losses first take the batch's prediction moments in passes of
their own), two tiled products per
layer backward, and the optimizer update, which also folds the partial sums
the others left. The layer products are the kernels' own; no library product
is on the path. A layer whose two sides are both at least ``_TC_MIN`` wide
runs its forward, data-gradient and weight-gradient products on the tensor
cores in 3xTF32 (``wgmma`` on operands split into a TF32 value and its TF32
remainder, about float32's accuracy); the edge layers (two inputs, one
output) keep a float32 FMA tile. :func:`wide_geometry` chooses every
product's route, output tile and the pieces its inner dimension is cut into,
from the widths and the batch alone; the launcher checks what it is given.

The JAX kernel's branch view (``kernel_body_elem`` and ``kernel_body`` over
a MultiNN model's branches, ``easyhybrid_tpu/ops/fused_epoch.py:1229-1260``):
one network, or 1 to ``MAX_NETS`` single-output branches, one per neural
parameter, each over its own predictor columns. The kernels take every
branch's layers as one list (a layer's branch beside it); the gather writes
every branch's normed columns side by side, each branch runs its own chain
of products forward and backward, and the head reads each branch's output as
its neural parameter.

The packed layout is kernel 2's (:class:`~.fused_epoch.PackedLayout`,
:func:`~.fused_epoch.branch_layout`): norm scales and biases of every
column, each branch's layers' ``W`` and ``b`` in turn, the raw globals. As in the JAX
package the masked ``1/n`` of each target (nseLoss: ``1 / max(SST, 1e-12)``),
the batch's validity flag and, for the statistic losses, each target's count,
mean and SST depend on the targets alone; they span the whole batch and are
made before the launch (:func:`batch_scales`, :func:`target_moments`), with
the step count after each step.

:func:`fused_wide_reference` is the same algorithm in plain PyTorch. On CPU
tensors the wrapper computes it; on CUDA tensors it launches the kernels or
raises. It never falls back.

The weight-L2 ``extra_loss`` (``fused_epoch.L2Penalty``): its gradient term
in the update, before the rule; its value from the update's sums of squares
of the weights after each step, the next step's before its update.

The member axis (:meth:`FusedWideEpoch.members`, population training): one
launcher call trains K members, each of a step's launches over all of them
(the member a grid dimension), with a workspace, partial sums, state rows,
loss scales, row index and optimizer numbers a member;
:func:`fused_wide_members_reference` is its plain version. A member's bits
are those of its call alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..losses.specs import LoggingLoss
from ..models.hybrid import MultiNNHybridModel
from . import _build
from .fused_epoch import (
    _EPS,
    _NORM_TRAIN,
    FUSED_LOSSES,
    MAX_LEAVES,
    MAX_NETS,
    MAX_TARGETS,
    TWO_PASS_LOSSES,
    BranchLayout,
    FusedData,
    FusedEpoch,
    FusedParams,
    L2_FIELDS,
    L2Penalty,
    LOSS_KINDS,
    PackedLayout,
    _Optimizer,
    _check_member_shapes,
    _dims,
    _loss_name,
    _reference_update,
    branch_view_reason,
    branch_layout,
    check_halt,
    obey_halt,
    fill_common_args,
    fill_l2_args,
    fused_data,
    fused_members_reference,
    l2_penalty,
    l2_step,
    opt_slots,
    reference_grads,
    shared_plan_fields,
    slot_u,
    training_spec_reason,
)
from .fused_forward import (
    MAX_ARGS,
    MAX_FORCING,
    _ACT_IDS,
    is_bf16,
    model_branches,
)

__all__ = [
    "FusedWideEpoch",
    "FusedWidePlan",
    "LayerGeometry",
    "Product",
    "batch_scales",
    "fused_wide_members_reference",
    "fused_wide_reference",
    "fused_wide_unsupported_reason",
    "launch_fused_wide",
    "make_fused_wide_epoch",
    "supports_fused_wide",
    "target_moments",
    "wide_geometry",
    "wide_layout",
]

# caps of the kernels; MAX_WIDE_WIDTH must equal EH_WIDE_MAX_WIDTH of the source
MAX_WIDE_WIDTH = 4096
#: the layers of every branch together, EHW_MAX_LAYERS: two leaves a layer, so
#: the leaf cap keeps every model the envelope admits within it
MAX_WIDE_LAYERS = MAX_LEAVES // 2
WIDE_LOSSES = FUSED_LOSSES  # and any ElementwiseLoss the tracer expresses
#: the share of the card's memory the activations and the partial sums may take
WORKSPACE_SHARE = 0.25
_TILE = 64            # the FMA products' output tile, EHW_TILE of the source
_DEPTH = 16           # rows of an FMA product's shared-memory tile, EHW_BK
_TC_DEPTH = 32        # inner extent of a staged tensor-core slice, EHW_TC_BK
_TC_MIN = 16          # the narrowest layer side whose products take the tensor cores, EHW_TC_MIN
_UPDATE_TILE = 32     # the update's tile of a tensor-core layer's W, EHW_UTILE
_SMS = 132            # multiprocessors of an H100 SXM
_TARGET_BLOCKS = 2 * _SMS  # blocks an FMA weight-gradient product aims at: two per multiprocessor
_MIN_SPLIT_ROWS = 64  # the fewest batch rows worth a block of their own
_MAX_SPLITS = 16      # the most pieces a product's inner dimension is cut into
_HEAD_THREADS = 256   # rows of a head block, EHW_HEAD_THREADS
_MAX_GRID_Y = 65535   # CUDA's cap on a grid's second dimension, the products' row tiles
TENSOR_CORES, FMA = "tensor cores", "fma"


# --------------------------------------------------------------------------
# launch geometry of the layer products
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Product:
    """One layer product's launch: its ``route`` (:data:`TENSOR_CORES` or
    :data:`FMA`), an output tile of ``bm`` x ``bn`` a block, and its inner
    dimension in ``splits`` pieces of ``split_k`` (a whole number of the
    route's depth, none empty)."""

    route: str
    bm: int
    bn: int
    splits: int
    split_k: int


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """The three products of one layer of ``din`` inputs and ``dout``
    outputs over a batch: the forward (batch x dout over din), the data
    gradient (batch x din over dout) and the weight gradient (dout x din
    over the batch), all on one route."""

    forward: Product
    data: Product
    weight: Product

    @property
    def route(self) -> str:
        return self.forward.route


_CLUSTER_MAX = 8      # the portable cluster size: the most pieces of a forward or data product


def _tc_product(m: int, n: int, k: int, summed_by_cluster: bool) -> Product:
    """The tensor-core product of ``m`` x ``n`` over ``k``: an output tile of
    64 rows while ``m`` fits, else 128, by 64 columns, and ``k`` cut into the
    fewest pieces (a power of two) at which the blocks reach one a
    multiprocessor, each piece a whole number of staged slices. A forward or
    data product's pieces sum their tile in a cluster (at most
    ``_CLUSTER_MAX``, none empty); a weight gradient's pieces (at most
    ``_MAX_SPLITS``) leave partial tiles that the update sums."""
    bm, bn = (64 if m <= 64 else 128), 64
    depth = -(-k // _TC_DEPTH)
    tiles = -(-m // bm) * -(-n // bn)
    cap = min(_CLUSTER_MAX if summed_by_cluster else _MAX_SPLITS, depth)
    want = 1
    while want * 2 <= cap and tiles * want < _SMS:
        want *= 2
    while True:
        split_k = -(-depth // want) * _TC_DEPTH
        splits = -(-k // split_k)
        if splits == want or not summed_by_cluster:
            return Product(TENSOR_CORES, bm, bn, splits, split_k)
        want //= 2


def _fma_product(m: int, n: int, k: int) -> Product:
    """The FMA product of ``m`` x ``n`` over ``k`` in tiles of 64: ``k`` cut
    into a cluster of pieces (a power of two up to ``_CLUSTER_MAX``) of at
    least four shared-memory tiles each, until the blocks fill the card."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    depth = -(-k // _DEPTH)
    want = 1
    while want * 2 <= min(_CLUSTER_MAX, depth // 4) and tiles * want < _SMS:
        want *= 2
    split_k = -(-depth // want) * _DEPTH
    return Product(FMA, _TILE, _TILE, -(-k // split_k), split_k)


@functools.lru_cache(maxsize=64)
def wide_geometry(dims: Tuple[int, ...], batch: int) -> Tuple[LayerGeometry, ...]:
    """Every layer's products over ``batch`` rows of an MLP of widths
    ``dims``: on the tensor cores where both of the layer's sides are at
    least ``_TC_MIN`` wide (:func:`_tc_product`), else on the FMA tile
    (:func:`_fma_product`; its weight gradient splits the batch into at
    least ``_MIN_SPLIT_ROWS`` rows a piece until the blocks reach
    ``_TARGET_BLOCKS``)."""
    out = []
    for din, dout in zip(dims[:-1], dims[1:]):
        if min(din, dout) >= _TC_MIN:
            out.append(LayerGeometry(_tc_product(batch, dout, din, True),
                                     _tc_product(batch, din, dout, True),
                                     _tc_product(dout, din, batch, False)))
        else:
            tiles = -(-dout // _TILE) * -(-din // _TILE)
            s, rows = _split(batch, -(-_TARGET_BLOCKS // tiles), _DEPTH)
            out.append(LayerGeometry(_fma_product(batch, dout, din),
                                     _fma_product(batch, din, dout),
                                     Product(FMA, _TILE, _TILE, s, rows)))
    return tuple(out)


# --------------------------------------------------------------------------
# layout of the workspace and of the partial sums
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WideLayout:
    """Where one step keeps its activations (``ws_*``, offsets in floats into
    the workspace) and how each layer's weight gradient is split over the
    batch (``splits``, ``split_rows``) into partial tiles (``part_*``,
    offsets into the partials buffer) that the update kernel sums in split
    order. The first layer's input (``ws_h0``, ``batch × F``) holds every
    branch's columns side by side, as do the normed input and its cotangent;
    the per-layer tuples run over every branch's layers in turn. A
    tensor-core layer also has its input and its output's
    cotangent feature-major (``ws_ht``, ``ws_dt``) and its ``W`` transposed
    (``ws_wt``; 0 for an FMA layer). The forward and data products' pieces
    sum their tiles in shared memory (a thread-block cluster) and need no
    room here. After those: a trainable norm's batch mean and variance
    (``ws_stats``, ``2 F`` floats), and for rmse and the statistic losses the
    predictions (``ws_pred``, ``T × batch``, target-major) and each head
    block's partial moments (``ws_mom``, ``head_blocks × T × 3``: Σŷm, or
    Σdiff² for rmse, then the centred Σdh² and Σdh·dy); 0 where absent."""

    ws_h0: int
    ws_xhat: int
    ws_d0: int
    ws_a: Tuple[int, ...]
    ws_d: Tuple[int, ...]
    ws_ht: Tuple[int, ...]
    ws_dt: Tuple[int, ...]
    ws_wt: Tuple[int, ...]
    ws_stats: int
    ws_pred: int
    ws_mom: int
    ws_floats: int
    geometry: Tuple[LayerGeometry, ...]
    splits: Tuple[int, ...]
    split_rows: Tuple[int, ...]
    part_off: Tuple[int, ...]
    norm_splits: int
    norm_split_rows: int
    part_off_norm: int
    part_floats: int
    head_blocks: int

    @property
    def nbytes(self) -> int:
        return 4 * (self.ws_floats + self.part_floats)


def _split(batch: int, want: int, multiple: int) -> Tuple[int, int]:
    """``(splits, rows per split)``: at most ``want`` splits of the batch, of
    at least ``_MIN_SPLIT_ROWS`` rows each, a multiple of ``multiple``."""
    want = max(1, min(want, -(-batch // _MIN_SPLIT_ROWS)))
    rows = -(-batch // want)
    rows = -(-rows // multiple) * multiple
    return -(-batch // rows), rows


def layer_dims(nets) -> Tuple[Tuple[int, int], ...]:
    """``(din, dout)`` of every branch's layers in turn (``nets``: the
    branches' widths)."""
    return tuple(pair for dims in nets for pair in zip(dims[:-1], dims[1:]))


@functools.lru_cache(maxsize=64)
def wide_layout(nets: Tuple, has_norm: bool, batch: int, train_norm: bool = False,
                n_targets: int = 1, moments: bool = False) -> WideLayout:
    """The layout of a step over ``batch`` rows of MLP branches of widths
    ``nets`` (a tuple of width tuples; one tuple of ints: one network)
    (``train_norm``: a trainable input norm; ``moments``: a loss whose
    cotangents need the batch's prediction moments, over ``n_targets``).
    One network keeps the layout kernel 3 had before it took branches."""
    if isinstance(nets[0], int):
        nets = (nets,)
    f = sum(dims[0] for dims in nets)
    off = batch * f
    ws_xhat = ws_d0 = 0
    if has_norm:
        ws_xhat, ws_d0, off = off, off + batch * f, off + 2 * batch * f
    ws_a, ws_d = [], []
    for _, width in layer_dims(nets):
        ws_a.append(off)
        ws_d.append(off + batch * width)
        off += 2 * batch * width
    geometry = tuple(geo for dims in nets for geo in wide_geometry(tuple(dims), batch))
    ws_ht, ws_dt, ws_wt = [], [], []
    for (din, dout), geo in zip(layer_dims(nets), geometry):
        if geo.route == TENSOR_CORES:
            ws_ht.append(off)
            ws_dt.append(off + batch * din)
            ws_wt.append(off + batch * (din + dout))
            off += batch * (din + dout) + din * dout
        else:
            ws_ht.append(0)
            ws_dt.append(0)
            ws_wt.append(0)
    head_blocks = -(-batch // _HEAD_THREADS)
    ws_stats = ws_pred = ws_mom = 0
    if train_norm:
        ws_stats, off = off, off + 2 * f
    if moments:
        ws_pred, ws_mom = off, off + n_targets * batch
        off = ws_mom + head_blocks * n_targets * 3
    splits, split_rows, part_off = [], [], []
    part = 0
    for (din, dout), geo in zip(layer_dims(nets), geometry):
        splits.append(geo.weight.splits)
        split_rows.append(geo.weight.split_k)
        part_off.append(part)
        part += geo.weight.splits * dout * (din + 1)
    norm_splits, norm_rows = _split(batch, 64, 1)
    part_off_norm = part
    if has_norm:
        part += norm_splits * 2 * f
    return WideLayout(
        ws_h0=0, ws_xhat=ws_xhat, ws_d0=ws_d0, ws_a=tuple(ws_a), ws_d=tuple(ws_d),
        ws_ht=tuple(ws_ht), ws_dt=tuple(ws_dt), ws_wt=tuple(ws_wt), ws_stats=ws_stats,
        ws_pred=ws_pred, ws_mom=ws_mom, ws_floats=off,
        geometry=geometry, splits=tuple(splits), split_rows=tuple(split_rows),
        part_off=tuple(part_off), norm_splits=norm_splits, norm_split_rows=norm_rows,
        part_off_norm=part_off_norm, part_floats=part, head_blocks=head_blocks,
    )


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

def _card_memory(device) -> Optional[int]:
    """Bytes of the CUDA device's memory, or None for another device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def fused_wide_unsupported_reason(model, optimizer, logging: LoggingLoss, tensors=None, *,
                                  memory_bytes: Optional[int] = None,
                                  members: int = 1) -> Optional[str]:
    """Why the wide fused epoch cannot train ``model`` with this optimizer
    and loss, or None when it can.

    The envelope: the JAX kernel's branch view (``branch_view_reason`` with
    this kernel's widths): a SingleNN MLP hybrid, or a MultiNN hybrid of
    up to :data:`~.fused_epoch.MAX_NETS` MLP branches (one a neural
    parameter), in float32 (its products on bf16 operands under
    ``compute_dtype=torch.bfloat16``, the kernels' bf16 build) with no, a
    static or a trainable input norm, one for all branches (its statistics
    taken over the whole batch, padding rows included, as the JAX kernel
    takes them), the 12 named activations, widths up to ``MAX_WIDE_WIDTH``
    and at most ``MAX_LAYERS`` layers a branch, at most ``MAX_LEAVES``
    parameter leaves in all (which keeps every branch's layers together
    within ``MAX_WIDE_LAYERS``), a kernel-form mechanistic function;
    ``training_loss`` any of :data:`WIDE_LOSSES` (the JAX kernel's: mse,
    mae, rmse, nseLoss, pearsonLoss, kgeLoss, pbkgeLoss) or an
    ``ElementwiseLoss`` the tracer expresses, with ``agg`` sum or mean and
    no ``extra_loss`` but ``l2_extra_loss``'s declarative weight-L2
    (``fused_epoch.L2Penalty``); one optimizer spec of any rule but
    ``noisy_sgd`` (``training_spec_reason``). Any number of epochs per call;
    with ``tensors``, a batch of at most 65,535 row tiles of 64, and the
    activations and partial sums of one step of ``members`` models (a
    population's member launch) within ``WORKSPACE_SHARE`` of the card's
    memory (``memory_bytes``, by default the memory of the model's CUDA
    device; unchecked on another device)."""
    reason = branch_view_reason(model, max_width=MAX_WIDE_WIDTH)
    if reason is not None:
        return reason
    branches = model_branches(model)
    if not branches:
        return "the model has no neural network"
    if len(model.targets) > MAX_TARGETS:
        return f"{len(model.targets)} targets exceed the kernel's cap of {MAX_TARGETS}"
    reason = training_spec_reason(optimizer, logging, WIDE_LOSSES, takes_l2=True)
    if reason is not None:
        return reason
    if tensors is not None:
        xs = list(tensors.x.values()) if isinstance(tensors.x, dict) else [tensors.x]
        if any(x.ndim != 3 for x in xs):
            return (f"x of shape {[tuple(x.shape) for x in xs]}: the kernel takes "
                    "(num_batches, batch, F) a branch")
        batch = int(tensors.weight.shape[1])
        if batch > _MAX_GRID_Y * _TILE:
            return (f"a batch of {batch} rows exceeds the {_MAX_GRID_Y * _TILE} that the products' "
                    "grid of row tiles takes")
        if memory_bytes is None:
            memory_bytes = _card_memory(model.device)
        if memory_bytes is not None:
            nets = tuple(_dims(net) for _, net in branches)
            need = members * wide_layout(nets, branches[0][1].norm is not None, batch,
                                         branches[0][1].input_batchnorm is True,
                                         len(model.targets),
                                         _loss_name(logging.training_loss) in TWO_PASS_LOSSES).nbytes
            if need > WORKSPACE_SHARE * memory_bytes:
                who = f"{members} members' steps" if members > 1 else "a step's"
                return (f"{who} activations and partial sums take {need} bytes, more than "
                        f"{WORKSPACE_SHARE:g} of the card's {memory_bytes}")
    return None


def supports_fused_wide(model, optimizer, logging: LoggingLoss, tensors=None) -> bool:
    return fused_wide_unsupported_reason(model, optimizer, logging, tensors) is None


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``struct EhFusedWideArgs`` in csrc/fused_wide.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("forcing", ctypes.c_void_p * MAX_FORCING),
        ("y", ctypes.c_void_p * MAX_TARGETS),
        ("mask", ctypes.c_void_p * MAX_TARGETS),
        ("perm", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("valid", ctypes.c_void_p),
        ("tcount", ctypes.c_void_p),
        ("params", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("u", ctypes.c_void_p),
        ("bn", ctypes.c_void_p),
        ("consts", ctypes.c_void_p),
        ("ws", ctypes.c_void_p),
        ("partials", ctypes.c_void_p),
        ("head_partials", ctypes.c_void_p),
        ("epoch_loss", ctypes.c_void_p),
        ("lamb_parts", ctypes.c_void_p),
        ("n_rows", ctypes.c_int64),
        ("ws_off_h0", ctypes.c_int64),
        ("ws_off_xhat", ctypes.c_int64),
        ("ws_off_d0", ctypes.c_int64),
        ("ws_off_a", ctypes.c_int64 * MAX_WIDE_LAYERS),
        ("ws_off_d", ctypes.c_int64 * MAX_WIDE_LAYERS),
        ("part_off", ctypes.c_int64 * MAX_WIDE_LAYERS),
        ("part_off_norm", ctypes.c_int64),
        ("ws_off_ht", ctypes.c_int64 * MAX_WIDE_LAYERS),
        ("ws_off_dt", ctypes.c_int64 * MAX_WIDE_LAYERS),
        ("ws_off_wt", ctypes.c_int64 * MAX_WIDE_LAYERS),
        ("n_epochs", ctypes.c_int),
        ("n_batches", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_WIDE_LAYERS + MAX_NETS)),
        ("acts", ctypes.c_int * MAX_WIDE_LAYERS),
        ("norm_mode", ctypes.c_int),
        ("norm_eps", ctypes.c_float),
        ("n_params", ctypes.c_int),
        ("p_off_w", ctypes.c_int * MAX_WIDE_LAYERS),
        ("p_off_b", ctypes.c_int * MAX_WIDE_LAYERS),
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
        ("loss_kind", ctypes.c_int),
        ("optimizer", _Optimizer),
        ("splits", ctypes.c_int * MAX_WIDE_LAYERS),
        ("split_rows", ctypes.c_int * MAX_WIDE_LAYERS),
        ("norm_splits", ctypes.c_int),
        ("norm_split_rows", ctypes.c_int),
        ("head_blocks", ctypes.c_int),
        ("tc", ctypes.c_int * MAX_WIDE_LAYERS),
        ("fwd_bm", ctypes.c_int * MAX_WIDE_LAYERS),
        ("fwd_bn", ctypes.c_int * MAX_WIDE_LAYERS),
        ("fwd_splits", ctypes.c_int * MAX_WIDE_LAYERS),
        ("fwd_split_k", ctypes.c_int * MAX_WIDE_LAYERS),
        ("dat_bm", ctypes.c_int * MAX_WIDE_LAYERS),
        ("dat_bn", ctypes.c_int * MAX_WIDE_LAYERS),
        ("dat_splits", ctypes.c_int * MAX_WIDE_LAYERS),
        ("dat_split_k", ctypes.c_int * MAX_WIDE_LAYERS),
        ("wgt_bm", ctypes.c_int * MAX_WIDE_LAYERS),
        ("wgt_bn", ctypes.c_int * MAX_WIDE_LAYERS),
        ("halt", ctypes.c_void_p),
        ("tmom", ctypes.c_void_p),
        ("ws_off_stats", ctypes.c_int64),
        ("ws_off_pred", ctypes.c_int64),
        ("ws_off_mom", ctypes.c_int64),
        ("momentum", ctypes.c_float),
        ("one_minus_momentum", ctypes.c_float),
        ("n_members", ctypes.c_int),
        ("perm_stride", ctypes.c_int64),
        ("member_opt", ctypes.c_void_p),
        ("ws_stride", ctypes.c_int64),
        ("part_stride", ctypes.c_int64),
        ("lamb_stride", ctypes.c_int64),
        ("l2_parts", ctypes.c_void_p),
        ("l2_stride", ctypes.c_int64),
        *L2_FIELDS,
        ("n_nets", ctypes.c_int),
        ("n_features", ctypes.c_int),
        ("n_neural", ctypes.c_int),
        ("layer_net", ctypes.c_int * MAX_WIDE_LAYERS),
        ("net_first", ctypes.c_int * MAX_NETS),
        ("net_layers", ctypes.c_int * MAX_NETS),
        ("net_col", ctypes.c_int * MAX_NETS),
        ("net_out", ctypes.c_int * MAX_NETS),
    ]


@dataclasses.dataclass(frozen=True)
class FusedWidePlan(PackedLayout):
    """Static layout of a wide model's packed parameters, plus what the
    kernels and their plain version read besides them. ``nets`` holds each
    network's ``(prefix, dims, acts)``: one for a SingleNN model, one a
    branch for a MultiNN model, as :class:`~.fused_epoch.FusedEpochPlan`."""

    nets: Tuple[Tuple[str, Tuple[int, ...], Tuple[str, ...]], ...]
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
    loss: str
    loss_form: Any = None  # the traced ElementwiseLoss (kernel_forms.LossForm) of ELEMENTWISE
    bf16: bool = False  # compute_dtype=bfloat16: the kernels' bf16 build (csrc/fused_wide.cu)
    l2: Optional[L2Penalty] = None  # the weight-L2 extra_loss

    @functools.cached_property
    def branch_layout(self) -> BranchLayout:
        return branch_layout(self.nets, self.has_norm, len(self.global_names))

    @property
    def dims(self) -> Tuple[int, ...]:
        """The widths of a plan's one network."""
        (net,) = self.nets
        return net[1]

    @property
    def acts(self) -> Tuple[str, ...]:
        (net,) = self.nets
        return net[2]

    @property
    def net_dims(self) -> Tuple[Tuple[int, ...], ...]:
        """Every network's widths."""
        return tuple(dims for _, dims, _ in self.nets)

    @property
    def n_features(self) -> int:
        return self.branch_layout.n_features

    def layout(self, batch: int) -> WideLayout:
        return wide_layout(self.net_dims, self.has_norm, int(batch), self.norm_mode == _NORM_TRAIN,
                           len(self.target_names), self.loss in TWO_PASS_LOSSES)

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernels' static arguments, packed once; each call fills in the
        pointers, the sizes and the batch's layout. Every branch's layers in
        one list, each with its branch (``layer_net``); branch b's widths at
        ``dims[net_first[b] + b:]``, so that layer l reads its own at
        ``dims[l + layer_net[l]]`` and the next."""
        a = _Args()
        lay = self.branch_layout
        first = 0
        for b, net in enumerate(lay.nets):
            n = len(net.dims) - 1
            a.dims[first + b : first + b + n + 1] = net.dims
            a.acts[first : first + n] = [_ACT_IDS[act] for act in net.acts]
            a.p_off_w[first : first + n] = net.p_w
            a.p_off_b[first : first + n] = net.p_b
            a.layer_net[first : first + n] = [b] * n
            a.net_first[b], a.net_layers[b] = first, n
            a.net_col[b], a.net_out[b] = net.col, net.out
            first += n
        a.n_layers, a.n_nets = first, len(lay.nets)
        a.n_features, a.n_neural = lay.n_features, lay.n_neural
        fill_common_args(a, self)
        a.n_params = self.n_params
        a.p_off_g = lay.p_g
        a.loss_kind = LOSS_KINDS[self.loss]
        a.momentum = self.momentum
        a.one_minus_momentum = 1.0 - self.momentum
        fill_l2_args(a, self)
        return bytes(a)


def plan_fused_wide(model, optimizer, logging: LoggingLoss) -> FusedWidePlan:
    """Check the envelope and the kernel form (its outputs and partials on
    probe values) and lay out the model's parameters."""
    reason = fused_wide_unsupported_reason(model, optimizer, logging)
    if reason is not None:
        raise ValueError(f"model not supported by the wide fused epoch kernel: {reason}")
    nets = tuple((prefix, _dims(net), tuple(layer.activation for layer in net.layers))
                 for prefix, net in model_branches(model))
    names = [f"{prefix}.layers.{i}.{leaf}" for prefix, dims, _ in nets
             for i in range(len(dims) - 1) for leaf in ("weight", "bias")]
    fields = shared_plan_fields(model, optimizer, logging, names)
    return FusedWidePlan(
        nets=nets,
        bf16=is_bf16(model),
        l2=l2_penalty(logging, fields["segments"]),
        **fields,
    )


# --------------------------------------------------------------------------
# loss scales and the plain version
# --------------------------------------------------------------------------

def _by_step(col: torch.Tensor, idx: torch.Tensor, data: FusedData) -> torch.Tensor:
    """A ``(n,)`` column at every step's rows: ``(E, nb, batch)``."""
    return col[idx].reshape(idx.shape[0], data.n_batches, data.batch)


def _per_member(fn, plan, data, rows, k: int):
    """``fn(plan, data, rows)``'s tensors with the member axis in front: one
    member's row index at a time (so each member's numbers are those of its
    launch alone, bit for bit), or a shared index's once, for all ``k``."""
    if rows.dim() == 3:
        outs = [fn(plan, data, r) for r in rows]
        return tuple(torch.stack(parts).contiguous() for parts in zip(*outs))
    return tuple(t.expand((k,) + tuple(t.shape)).contiguous() for t in fn(plan, data, rows))


def target_moments(plan: FusedWidePlan, data: FusedData, rows: torch.Tensor) -> torch.Tensor:
    """``(E, nb, T, 3)``: every step's count ``n = max(Σ m, 1)``, target mean
    ``ȳ = Σ y / n`` (y is 0 where masked) and centred ``SST = Σ ((y − ȳ) m)²``
    per target, as the JAX kernel takes them for nseLoss and the statistic
    losses; they depend on the targets alone."""
    idx = rows.long()
    out = []
    for y, mask in zip(data.y, data.mask):
        m, yb = _by_step(mask, idx, data), _by_step(y, idx, data)
        n = m.sum(-1).clamp_min(1.0)
        mu = yb.sum(-1) / n
        dev = (yb - mu[..., None]) * m
        out.append(torch.stack([n, mu, (dev * dev).sum(-1)], -1))
    return torch.stack(out, -2).to(torch.float32).contiguous()


def batch_scales(plan: FusedWidePlan, data: FusedData, rows: torch.Tensor):
    """``(scale (E, nb, T), valid (E, nb))``: every step's loss scale per
    target over the whole batch, ``agg_scale / max(Σ mask, 1)`` (mse, mae,
    an elementwise loss by mean), ``agg_scale / max(SST, 1e-12)`` (nseLoss,
    :func:`target_moments`) or ``agg_scale`` (an elementwise loss by sum,
    rmse and the statistic losses, whose own factors come from the batch's
    predictions), and its validity flag (a batch with no valid target
    changes nothing), from the masks, the targets and the row index alone."""
    idx = rows.long()
    counts = [_by_step(mask, idx, data).sum(-1) for mask in data.mask]
    if plan.loss == "nseLoss":
        sst = target_moments(plan, data, rows)[..., 2]
        scale = plan.agg_scale / sst.clamp_min(_EPS)
    elif plan.loss in TWO_PASS_LOSSES or (plan.loss_form is not None
                                          and plan.loss_form.normalize == "sum"):
        scale = torch.stack([torch.full_like(c, plan.agg_scale) for c in counts], -1)
    else:
        scale = torch.stack([plan.agg_scale / c.clamp_min(1.0) for c in counts], -1)
    valid = (torch.stack(counts).sum(0) > 0).to(torch.float32)
    return scale.to(torch.float32).contiguous(), valid.contiguous()


def fused_wide_reference(plan: FusedWidePlan, packed: FusedParams, opt_state, data: FusedData,
                         rows: torch.Tensor, halt=None):
    """The plain PyTorch version of the kernels: ``rows.shape[0]`` epochs of
    ``data.n_batches`` steps over the rows ``rows[e, i·B : (i+1)·B]``, each
    the whole batch's forward, the cotangent with the loss scales of
    :func:`batch_scales` (rmse and the statistic losses: from the batch's
    moments), the hand-written backward and the gated update of the
    parameters and of a trainable norm's running statistics, with a
    weight-L2 penalty's value and gradient where the plan has one
    (``fused_epoch.l2_step``). Returns ``(packed, opt_state, mean_loss)``; the loss is the last epoch's mean
    batch loss (a batch without valid targets counts 0 and takes no step).
    ``halt``: ``obey_halt``."""
    packed0, opt0 = packed, opt_state
    scale, valid = batch_scales(plan, data, rows)
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
            g, loss, _, new_bn = reference_grads(
                plan, p, bn, consts, data.x[idx],
                [c[idx] for c in data.forcing], [c[idx] for c in data.y],
                [c[idx] for c in data.mask], scale=list(scale[e, i]),
            )
            g, loss = l2_step(plan, p, g, loss)
            ok = valid[e, i] > 0
            p, slots, t = _reference_update(plan, p, slots, t, g, ok)
            bn = torch.where(ok, new_bn, bn)
            epoch_loss = epoch_loss + torch.where(ok, loss, torch.zeros_like(loss))
    new_state = {**slots, "t": t.round().to(torch.int32)}
    return obey_halt(halt, packed0, opt0, (FusedParams(p, bn), new_state, epoch_loss / nb))


# --------------------------------------------------------------------------
# kernel launch and the epoch function
# --------------------------------------------------------------------------

def fill_geometry(a: _Args, lay: WideLayout) -> None:
    """The tensor-core layers' workspace offsets and every product's launch
    geometry into the kernel's arguments."""
    n = len(lay.geometry)
    a.ws_off_ht[:n], a.ws_off_dt[:n], a.ws_off_wt[:n] = lay.ws_ht, lay.ws_dt, lay.ws_wt
    for l, geo in enumerate(lay.geometry):
        a.tc[l] = int(geo.route == TENSOR_CORES)
        a.fwd_bm[l], a.fwd_bn[l] = geo.forward.bm, geo.forward.bn
        a.fwd_splits[l], a.fwd_split_k[l] = geo.forward.splits, geo.forward.split_k
        a.dat_bm[l], a.dat_bn[l] = geo.data.bm, geo.data.bn
        a.dat_splits[l], a.dat_split_k[l] = geo.data.splits, geo.data.split_k
        a.wgt_bm[l], a.wgt_bn[l] = geo.weight.bm, geo.weight.bn


def update_blocks(plan: FusedWidePlan, lay: WideLayout) -> int:
    """Blocks of ``eh_wide_update_kernel``: a tile of ``_UPDATE_TILE``² of
    every tensor-core layer's W, then one thread per other parameter and one
    for the loss."""
    tc = [pair for pair, geo in zip(layer_dims(plan.net_dims), lay.geometry)
          if geo.route == TENSOR_CORES]
    tiles = sum(-(-din // _UPDATE_TILE) * -(-dout // _UPDATE_TILE) for din, dout in tc)
    loose = plan.n_params - sum(din * dout for din, dout in tc)
    return tiles + -(-(loose + 1) // 256)


def launch_fused_wide(plan: FusedWidePlan, packed: FusedParams, opt_state, data: FusedData,
                      rows: torch.Tensor, loss: torch.Tensor, *, halt=None,
                      member_opt=None) -> None:
    """Enqueue every step of ``rows`` (``(epochs, num_batches · batch)``)
    with one call of the C launcher, updating ``packed`` (a trainable norm's
    running statistics too) and ``opt_state`` in place and writing the last
    epoch's mean batch loss into ``loss``; raises
    if a launch is refused. Counts calls in ``launch_fused_wide.launches``.
    ``halt`` is the halt word (``ops/fused_epoch.py``): every kernel of a
    halted call returns at entry, and the step count and loss stay.

    The member axis (:meth:`FusedWideEpoch.members`): parameters ``(K, n)``
    train K members in one call, each launch of a step over all of them (the
    member a grid dimension), with every state tensor stacked the same way
    (``t`` ``(K, 1)``, ``loss`` ``(K,)``) and a workspace, partial sums and
    loss scales per member; ``rows`` ``(K, E, n)`` gives each member its own
    row index (else one is shared) and ``member_opt`` ``(K,
    len(OPT_SCALARS))`` its optimizer numbers
    (``ops/fused_epoch.py::member_opt_rows``; else the plan's)."""
    members = packed.params.dim() == 2
    k = packed.params.shape[0] if members else 1
    _check_member_shapes(plan, packed, opt_state, rows, loss, member_opt, k, members)
    lib = _build.kernel_library("fused_wide.cu", plan.form, plan.loss_form, bf16=plan.bf16)
    if lib.eh_fused_wide_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_wide_args_size()} != {ctypes.sizeof(_Args)}"
        )
    dev = data.x.device
    a = wide_launch_args(plan, packed, opt_state, data, rows, k, halt=halt, member_opt=member_opt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.eh_fused_wide(ctypes.byref(a.args), stream)
    if rc != 0:
        raise RuntimeError(
            f"wide fused epoch kernel launch failed: {lib.eh_cuda_error_string(rc).decode()}")
    t = a.tcount[:, -1:].round().to(torch.int32).reshape(opt_state["t"].shape)
    if halt is not None:
        t = torch.where(halt != 0, opt_state["t"], t)
    opt_state["t"].copy_(t)
    loss.copy_(a.epoch_loss[:, -1] / data.n_batches)
    launch_fused_wide.launches += 1


class WideLaunch(NamedTuple):
    """A call's argument struct and the tensors it points to, which live as
    long as the call needs them (:func:`wide_launch_args`)."""

    args: _Args
    tcount: torch.Tensor
    epoch_loss: torch.Tensor
    scratch: Tuple[torch.Tensor, ...]


def wide_launch_args(plan: FusedWidePlan, packed: FusedParams, opt_state, data: FusedData,
                     rows: torch.Tensor, k: int, *, halt=None, member_opt=None) -> WideLaunch:
    """The launcher's argument struct for a call of ``k`` members (see
    :func:`launch_fused_wide`): the plan's static fields, the tensors'
    addresses, each member's loss scales, validity and step counts, the
    workspace and partial sums (a member's after the member before), the
    member axis's count and strides."""
    dev = data.x.device
    epochs = rows.shape[-2]
    lay = plan.layout(data.batch)
    scale, valid = _per_member(batch_scales, plan, data, rows, k)
    tmom = (_per_member(lambda *a: (target_moments(*a),), plan, data, rows, k)[0]
            if plan.loss in TWO_PASS_LOSSES else None)
    t0 = opt_state["t"].reshape(k, 1).to(torch.float32)
    tcount = (t0 + torch.cumsum(valid.reshape(k, -1), 1)).contiguous()
    ws = torch.empty((k * lay.ws_floats,), dtype=torch.float32, device=dev)
    partials = torch.empty((max(k * lay.part_floats, 1),), dtype=torch.float32, device=dev)
    n_glob = len(plan.global_names)
    head_partials = torch.empty((k, lay.head_blocks, 1 + n_glob), dtype=torch.float32, device=dev)
    epoch_loss = torch.zeros((k, epochs), dtype=torch.float32, device=dev)
    blocks = update_blocks(plan, lay)
    scratch = [scale, valid, ws, partials, head_partials] + ([tmom] if tmom is not None else [])

    a = _Args.from_buffer_copy(plan.args_bytes)
    a.x = data.x.data_ptr()
    for i, c in enumerate(data.forcing):
        a.forcing[i] = c.data_ptr()
    for i, (yc, mc) in enumerate(zip(data.y, data.mask)):
        a.y[i], a.mask[i] = yc.data_ptr(), mc.data_ptr()
    a.perm = rows.data_ptr()
    a.scale, a.valid, a.tcount = scale.data_ptr(), valid.data_ptr(), tcount.data_ptr()
    a.tmom = tmom.data_ptr() if tmom is not None else None
    a.params, a.bn = packed.params.data_ptr(), packed.bn.data_ptr()
    a.m, a.v = opt_state["m"].data_ptr(), opt_state["v"].data_ptr()
    a.u = slot_u(plan, opt_state)
    a.consts = plan.consts.data_ptr()
    a.ws, a.partials = ws.data_ptr(), partials.data_ptr()
    a.head_partials, a.epoch_loss = head_partials.data_ptr(), epoch_loss.data_ptr()
    a.n_rows = data.x.shape[0]
    a.n_epochs, a.n_batches, a.batch = epochs, data.n_batches, data.batch
    a.n_members = k
    a.perm_stride = rows.shape[-2] * rows.shape[-1] if rows.dim() == 3 else 0
    a.member_opt = member_opt.data_ptr() if member_opt is not None else None
    a.ws_stride, a.part_stride = lay.ws_floats, lay.part_floats
    n_layers = len(lay.geometry)
    a.ws_off_h0, a.ws_off_xhat, a.ws_off_d0 = lay.ws_h0, lay.ws_xhat, lay.ws_d0
    a.ws_off_stats, a.ws_off_pred, a.ws_off_mom = lay.ws_stats, lay.ws_pred, lay.ws_mom
    a.ws_off_a[:n_layers] = lay.ws_a
    a.ws_off_d[:n_layers] = lay.ws_d
    a.part_off[:n_layers] = lay.part_off
    a.part_off_norm = lay.part_off_norm
    a.splits[:n_layers] = lay.splits
    a.split_rows[:n_layers] = lay.split_rows
    a.norm_splits, a.norm_split_rows = lay.norm_splits, lay.norm_split_rows
    a.head_blocks = lay.head_blocks
    fill_geometry(a, lay)
    a.halt = check_halt(halt, dev)
    if plan.opt_name == "lamb":  # a row of leaf norms per update block (eh_wide_update_kernel)
        lamb_parts = torch.empty((k, blocks, 2 * a.optimizer.n_leaves), dtype=torch.float32,
                                 device=dev)
        a.lamb_parts, a.lamb_stride = lamb_parts.data_ptr(), blocks * 2 * a.optimizer.n_leaves
        scratch.append(lamb_parts)
    if plan.l2 is not None:  # each update block's sum of squared weights, two steps' a member
        l2_parts = torch.empty((k, 2, blocks), dtype=torch.float32, device=dev)
        a.l2_parts, a.l2_stride = l2_parts.data_ptr(), 2 * blocks
        scratch.append(l2_parts)
    return WideLaunch(a, tcount, epoch_loss, tuple(scratch))


launch_fused_wide.launches = 0


def _wide_product(a: torch.Tensor, b: torch.Tensor, geometry: Optional[Product] = None) -> torch.Tensor:
    """``a @ b.T`` for ``a`` (M x K) and ``b`` (N x K), float32: kernel 3's
    tensor-core product alone (3xTF32), in the tile and pieces of
    ``geometry`` (by default those :func:`wide_geometry` would give a forward
    product of this shape), on CUDA tensors; the plain product on CPU
    tensors. For the tests, which hold the product against a float64
    reference; the training path never calls it."""
    if a.dtype != torch.float32 or b.dtype != torch.float32 or a.ndim != 2 or b.ndim != 2 \
            or a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError(f"_wide_product takes float32 (M, K) and (N, K) on one device, got "
                         f"{tuple(a.shape)} {a.dtype} on {a.device} and {tuple(b.shape)} "
                         f"{b.dtype} on {b.device}")
    if a.device.type != "cuda":
        return a @ b.T
    (m, k), n = a.shape, b.shape[0]
    geo = geometry or _tc_product(m, n, k, True)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.eh_wide_tc_product(a.data_ptr(), k, b.data_ptr(), k, out.data_ptr(), m, n, k,
                                    geo.bm, geo.bn, geo.splits, geo.split_k, stream)
    if rc != 0:
        raise RuntimeError(f"tensor-core product launch failed: {lib.eh_cuda_error_string(rc).decode()}")
    return out


def fused_wide_members_reference(plan: FusedWidePlan, packed: FusedParams, opt_state,
                                 data: FusedData, rows: torch.Tensor, *, specs=None):
    """The plain version of kernel 3's member axis: :func:`fused_wide_reference`
    once per member, with that member's optimizer spec, row index (and so its
    data), state and running statistics; the results stacked."""
    return fused_members_reference(plan, packed, opt_state, data, rows, specs=specs,
                                   reference=fused_wide_reference)


class FusedWideEpoch(FusedEpoch):
    """:class:`~easyhybrid_tpu_torch.ops.fused_epoch.FusedEpoch` for an MLP
    hybrid too wide for one block: ``epochs_per_call`` epochs in one call of
    kernel 3's launcher on CUDA tensors, :func:`fused_wide_reference` on CPU
    tensors; a population's members in one call (:meth:`members`, kernel 3's
    member axis), or member by member on CPU tensors
    (:func:`fused_wide_members_reference`)."""

    _make_plan = staticmethod(plan_fused_wide)
    _make_data = staticmethod(fused_data)
    _reference = staticmethod(fused_wide_reference)
    _launch = staticmethod(launch_fused_wide)


def make_fused_wide_epoch(model, optimizer, logging: LoggingLoss, *, shuffle: Any = True,
                          epochs_per_call: int = 1) -> FusedWideEpoch:
    """Build the wide fused epoch of ``model`` (see :class:`FusedWideEpoch`);
    raises if the model, optimizer or loss is outside the envelope or the
    kernel form's probe check fails."""
    return FusedWideEpoch(model, optimizer, logging, shuffle=shuffle,
                          epochs_per_call=epochs_per_call)
