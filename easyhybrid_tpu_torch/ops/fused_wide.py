"""Fused training epochs of a wide MLP hybrid: hand-written CUDA kernels for
Hopper (kernel 3).

Counterpart of the batch-chunked half of ``easyhybrid_tpu/ops/fused_epoch.py``
(``kernel_body_elem``, chosen by ``_pick_batch_chunks`` for the tower
[1024, 512, 256, 128, 64] at batch 1,024). What that kernel computes, with the
TPU's chunking stripped: per optimizer step, the whole-batch gradient of the
masked elementwise loss (mse or mae) of a static-norm MLP hybrid, summed in a
fixed order over batch tiles, then one gated update of every parameter.

A model this wide does not fit one block's shared memory, so parameters,
moments and the activations live in device memory, and one call of the
launcher of ``csrc/fused_wide.cu`` enqueues every step's kernels of
``epochs_per_call`` epochs × ``num_batches`` batches on the stream with no
host synchronisation in between: the row gather with the input norm, a tiled
product per layer forward, a head kernel (bound scaling, the mechanistic
model in its kernel form, the loss and its cotangent), two tiled products per
layer backward, and the optimizer update, which also folds the partial sums
the others left. The layer products are the kernels' own; no library product
is on the path. A layer whose two sides are both at least ``_TC_MIN`` wide
runs its forward, data-gradient and weight-gradient products on the tensor
cores in 3xTF32 (``wgmma`` on operands split into a TF32 value and its TF32
remainder, about float32's accuracy); the edge layers (two inputs, one
output) keep a float32 FMA tile. :func:`wide_geometry` chooses every
product's route, output tile and the pieces its inner dimension is cut into,
from the widths and the batch alone; the launcher checks what it is given.

The packed layout is kernel 2's (:class:`~.fused_epoch.PackedLayout`): norm
scale and bias, each layer's ``W`` and ``b``, the raw globals. As in the JAX
package the masked ``1/n`` of each target and the batch's validity flag span
the whole batch and are made before the launch (:func:`batch_scales`), with
the step count after each step.

:func:`fused_wide_reference` is the same algorithm in plain PyTorch. On CPU
tensors the wrapper computes it; on CUDA tensors it launches the kernels or
raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..losses.specs import LoggingLoss
from . import _build
from .fused_epoch import (
    MAX_TARGETS,
    FusedData,
    FusedEpoch,
    FusedParams,
    PackedLayout,
    _Optimizer,
    _reference_update,
    fill_common_args,
    fused_data,
    opt_slots,
    param_offsets,
    reference_grads,
    shared_plan_fields,
    slot_u,
    training_spec_reason,
)
from .fused_forward import (
    MAX_ARGS,
    MAX_FORCING,
    MAX_LAYERS,
    _ACT_IDS,
    fused_forward_unsupported_reason,
)

__all__ = [
    "FusedWideEpoch",
    "FusedWidePlan",
    "LayerGeometry",
    "Product",
    "batch_scales",
    "fused_wide_reference",
    "fused_wide_unsupported_reason",
    "launch_fused_wide",
    "make_fused_wide_epoch",
    "supports_fused_wide",
    "wide_geometry",
    "wide_layout",
]

# caps of the kernels; MAX_WIDE_WIDTH must equal EH_WIDE_MAX_WIDTH of the source
MAX_WIDE_WIDTH = 4096
WIDE_LOSSES = ("mse", "mae")
_LOSS_KINDS = {"mse": 0, "mae": 1}  # squared or absolute differences
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
    order. A tensor-core layer also has its input and its output's
    cotangent feature-major (``ws_ht``, ``ws_dt``) and its ``W`` transposed
    (``ws_wt``; 0 for an FMA layer). The forward and data products' pieces
    sum their tiles in shared memory (a thread-block cluster) and need no
    room here."""

    ws_h0: int
    ws_xhat: int
    ws_d0: int
    ws_a: Tuple[int, ...]
    ws_d: Tuple[int, ...]
    ws_ht: Tuple[int, ...]
    ws_dt: Tuple[int, ...]
    ws_wt: Tuple[int, ...]
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


@functools.lru_cache(maxsize=64)
def wide_layout(dims: Tuple[int, ...], has_norm: bool, batch: int) -> WideLayout:
    """The layout of a step over ``batch`` rows of an MLP of widths ``dims``."""
    f = dims[0]
    off = batch * f
    ws_xhat = ws_d0 = 0
    if has_norm:
        ws_xhat, ws_d0, off = off, off + batch * f, off + 2 * batch * f
    ws_a, ws_d = [], []
    for width in dims[1:]:
        ws_a.append(off)
        ws_d.append(off + batch * width)
        off += 2 * batch * width
    geometry = wide_geometry(tuple(dims), batch)
    ws_ht, ws_dt, ws_wt = [], [], []
    for din, dout, geo in zip(dims[:-1], dims[1:], geometry):
        if geo.route == TENSOR_CORES:
            ws_ht.append(off)
            ws_dt.append(off + batch * din)
            ws_wt.append(off + batch * (din + dout))
            off += batch * (din + dout) + din * dout
        else:
            ws_ht.append(0)
            ws_dt.append(0)
            ws_wt.append(0)
    splits, split_rows, part_off = [], [], []
    part = 0
    for din, dout, geo in zip(dims[:-1], dims[1:], geometry):
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
        ws_ht=tuple(ws_ht), ws_dt=tuple(ws_dt), ws_wt=tuple(ws_wt), ws_floats=off,
        geometry=geometry, splits=tuple(splits), split_rows=tuple(split_rows),
        part_off=tuple(part_off), norm_splits=norm_splits, norm_split_rows=norm_rows,
        part_off_norm=part_off_norm, part_floats=part,
        head_blocks=-(-batch // _HEAD_THREADS),
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
                                  memory_bytes: Optional[int] = None) -> Optional[str]:
    """Why the wide fused epoch cannot train ``model`` with this optimizer
    and loss, or None when it can.

    The envelope: a SingleNN MLP hybrid in float32 with static or no input
    norm (trainable BatchNorm needs whole-batch statistics before the first
    layer, as in the JAX kernel), the 12 named activations, widths up to
    ``MAX_WIDE_WIDTH`` and at most ``MAX_LAYERS`` layers, a kernel-form
    mechanistic function; ``training_loss`` mse or mae with ``agg`` sum or
    mean and no ``extra_loss``; a single ``adam`` spec or an ``sgd`` spec
    without momentum. Any number of epochs per call; with ``tensors``, a
    batch of at most 65,535 row tiles of 64, and the activations and partial sums of one step within
    ``WORKSPACE_SHARE`` of the card's memory (``memory_bytes``, by default
    the memory of the model's CUDA device; unchecked on another device)."""
    reason = fused_forward_unsupported_reason(model, training=True, max_width=MAX_WIDE_WIDTH)
    if reason is not None:
        return reason
    if model.nn.input_batchnorm is True:  # an MLP: the shared checks refuse any other network
        return ("trainable input BatchNorm (input_batchnorm=True) is outside the wide kernel: "
                "it needs whole-batch statistics")
    if len(model.targets) > MAX_TARGETS:
        return f"{len(model.targets)} targets exceed the kernel's cap of {MAX_TARGETS}"
    reason = training_spec_reason(optimizer, logging, WIDE_LOSSES)
    if reason is not None:
        return reason
    if tensors is not None:
        if isinstance(tensors.x, dict) or tensors.x.ndim != 3:
            return (f"x of shape {tuple(getattr(tensors.x, 'shape', ()))}: the kernel takes "
                    "(num_batches, batch, F)")
        batch = int(tensors.weight.shape[1])
        if batch > _MAX_GRID_Y * _TILE:
            return (f"a batch of {batch} rows exceeds the {_MAX_GRID_Y * _TILE} that the products' "
                    "grid of row tiles takes")
        if memory_bytes is None:
            memory_bytes = _card_memory(model.device)
        if memory_bytes is not None:
            net = model.nn
            dims = (net.in_dim,) + net.hidden + (net.out_dim,)
            need = wide_layout(dims, net.norm is not None, batch).nbytes
            if need > WORKSPACE_SHARE * memory_bytes:
                return (f"a step's activations and partial sums take {need} bytes, more than "
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
        ("ws_off_a", ctypes.c_int64 * MAX_LAYERS),
        ("ws_off_d", ctypes.c_int64 * MAX_LAYERS),
        ("part_off", ctypes.c_int64 * MAX_LAYERS),
        ("part_off_norm", ctypes.c_int64),
        ("ws_off_ht", ctypes.c_int64 * MAX_LAYERS),
        ("ws_off_dt", ctypes.c_int64 * MAX_LAYERS),
        ("ws_off_wt", ctypes.c_int64 * MAX_LAYERS),
        ("n_epochs", ctypes.c_int),
        ("n_batches", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("acts", ctypes.c_int * MAX_LAYERS),
        ("norm_mode", ctypes.c_int),
        ("norm_eps", ctypes.c_float),
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
        ("loss_kind", ctypes.c_int),
        ("optimizer", _Optimizer),
        ("splits", ctypes.c_int * MAX_LAYERS),
        ("split_rows", ctypes.c_int * MAX_LAYERS),
        ("norm_splits", ctypes.c_int),
        ("norm_split_rows", ctypes.c_int),
        ("head_blocks", ctypes.c_int),
        ("tc", ctypes.c_int * MAX_LAYERS),
        ("fwd_bm", ctypes.c_int * MAX_LAYERS),
        ("fwd_bn", ctypes.c_int * MAX_LAYERS),
        ("fwd_splits", ctypes.c_int * MAX_LAYERS),
        ("fwd_split_k", ctypes.c_int * MAX_LAYERS),
        ("dat_bm", ctypes.c_int * MAX_LAYERS),
        ("dat_bn", ctypes.c_int * MAX_LAYERS),
        ("dat_splits", ctypes.c_int * MAX_LAYERS),
        ("dat_split_k", ctypes.c_int * MAX_LAYERS),
        ("wgt_bm", ctypes.c_int * MAX_LAYERS),
        ("wgt_bn", ctypes.c_int * MAX_LAYERS),
    ]


@dataclasses.dataclass(frozen=True)
class FusedWidePlan(PackedLayout):
    """Static layout of a wide model's packed parameters, plus what the
    kernels and their plain version read besides them."""

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
    loss: str

    @property
    def n_features(self) -> int:
        return self.dims[0]

    def offsets(self) -> Dict[str, Any]:
        """Offsets of every layer's weight and bias and of the first global."""
        return param_offsets(self.dims, self.has_norm)

    def layout(self, batch: int) -> WideLayout:
        return wide_layout(self.dims, self.has_norm, int(batch))

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernels' static arguments, packed once; each call fills in the
        pointers, the sizes and the batch's layout."""
        a = _Args()
        dims = self.dims
        a.n_layers = len(dims) - 1
        a.dims[: len(dims)] = dims
        a.acts[: len(self.acts)] = [_ACT_IDS[act] for act in self.acts]
        fill_common_args(a, self)
        a.n_params = self.n_params
        o = self.offsets()
        a.p_off_w[: len(o["p_w"])] = o["p_w"]
        a.p_off_b[: len(o["p_b"])] = o["p_b"]
        a.p_off_g = o["p_g"]
        a.loss_kind = _LOSS_KINDS[self.loss]
        return bytes(a)


def plan_fused_wide(model, optimizer, logging: LoggingLoss) -> FusedWidePlan:
    """Check the envelope and the kernel form (its outputs and partials on
    probe values) and lay out the model's parameters."""
    reason = fused_wide_unsupported_reason(model, optimizer, logging)
    if reason is not None:
        raise ValueError(f"model not supported by the wide fused epoch kernel: {reason}")
    net = model.nn
    names = [f"nn.layers.{i}.{leaf}" for i in range(len(net.layers)) for leaf in ("weight", "bias")]
    return FusedWidePlan(
        dims=(net.in_dim,) + net.hidden + (net.out_dim,),
        acts=tuple(layer.activation for layer in net.layers),
        **shared_plan_fields(model, optimizer, logging, names),
    )


# --------------------------------------------------------------------------
# loss scales and the plain version
# --------------------------------------------------------------------------

def batch_scales(plan: FusedWidePlan, data: FusedData, rows: torch.Tensor):
    """``(scale (E, nb, T), valid (E, nb))``: every step's loss scale per
    target, ``agg_scale / max(Σ mask, 1)`` over the whole batch, and its
    validity flag (a batch with no valid target changes nothing), from the
    masks and the row index alone."""
    epochs = rows.shape[0]
    idx = rows.long()
    counts = [mask[idx].reshape(epochs, data.n_batches, data.batch).sum(-1) for mask in data.mask]
    scale = torch.stack([plan.agg_scale / c.clamp_min(1.0) for c in counts], -1)
    valid = (torch.stack(counts).sum(0) > 0).to(torch.float32)
    return scale.to(torch.float32).contiguous(), valid.contiguous()


def fused_wide_reference(plan: FusedWidePlan, packed: FusedParams, opt_state, data: FusedData,
                         rows: torch.Tensor):
    """The plain PyTorch version of the kernels: ``rows.shape[0]`` epochs of
    ``data.n_batches`` steps over the rows ``rows[e, i·B : (i+1)·B]``, each
    the whole batch's forward, the cotangent with the loss scales of
    :func:`batch_scales`, the hand-written backward and the gated update.
    Returns ``(packed, opt_state, mean_loss)``; the loss is the last epoch's
    mean batch loss (a batch without valid targets counts 0)."""
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
            g, loss, _, _ = reference_grads(
                plan, p, bn, consts, data.x[idx],
                [c[idx] for c in data.forcing], [c[idx] for c in data.y],
                [c[idx] for c in data.mask], scale=list(scale[e, i]),
            )
            ok = valid[e, i] > 0
            p, slots, t = _reference_update(plan, p, slots, t, g, ok)
            epoch_loss = epoch_loss + torch.where(ok, loss, torch.zeros_like(loss))
    new_state = {**slots, "t": t.round().to(torch.int32)}
    return FusedParams(p, bn), new_state, epoch_loss / nb


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
    tc = [l for l, geo in enumerate(lay.geometry) if geo.route == TENSOR_CORES]
    dims = plan.dims
    tiles = sum(-(-dims[l] // _UPDATE_TILE) * -(-dims[l + 1] // _UPDATE_TILE) for l in tc)
    loose = plan.n_params - sum(dims[l] * dims[l + 1] for l in tc)
    return tiles + -(-(loose + 1) // 256)


def launch_fused_wide(plan: FusedWidePlan, packed: FusedParams, opt_state, data: FusedData,
                      rows: torch.Tensor, loss: torch.Tensor) -> None:
    """Enqueue every step of ``rows`` (``(epochs, num_batches · batch)``)
    with one call of the C launcher, updating ``packed`` and ``opt_state`` in
    place and writing the last epoch's mean batch loss into ``loss``; raises
    if a launch is refused. Counts calls in ``launch_fused_wide.launches``."""
    lib = _build.load_library()
    if lib.eh_fused_wide_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_wide_args_size()} != {ctypes.sizeof(_Args)}"
        )
    dev = data.x.device
    epochs = rows.shape[0]
    lay = plan.layout(data.batch)
    scale, valid = batch_scales(plan, data, rows)
    t0 = opt_state["t"].to(torch.float32)
    tcount = (t0 + torch.cumsum(valid.reshape(-1), 0)).contiguous()
    ws = torch.empty((lay.ws_floats,), dtype=torch.float32, device=dev)
    partials = torch.empty((max(lay.part_floats, 1),), dtype=torch.float32, device=dev)
    n_glob = len(plan.global_names)
    head_partials = torch.empty((lay.head_blocks, 1 + n_glob), dtype=torch.float32, device=dev)
    epoch_loss = torch.zeros((epochs,), dtype=torch.float32, device=dev)

    a = _Args.from_buffer_copy(plan.args_bytes)
    a.x = data.x.data_ptr()
    for i, c in enumerate(data.forcing):
        a.forcing[i] = c.data_ptr()
    for i, (yc, mc) in enumerate(zip(data.y, data.mask)):
        a.y[i], a.mask[i] = yc.data_ptr(), mc.data_ptr()
    a.perm = rows.data_ptr()
    a.scale, a.valid, a.tcount = scale.data_ptr(), valid.data_ptr(), tcount.data_ptr()
    a.params, a.bn = packed.params.data_ptr(), packed.bn.data_ptr()
    a.m, a.v = opt_state["m"].data_ptr(), opt_state["v"].data_ptr()
    a.u = slot_u(plan, opt_state)
    a.consts = plan.consts.data_ptr()
    a.ws, a.partials = ws.data_ptr(), partials.data_ptr()
    a.head_partials, a.epoch_loss = head_partials.data_ptr(), epoch_loss.data_ptr()
    a.n_rows = data.x.shape[0]
    a.n_epochs, a.n_batches, a.batch = epochs, data.n_batches, data.batch
    n_layers = len(plan.dims) - 1
    a.ws_off_h0, a.ws_off_xhat, a.ws_off_d0 = lay.ws_h0, lay.ws_xhat, lay.ws_d0
    a.ws_off_a[:n_layers] = lay.ws_a
    a.ws_off_d[:n_layers] = lay.ws_d
    a.part_off[:n_layers] = lay.part_off
    a.part_off_norm = lay.part_off_norm
    a.splits[:n_layers] = lay.splits
    a.split_rows[:n_layers] = lay.split_rows
    a.norm_splits, a.norm_split_rows = lay.norm_splits, lay.norm_split_rows
    a.head_blocks = lay.head_blocks
    fill_geometry(a, lay)
    if plan.opt_name == "lamb":  # a row of leaf norms per update block (eh_wide_update_kernel)
        lamb_parts = torch.empty((update_blocks(plan, lay), 2 * a.optimizer.n_leaves),
                                 dtype=torch.float32, device=dev)
        a.lamb_parts = lamb_parts.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.eh_fused_wide(ctypes.byref(a), stream)
    if rc != 0:
        raise RuntimeError(
            f"wide fused epoch kernel launch failed: {lib.eh_cuda_error_string(rc).decode()}")
    opt_state["t"].copy_(tcount[-1:].round().to(torch.int32))
    loss.copy_(epoch_loss[-1:] / data.n_batches)
    launch_fused_wide.launches += 1


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


class FusedWideEpoch(FusedEpoch):
    """:class:`~easyhybrid_tpu_torch.ops.fused_epoch.FusedEpoch` for an MLP
    hybrid too wide for one block: ``epochs_per_call`` epochs in one call of
    kernel 3's launcher on CUDA tensors, :func:`fused_wide_reference` on CPU
    tensors."""

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
