"""The cluster-split form of kernel 4: fused training epochs of an LSTM
hybrid whose state one thread block cannot hold, a hand-written CUDA kernel
for Hopper (``csrc/fused_lstm_split.cu``).

Counterpart, for those models, of ``kernel_body_lstm`` in
``easyhybrid_tpu/ops/fused_epoch.py``, which trains an LSTM of any hidden
size and feature count over windows of up to 32 steps. The one-block form
(``ops/fused_epoch_lstm.py``) keeps every parameter and its gradient in each
block; this form splits the hidden units over a thread-block cluster: block
r owns units ``[r U, (r + 1) U)``, their gate rows of ``wi``, ``wh`` and
``b`` and their gradients, and the blocks exchange ``h`` forward and the
parts of ``wh^T dz`` backward through distributed shared memory each time
step, with the ``(x, h, c)`` checkpoints and the gates in a device
workspace. :func:`~.fused_epoch_lstm.lstm_form` picks the form by size
alone; ``ops/fused_epoch.py::fused_engine`` routes by it.

What it takes: hidden sizes up to 256 and up to 64 features, with or
without the static input norm, windows up to 32 steps, up to 8 outputs and
4 targets, every loss of the JAX kernel (mse, mae, nseLoss, a traced
``ElementwiseLoss``, and the two-pass rmse, pearsonLoss, kgeLoss,
pbkgeLoss), every optimizer rule of kernel 4, any batch, shuffle mode and
number of epochs per call, the halt word. It has no member axis (ROADMAP
queue B, item 5): a population of such models runs the torch engine.

The packed layout, the data layout and the plain version are the one-block
form's (:func:`~.fused_epoch_lstm.fused_lstm_reference`): on CPU tensors the
wrapper computes the plain version; on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, NamedTuple, Optional

import torch

from ..losses.specs import LoggingLoss
from . import _build
from .fused_epoch import (
    LOSS_KINDS,
    MAX_LEAVES,
    MAX_SMEM_BYTES,
    MAX_TARGETS,
    FusedEpoch,
    FusedParams,
    _Optimizer,
    check_halt,
    fill_common_args,
    slot_u,
)
from .fused_epoch_lstm import (
    FusedLSTMData,
    FusedLSTMPlan,
    fused_lstm_data,
    fused_lstm_reference,
    lstm_form,
    lstm_reason,
    plan_fields,
    window_of,
)
from .fused_forward import _ACT_IDS, MAX_ARGS, MAX_FORCING

__all__ = [
    "FusedLSTMSplitEpoch",
    "FusedLSTMSplitPlan",
    "SplitGeometry",
    "fused_lstm_split_unsupported_reason",
    "launch_fused_lstm_split",
    "make_fused_lstm_split_epoch",
    "split_smem_floats",
    "stage_cycles",
    "supports_fused_lstm_split",
]

# caps of the kernel; they must equal the EHS_* defines of csrc/fused_lstm_split.cu
# (MAX_HIDDEN, kernel 4's, is EHS_MAX_HIDDEN)
MAX_STEPS = 32  # the JAX kernel's EASYHYBRID_LSTM_FUSED_MAX_T
MAX_CLUSTER = 16
THREADS = 512  # EHS_MAX_THREADS, the blocks' threads
MAX_WINDOWS = 64  # the largest tile the geometry picks


# --------------------------------------------------------------------------
# geometry and envelope
# --------------------------------------------------------------------------

def _up4(n: int) -> int:
    return (n + 3) & ~3


def split_smem_floats(f: int, h: int, p: int, g: int, k: int, *, cluster: int,
                      windows: int) -> int:
    """Shared-memory floats of one block of the split form (``ehs_smem`` in
    csrc/fused_lstm_split.cu computes the same): the block's gate rows and
    their gradients, the head, the norm, the globals and their gradients, the
    loss scales, and the tile's inputs, received ``dh`` parts, ``dz`` (in
    two layouts), carried ``c`` and the normed input's cotangent."""
    units = -(-h // cluster)
    rows, cols = 4 * units, f + h + 1
    ldw = rows | 1
    ldv = _up4(cols + f)
    fixed = (2 * cols * ldw + p * h + 2 * f + p + g + (g + k) + g + 2 * f + (2 * p + 2 * g + k)
             + p * units + (p + g) + 2 * f + 12 * MAX_TARGETS + 8 + 32 + 3 * MAX_LEAVES)
    xh = max(2 * (f + h) * windows, ldv * windows)
    return (_up4(fixed) + _up4(xh) + _up4(2 * cluster * windows * units)
            + 2 * _up4(windows * rows) + _up4(windows * units) + _up4(windows * f) + windows)


class SplitGeometry(NamedTuple):
    """How one launch of the split form is cut: ``cluster`` blocks of
    ``threads`` threads, each owning ``units`` hidden units; a batch's
    windows walked in ``tiles`` tiles of ``windows`` windows (a multiple of
    4)."""

    threads: int
    cluster: int
    units: int
    windows: int
    tiles: int


def _most_windows(f, h, p, g, k, cluster) -> int:
    """The largest tile (a multiple of 4, at most ``MAX_WINDOWS``) whose
    block fits shared memory; 0 when not even 4 windows do."""
    most = MAX_WINDOWS
    while most >= 4 and split_smem_floats(f, h, p, g, k, cluster=cluster,
                                          windows=most) * 4 > MAX_SMEM_BYTES:
        most -= 4
    return max(most, 0)


def split_fits(model) -> bool:
    """Whether a block of the split form holds the model's share at a tile of
    4 windows, and so at every batch size."""
    net = model.nn
    return _most_windows(net.in_dim, net.hidden_size, net.out_dim, len(model.global_param_names),
                         len(model.fixed_param_names), MAX_CLUSTER) >= 4


def fused_lstm_split_unsupported_reason(model, optimizer, logging: LoggingLoss,
                                        tensors=None) -> Optional[str]:
    """Why the split form cannot train ``model`` with this optimizer and
    loss, or None when it can: kernel 4's envelope
    (:func:`~.fused_epoch_lstm.fused_epoch_lstm_unsupported_reason`) with
    hidden sizes up to 256, windows up to 32 steps, and a model the one-block
    form does not take (:func:`~.fused_epoch_lstm.lstm_form`)."""
    reason = lstm_reason(model, optimizer, logging, tensors)
    if reason is not None:
        return reason
    steps, out_steps = window_of(tensors)
    if steps > MAX_STEPS:
        return (f"a window of {steps} steps exceeds the split form's cap of {MAX_STEPS} (the JAX "
                "kernel's)")
    if lstm_form(model, steps, out_steps) != "split":
        return "the one-block form of kernel 4 takes this model and window"
    if not split_fits(model):
        return "a block of the split form cannot hold the model's share of the parameters"
    return None


def supports_fused_lstm_split(model, optimizer, logging: LoggingLoss, tensors=None) -> bool:
    return fused_lstm_split_unsupported_reason(model, optimizer, logging, tensors) is None


class _SplitArgs(ctypes.Structure):
    """Mirror of ``struct EhLstmSplitArgs`` in csrc/fused_lstm_split.cu."""

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
        ("n_steps", ctypes.c_int),
        ("n_out_steps", ctypes.c_int),
        ("n_features", ctypes.c_int),
        ("hidden", ctypes.c_int),
        ("n_out", ctypes.c_int),
        ("head_act", ctypes.c_int),
        ("norm_mode", ctypes.c_int),
        ("norm_eps", ctypes.c_float),
        ("n_params", ctypes.c_int),
        ("p_off_wi", ctypes.c_int),
        ("p_off_wh", ctypes.c_int),
        ("p_off_b", ctypes.c_int),
        ("p_off_hw", ctypes.c_int),
        ("p_off_hb", ctypes.c_int),
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
        ("loss_kind", ctypes.c_int),
        ("loss_nse", ctypes.c_int),
        ("loss_sum", ctypes.c_int),
        ("optimizer", _Optimizer),
        ("halt", ctypes.c_void_p),
        ("threads", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("units", ctypes.c_int),
        ("windows", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("work", ctypes.c_void_p),
        ("work_floats", ctypes.c_int64),
    ]


@dataclasses.dataclass(frozen=True)
class FusedLSTMSplitPlan(FusedLSTMPlan):
    """:class:`~.fused_epoch_lstm.FusedLSTMPlan` (the same packed layout) with
    the split form's geometry; ``cluster``, when set, is a measurement's
    cluster size (else :data:`MAX_CLUSTER`)."""

    def geometry(self, batch: int, steps: int = 1, out_steps: int = 1) -> SplitGeometry:
        """How a launch over batches of ``batch`` windows is cut: a pure
        function of the plan and the batch (the window lives in the device
        workspace). The cluster's blocks own ``ceil(H / cluster)`` units
        each; the tile is the largest multiple of 4 windows, up to
        ``MAX_WINDOWS``, that fits shared memory, evened out over the
        batch's tiles."""
        cluster = self.cluster or MAX_CLUSTER
        f, h, p = self.in_dim, self.hidden, self.out_dim
        g, k = len(self.global_names), len(self.fixed_names)
        most = _most_windows(f, h, p, g, k, cluster)
        if most < 4:
            raise ValueError(f"hidden size {h} with {f} features does not fit a block of the "
                             f"split form's cluster of {cluster}")
        tiles = -(-batch // most)
        windows = _up4(-(-batch // tiles))
        return SplitGeometry(THREADS, cluster, -(-h // cluster), windows, tiles)

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernel's static arguments, packed once; each launch fills in
        the pointers, the sizes, the geometry and the workspace."""
        a = _SplitArgs()
        fill_common_args(a, self)
        a.n_features, a.hidden, a.n_out = self.in_dim, self.hidden, self.out_dim
        a.head_act = _ACT_IDS[self.head_act]
        a.n_params = self.n_params
        o = self.offsets()
        a.p_off_wi, a.p_off_wh, a.p_off_b = o["wi"], o["wh"], o["b"]
        a.p_off_hw, a.p_off_hb, a.p_off_g = o["hw"], o["hb"], o["g"]
        a.agg_scale = self.agg_scale
        a.loss_kind = LOSS_KINDS[self.loss]
        a.loss_nse = int(self.loss == "nseLoss")
        a.loss_sum = int(self.loss_form is not None and self.loss_form.normalize == "sum")
        return bytes(a)


def plan_fused_lstm_split(model, optimizer, logging: LoggingLoss) -> FusedLSTMSplitPlan:
    """Check the split form's envelope (at any window) and the kernel form
    (its outputs and partials on probe values) and lay out the parameters."""
    reason = lstm_reason(model, optimizer, logging, None)
    if reason is None and not split_fits(model):
        reason = "a block of the split form cannot hold the model's share of the parameters"
    if reason is not None:
        raise ValueError(f"model not supported by the split form of the fused LSTM kernel: {reason}")
    return FusedLSTMSplitPlan(**plan_fields(model, optimizer, logging, width=model.nn.hidden_size))


def work_floats(plan: FusedLSTMSplitPlan, batch: int, steps: int, out_steps: int,
                geometry: SplitGeometry) -> int:
    """Floats of the device workspace (``ehs_work_floats`` in the source): the
    checkpoints ``h``, ``c`` and the gates, ``B T 6H``, then per block the
    tile's head and global cotangents and loss terms and the batch's
    predictions."""
    pairs = geometry.windows * out_steps
    per_block = (pairs * (plan.out_dim + len(plan.global_names) + 1)
                 + len(plan.target_names) * batch * out_steps)
    return batch * steps * 6 * plan.hidden + geometry.cluster * per_block


# --------------------------------------------------------------------------
# kernel launch and the epoch function
# --------------------------------------------------------------------------

def launch_args(plan: FusedLSTMSplitPlan, packed: FusedParams, opt_state, data: FusedLSTMData,
                rows: torch.Tensor, loss: torch.Tensor, work: torch.Tensor, *,
                halt=None) -> _SplitArgs:
    """The kernel's argument struct for a launch (see
    :func:`launch_fused_lstm_split`); raises on a window past the cap or
    shapes the kernel does not read."""
    steps, out_steps = data.x.shape[1], data.y[0].shape[1]
    if steps > MAX_STEPS:
        raise ValueError(f"a window of {steps} steps exceeds the split form's cap of {MAX_STEPS}")
    if packed.params.dim() != 1 or rows.dim() != 2:
        raise ValueError("the split form of the fused LSTM kernel has no member axis")
    if packed.params.shape[0] != plan.n_params or rows.shape[-1] < data.n_batches * data.batch:
        raise ValueError(f"parameters of shape {tuple(packed.params.shape)} and rows of shape "
                         f"{tuple(rows.shape)} do not fit the plan")
    geometry = plan.geometry(data.batch, steps, out_steps)
    need = work_floats(plan, data.batch, steps, out_steps, geometry)
    if work.numel() < need:
        raise ValueError(f"a workspace of {work.numel()} floats; the launch needs {need}")
    a = _SplitArgs.from_buffer_copy(plan.args_bytes)
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
    a.n_rows = rows.shape[-1]  # the epoch stride of a row index
    a.n_epochs = rows.shape[0]
    a.n_batches, a.batch = data.n_batches, data.batch
    a.n_steps, a.n_out_steps = steps, out_steps
    a.threads, a.cluster, a.units = geometry.threads, geometry.cluster, geometry.units
    a.windows, a.tiles = geometry.windows, geometry.tiles
    a.work, a.work_floats = work.data_ptr(), work.numel()
    a.halt = check_halt(halt, data.x.device)
    return a


def launch_fused_lstm_split(plan: FusedLSTMSplitPlan, packed: FusedParams, opt_state,
                            data: FusedLSTMData, rows: torch.Tensor, loss: torch.Tensor, *,
                            lib=None, halt=None, member_opt=None) -> None:
    """Launch the CUDA kernel once over ``rows.shape[0]`` epochs, updating
    ``packed`` and ``opt_state`` in place and writing the mean loss into
    ``loss``; raises if the launch is refused. The workspace is allocated
    here on the launch's stream. Counts launches in
    ``launch_fused_lstm_split.launches``; ``lib`` is a measuring build in
    place of the package's library, whose launches are not counted. ``halt``
    is the halt word (``ops/fused_epoch.py``): a halted launch writes
    nothing."""
    if member_opt is not None:
        raise ValueError("the split form of the fused LSTM kernel has no member axis")
    steps, out_steps = data.x.shape[1], data.y[0].shape[1]
    geometry = plan.geometry(data.batch, steps, out_steps)
    work = torch.empty((work_floats(plan, data.batch, steps, out_steps, geometry),),
                       dtype=torch.float32, device=data.x.device)
    a = launch_args(plan, packed, opt_state, data, rows, loss, work, halt=halt)
    measuring = lib is not None
    lib = lib or _build.kernel_library("fused_lstm_split.cu", plan.form, plan.loss_form)
    if lib.eh_fused_lstm_split_args_size() != ctypes.sizeof(_SplitArgs):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_lstm_split_args_size()} != {ctypes.sizeof(_SplitArgs)}")
    with torch.cuda.device(data.x.device):
        stream = torch.cuda.current_stream(data.x.device).cuda_stream
        rc = lib.eh_fused_lstm_split(ctypes.byref(a), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused LSTM split kernel launch failed: {lib.eh_cuda_error_string(rc).decode()}")
    if not measuring:
        launch_fused_lstm_split.launches += 1


launch_fused_lstm_split.launches = 0

# the stamped build's stages, by stamp index (ehs_stamps in the source)
STAGES = ("step start", "forward products", "forward cells and exchange", "forward barrier",
          "two-pass moments", "head", "backward cotangents and rows", "backward products",
          "weight gradients", "norm gradient", "backward barrier", "update")


def stage_cycles(fn: "FusedLSTMSplitEpoch", packed: FusedParams, opt_state, tensors,
                 perms=None) -> Dict[str, int]:
    """One launch of the stamped build of the split form on CUDA tensors: the
    ``clock64()`` cycles thread 0 of the first block spent in each stage
    (:data:`STAGES`), summed over the launch, and ``"kernel"``, the cycles
    of the whole launch. For measurement only; the result is dropped."""
    plan = fn.plan
    data = fn._make_data(plan, tensors)
    rows = fn.rows(tensors, perms)
    packed = FusedParams(packed.params.clone(), packed.bn.clone())
    opt_state = {k: v.clone() for k, v in opt_state.items()}
    loss = torch.empty((1,), dtype=torch.float32, device=data.x.device)
    lib = _build.measuring_library("fused_lstm_split.cu", "eh_fused_lstm_split", "-DEHS_STAMPS")
    launch_fused_lstm_split(plan, packed, opt_state, data, rows, loss, lib=lib)
    torch.cuda.synchronize(data.x.device)
    stamps = (ctypes.c_longlong * (len(STAGES) + 1))()
    rc = lib.eh_fused_lstm_split_stamps(stamps)
    if rc != 0:
        raise RuntimeError(f"reading the stage stamps failed: CUDA error {rc}")
    return dict(zip(STAGES + ("kernel",), list(stamps)))


class FusedLSTMSplitEpoch(FusedEpoch):
    """:class:`~easyhybrid_tpu_torch.ops.fused_epoch.FusedEpoch` for an LSTM
    hybrid of the split form on sequence epoch tensors ``x (num_batches,
    batch, T, F)``: ``epochs_per_call`` epochs in one launch of
    ``csrc/fused_lstm_split.cu`` on CUDA tensors,
    :func:`~.fused_epoch_lstm.fused_lstm_reference` on CPU tensors."""

    _make_plan = staticmethod(plan_fused_lstm_split)
    _make_data = staticmethod(fused_lstm_data)
    _reference = staticmethod(fused_lstm_reference)
    _launch = staticmethod(launch_fused_lstm_split)


def make_fused_lstm_split_epoch(model, optimizer, logging: LoggingLoss, *, shuffle=True,
                                epochs_per_call: int = 1) -> FusedLSTMSplitEpoch:
    """Build the split form's fused epoch of an LSTM hybrid (see
    :class:`FusedLSTMSplitEpoch`); raises if the model, optimizer or loss is
    outside the envelope or the kernel form's probe check fails."""
    return FusedLSTMSplitEpoch(model, optimizer, logging, shuffle=shuffle,
                               epochs_per_call=epochs_per_call)
