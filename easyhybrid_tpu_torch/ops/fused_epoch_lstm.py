"""Fused training epochs of the LSTM sequence hybrid: a hand-written CUDA
kernel for Hopper (kernel 4).

Counterpart of ``kernel_body_lstm`` in ``easyhybrid_tpu/ops/fused_epoch.py``
(the LSTM body of ``make_fused_epoch``). One launch of
``csrc/fused_epoch_lstm.cu`` runs ``epochs_per_call`` epochs x
``num_batches`` optimizer steps of a SingleNN hybrid whose network is an
:class:`~easyhybrid_tpu_torch.models.nn.LSTMNet`: the permutation gather of
the batch's windows, the static input norm (with its trained scale and
bias) or none, the recurrence over the ``T`` steps of the input window, the
Dense head, the sigmoid bound scaling and the mechanistic model in its
kernel form at the trailing ``T_out`` steps, the masked loss over the whole
``(T_out x batch)`` window (``mse``, ``mae`` or ``nseLoss``) and its
cotangent, the hand-written backward through time from per-step ``(x, h,
c)`` checkpoints (the kernel keeps the gates as well, the plain version
recomputes them), the batch-validity gate and the update by any optax rule
of the JAX kernel (``ops/fused_epoch.py``'s ``_OPTS``; lamb's per-leaf norms
are summed across the cluster's blocks in rank order).

The packed layout (:class:`FusedLSTMPlan`, same scheme as kernel 2's):

* ``params``: ``[norm scale (F), norm bias (F)]`` with an input norm, then
  ``wi (4H, F)``, ``wh (4H, H)``, ``b (4H)``, the head's ``W (P, H)`` and
  ``b (P)``, all row-major, then the raw globals (G);
* ``bn``, ``opt_state`` and ``consts`` as in ``ops/fused_epoch.py``.

The window is bounded by shared memory, not by a constant: the envelope
admits a window when 8 of its rows of ``(x, h, c)`` checkpoints fit in 227 KB
beside one block's parameters and gradients by the rule the kernel was first
built with (:func:`lstm_tile_rows`), so that what the kernel takes neither
shrank nor grew when it was redesigned. How a launch is cut is
:meth:`FusedLSTMPlan.geometry`, a pure function of the plan, the batch and
the window: a window's recurrence in ``min(32, width)`` lanes of one warp, a
block's windows at once, a thread-block cluster over the batch's windows,
tiles walked only beyond that. ``csrc/fused_epoch_lstm.cu`` says what each
choice is for.

:func:`fused_lstm_reference` is the same algorithm in plain PyTorch on the
same layout, the backward written by hand (no autograd). On CPU tensors the
wrapper computes it; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..data.loaders import EpochTensors
from ..losses.specs import LoggingLoss
from ..models.hybrid import SingleNNHybridModel
from ..models.nn import LSTMNet
from . import _build
from .fused_epoch import (
    MAX_SMEM_BYTES,
    MAX_TARGETS,
    FusedEpoch,
    FusedParams,
    PackedLayout,
    _act_and_grad,
    _Optimizer,
    _reference_update,
    fill_common_args,
    form_args,
    opt_slots,
    reference_cotangents,
    shared_plan_fields,
    slot_u,
    split_consts,
    training_spec_reason,
)
from .fused_forward import (
    MAX_ARGS,
    MAX_FORCING,
    MAX_WIDTH,
    _ACT_IDS,
    float32_reason,
    mechanistic_reason,
)

__all__ = [
    "FusedLSTMEpoch",
    "FusedLSTMPlan",
    "LSTM_LOSSES",
    "fused_epoch_lstm_unsupported_reason",
    "fused_lstm_reference",
    "launch_fused_lstm",
    "lstm_tile_rows",
    "make_fused_lstm_epoch",
    "stage_cycles",
    "supports_fused_epoch_lstm",
]

# caps of the kernel; they must equal the EH_LSTM_* / EHL_* defines of
# csrc/fused_epoch_lstm.cu (MAX_CLUSTER is EH_LSTM_MAX_CLUSTER)
MAX_LSTM_OUT = 8
_MAX_THREADS = 256  # EHL_MAX_THREADS: threads a block may have
_HIDDEN_WIDTHS = (8, 16, 32, 64)  # the kernel's compile-time hidden sizes
# the plan's largest cluster (beyond the portable 8: the H100 co-schedules 16
# blocks of one cluster)
MAX_CLUSTER = 16
# the envelope's rule: the tiles of the kernel's first form, one block of 512
# threads with two partials each
LSTM_THREADS = 512
LSTM_TILE_ROWS = (128, 64, 32, 16, 8)
LSTM_LOSSES = ("mse", "mae", "nseLoss")  # the single-pass losses
_LOSS_KINDS = {"mse": 0, "nseLoss": 0, "mae": 1}  # squared or absolute differences
_SST_EPS = 1e-12  # the floor of nseLoss's denominator (losses/metrics.py)


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

class _Sizes(NamedTuple):
    """What the kernel's shared memory depends on: the packed parameter
    count, features, hidden size, network outputs, globals, fixed values,
    targets and whether there is an input norm."""

    n_params: int
    f: int
    h: int
    p: int
    g: int
    k: int
    t: int
    norm: bool

    def res_floats(self, steps: int, out_steps: int) -> int:
        """Floats a tile row keeps: the ``(x, h, c)`` checkpoints of every
        step (and the normalised input beside the affine one with a norm),
        one step's gate cotangents, the carried ``dh`` and ``dc``, the head
        cotangents of the trailing steps, the row's global cotangents and,
        with a norm, its scale and bias gradients."""
        f = 2 * self.f if self.norm else self.f
        return (steps * (2 * self.h + f) + 6 * self.h + out_steps * self.p + self.g
                + (2 * self.f if self.norm else 0))

    def smem_bytes(self, steps: int, out_steps: int, tile_rows: int) -> int:
        """Shared memory of one launch; the launcher computes the same."""
        fixed = (2 * self.n_params + 2 * self.f + (2 * self.p + 2 * self.g + self.k)
                 + (self.g + self.k) + self.g + 2 * self.f + self.t + 4 + 2 * LSTM_THREADS)
        return 4 * (fixed + self.res_floats(steps, out_steps) * (tile_rows + 1))

    def tile_rows(self, steps: int, out_steps: int) -> Optional[int]:
        """Rows of the largest tile that fits, or None when none does: the
        envelope (the kernel takes a window when this is not None)."""
        for rows in LSTM_TILE_ROWS:
            if self.smem_bytes(steps, out_steps, rows) <= MAX_SMEM_BYTES:
                return rows
        return None

    def pair_features(self) -> int:
        """Features of a (window, step) pair in the kernel's pair arrays
        (``ehl_tile``): the cell's input and a 1 (and with a norm the
        normalised input and its cotangent), h, c and the four gates, which
        the backward overwrites with their cotangents."""
        return (3 * self.f if self.norm else self.f) + 6 * self.h + 1

    def smem_floats(self, steps: int, out_steps: int, windows: int, lanes: int) -> int:
        """Shared-memory floats of one launch of the kernel with blocks
        holding ``windows`` windows of ``lanes`` lanes at once;
        ``ehl_smem_floats`` in csrc/fused_epoch_lstm.cu computes the same."""
        def ld(cols):
            return cols | 1

        warps = -(-windows * lanes // 32)
        return (2 * self.n_params + 2 * self.f + (2 * self.p + 2 * self.g + self.k)
                + (self.g + self.k) + self.g + 2 * self.f + 10 + warps * (6 * self.t + 1)
                + self.pair_features() * ld((steps + 1) * windows)
                + self.p * ld(out_steps * windows) + self.g * ld(min(lanes, out_steps) * windows))


def _sizes(model) -> _Sizes:
    net = model.nn
    f, h, p, g = net.in_dim, net.hidden_size, net.out_dim, len(model.global_param_names)
    n_params = (2 * f if net.norm is not None else 0) + 4 * h * (f + h + 1) + p * (h + 1) + g
    return _Sizes(n_params, f, h, p, g, len(model.fixed_param_names), len(model.targets),
                  net.norm is not None)


def lstm_tile_rows(model, steps: int, out_steps: int = 1) -> Optional[int]:
    """Rows of the largest tile whose checkpoints fit in shared memory for an
    input window of ``steps`` and an output window of ``out_steps``, or None
    when not even the smallest tile fits."""
    return _sizes(model).tile_rows(steps, out_steps)


def _window(tensors) -> Tuple[int, int]:
    """``(T, T_out)`` of sequence epoch tensors ``x (nb, B, T, F)``."""
    y = next(iter(tensors.y.values()))
    return int(tensors.x.shape[2]), int(y.shape[2]) if y.ndim > 2 else 0


def fused_epoch_lstm_unsupported_reason(model, optimizer, logging: LoggingLoss,
                                        tensors=None) -> Optional[str]:
    """Why the fused LSTM epoch kernel cannot train ``model`` with this
    optimizer and loss, or None when it can.

    The envelope: a :class:`SingleNNHybridModel` whose network is an
    :class:`LSTMNet` in float32 with ``input_batchnorm`` ``"static"`` or
    False; a mechanistic function with a kernel form; ``training_loss``
    mse, mae or nseLoss with ``agg`` sum or mean and no ``extra_loss``; an
    optimizer the kernels run (``fused_epoch.optimizer_reason``); hidden size
    and features up to 64, up to 8 network outputs. With ``tensors``: ``x``
    of shape ``(num_batches, batch, T, F)`` and windowed targets, with a
    window whose checkpoints fit in shared memory (:func:`lstm_tile_rows`).
    Any batch size, shuffle mode and number of epochs per call."""
    if not isinstance(model, SingleNNHybridModel):
        return f"{type(model).__name__} is not a SingleNNHybridModel"
    net = model.nn
    if net is None or not model.neural_param_names:
        return "the model has no neural network"
    if not isinstance(net, LSTMNet):
        return f"the network is a {type(net).__name__}, not an LSTMNet"
    if net.input_batchnorm is True:
        return ("trainable input BatchNorm (input_batchnorm=True: batch statistics over "
                "(batch, time)) is outside the LSTM kernel")
    reason = float32_reason(model)
    if reason is not None:
        return reason
    act = net.output_activation
    if not isinstance(act, str) or act not in _ACT_IDS:
        return f"output activation {act!r} is not one of the kernel's {len(_ACT_IDS)} names"
    if max(net.in_dim, net.hidden_size) > MAX_WIDTH:
        return (f"{net.in_dim} features and hidden size {net.hidden_size} exceed the kernel's "
                f"cap of {MAX_WIDTH}")
    if net.out_dim > MAX_LSTM_OUT:
        return f"{net.out_dim} network outputs exceed the LSTM kernel's cap of {MAX_LSTM_OUT}"
    if len(model.targets) > MAX_TARGETS:
        return f"{len(model.targets)} targets exceed the kernel's cap of {MAX_TARGETS}"
    reason = mechanistic_reason(model) or training_spec_reason(optimizer, logging, LSTM_LOSSES)
    if reason is not None:
        return reason
    steps, out_steps = (1, 1) if tensors is None else _window(tensors)
    if tensors is not None and (tensors.x.ndim != 4 or out_steps == 0):
        return (f"x of shape {tuple(tensors.x.shape)} is not (num_batches, batch, time, "
                "features) with windowed targets")
    if out_steps > steps:
        return f"the output window ({out_steps}) is longer than the input window ({steps})"
    if lstm_tile_rows(model, steps, out_steps) is None:
        need = _sizes(model).smem_bytes(steps, out_steps, LSTM_TILE_ROWS[-1])
        return (f"a window of {steps} steps at hidden size {net.hidden_size} needs {need} bytes "
                f"of shared memory for a tile of {LSTM_TILE_ROWS[-1]} rows; the kernel has "
                f"{MAX_SMEM_BYTES}")
    return None


def supports_fused_epoch_lstm(model, optimizer, logging: LoggingLoss, tensors=None) -> bool:
    return fused_epoch_lstm_unsupported_reason(model, optimizer, logging, tensors) is None


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``struct EhFusedLstmArgs`` in csrc/fused_epoch_lstm.cu."""

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
        ("optimizer", _Optimizer),
        ("threads", ctypes.c_int),
        ("lanes", ctypes.c_int),
        ("windows", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("stages", ctypes.c_int),
        ("res_floats", ctypes.c_int),
    ]


class LSTMGeometry(NamedTuple):
    """How one launch of kernel 4 is cut: ``cluster`` blocks of ``threads``
    threads share a batch's windows; a window has ``lanes`` lanes of one warp
    (a lane a hidden unit, two at width 64); a block holds ``windows``
    windows at once and walks ``tiles`` of them a step; with ``stages`` 0 the
    windows are read in place."""

    threads: int
    lanes: int
    windows: int
    cluster: int
    tiles: int
    stages: int = 0


@dataclasses.dataclass(frozen=True)
class FusedLSTMPlan(PackedLayout):
    """Static layout of an LSTM hybrid's packed parameters, plus what the
    kernel and its plain version read besides them."""

    in_dim: int
    hidden: int
    out_dim: int
    head_act: str
    width: int  # the kernel's compile-time hidden size
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
    segments: Tuple[Tuple[str, int, Tuple[int, ...]], ...]
    n_params: int
    consts: torch.Tensor
    agg_scale: float
    opt_name: str
    hyper: Tuple[Tuple[str, float], ...]
    loss: str
    cluster: int = 0  # the cluster size when set (a measurement's), else by the batch

    @property
    def n_features(self) -> int:
        return self.in_dim

    def geometry(self, batch: int, steps: int, out_steps: int = 1) -> LSTMGeometry:
        """How kernel 4 cuts a launch over batches of ``batch`` windows of
        ``steps`` steps with ``out_steps`` trailing ones: a pure function of
        the plan, the batch and the window. ``min(32, width)`` lanes a window;
        a block holds as many windows as ``_MAX_THREADS`` threads and the
        shared memory beside the state allow, in whole warps where a warp's
        windows fit; the cluster is the fewest blocks that hold the batch (a
        power of two up to ``MAX_CLUSTER``), or the plan's own. A batch
        beyond that walks tiles."""
        sizes = self.sizes
        lanes = min(32, self.width)
        per_warp = 32 // lanes

        def fits(windows):
            return sizes.smem_floats(steps, out_steps, windows, lanes) * 4 <= MAX_SMEM_BYTES

        most = _MAX_THREADS // lanes
        while most > per_warp and not fits(most):
            most -= per_warp
        while most > 1 and not fits(most):  # a warp that is not full
            most -= 1
        if not fits(most):
            raise ValueError(f"a window of {steps} steps at hidden size {self.hidden} does not fit "
                             "the fused LSTM kernel's shared memory")
        cluster = self.cluster
        if not cluster:
            cluster = 1
            while cluster < MAX_CLUSTER and cluster * most < batch:
                cluster *= 2
        block = -(-batch // cluster)
        windows = min(most, -(-block // per_warp) * per_warp)
        threads = -(-windows * lanes // 32) * 32
        return LSTMGeometry(threads, lanes, windows, cluster, -(-block // windows), 0)

    def offsets(self) -> Dict[str, int]:
        """Offsets of the parameter segments in the packed vector."""
        f, h, p = self.in_dim, self.hidden, self.out_dim
        wi = 2 * f if self.has_norm else 0
        wh = wi + 4 * h * f
        b = wh + 4 * h * h
        hw = b + 4 * h
        hb = hw + p * h
        return dict(wi=wi, wh=wh, b=b, hw=hw, hb=hb, g=hb + p)

    @property
    def sizes(self) -> _Sizes:
        return _Sizes(self.n_params, self.in_dim, self.hidden, self.out_dim,
                      len(self.global_names), len(self.fixed_names), len(self.target_names),
                      self.has_norm)

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernel's static arguments, packed once; each launch fills in
        the pointers, the sizes and the window's tile."""
        a = _Args()
        fill_common_args(a, self)
        a.n_features, a.hidden, a.n_out = self.in_dim, self.hidden, self.out_dim
        a.head_act = _ACT_IDS[self.head_act]
        a.n_params = self.n_params
        o = self.offsets()
        a.p_off_wi, a.p_off_wh, a.p_off_b = o["wi"], o["wh"], o["b"]
        a.p_off_hw, a.p_off_hb, a.p_off_g = o["hw"], o["hb"], o["g"]
        a.agg_scale = self.agg_scale
        a.loss_kind = _LOSS_KINDS[self.loss]
        a.loss_nse = int(self.loss == "nseLoss")
        return bytes(a)


def plan_fused_lstm(model, optimizer, logging: LoggingLoss) -> FusedLSTMPlan:
    """Check the envelope and the kernel form (its outputs and partials on
    probe values) and lay out the model's parameters."""
    reason = fused_epoch_lstm_unsupported_reason(model, optimizer, logging)
    if reason is not None:
        raise ValueError(f"model not supported by the fused LSTM epoch kernel: {reason}")
    net = model.nn
    names = ["nn.wi", "nn.wh", "nn.b", "nn.head.weight", "nn.head.bias"]
    return FusedLSTMPlan(
        in_dim=net.in_dim, hidden=net.hidden_size, out_dim=net.out_dim,
        head_act=net.output_activation,
        width=next(w for w in _HIDDEN_WIDTHS if w >= net.hidden_size),
        **shared_plan_fields(model, optimizer, logging, names),
    )


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

class FusedLSTMData(NamedTuple):
    """The padded epoch arrays flattened to windows: ``x (n, T, F)``, one
    ``(n, T)`` array per forcing and one ``(n, T_out)`` array per target and
    mask."""

    x: torch.Tensor
    forcing: Tuple[torch.Tensor, ...]
    y: Tuple[torch.Tensor, ...]
    mask: Tuple[torch.Tensor, ...]
    n_batches: int
    batch: int


def fused_lstm_data(plan: FusedLSTMPlan, tensors: EpochTensors) -> FusedLSTMData:
    if tensors.x.ndim != 4:
        raise ValueError(f"the fused LSTM epoch needs x (num_batches, batch, time, features); "
                         f"got {tuple(tensors.x.shape)}")
    nb, batch, steps, _ = tensors.x.shape
    n = nb * batch

    def windows(a, what):
        if a.ndim != 3:
            raise ValueError(f"{what} of shape {tuple(a.shape)} is not (num_batches, batch, time)")
        return a.reshape(n, a.shape[2]).contiguous()

    data = FusedLSTMData(
        x=tensors.x.reshape(n, steps, plan.in_dim).contiguous(),
        forcing=tuple(windows(tensors.forcing[f], f"forcing {f!r}") for f in plan.forcing_names),
        y=tuple(windows(tensors.y[t], f"target {t!r}") for t in plan.target_names),
        mask=tuple(windows(tensors.mask[t], f"mask {t!r}") for t in plan.target_names),
        n_batches=int(nb),
        batch=int(batch),
    )
    out_steps = {c.shape[1] for c in data.y + data.mask}
    if len(out_steps) != 1 or any(c.shape[1] != steps for c in data.forcing):
        raise ValueError("forcing must span the input window and every target one output window")
    return data


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _cell(z, c, h_size):
    """The LSTM cell on pre-activations ``z (B, 4H)``: gates i, f, g, o."""
    i = torch.sigmoid(z[:, :h_size])
    f = torch.sigmoid(z[:, h_size : 2 * h_size])
    g = torch.tanh(z[:, 2 * h_size : 3 * h_size])
    o = torch.sigmoid(z[:, 3 * h_size :])
    return i, f, g, o, f * c + i * g


def window_scales(plan: FusedLSTMPlan, y, mask):
    """Per target the loss scale over the whole ``(B, T_out)`` window, and
    the batch's validity: ``agg_scale / max(Σ mask, 1)`` for mse and mae,
    ``agg_scale / max(Σ ((y − ȳ) m)², 1e-12)`` for nseLoss (``y`` is zero
    where masked, so its plain sum is the masked sum)."""
    scales = []
    total = 0.0
    for y_j, m_j in zip(y, mask):
        count = m_j.sum()
        total = total + count
        n = torch.clamp_min(count, 1.0)
        if plan.loss == "nseLoss":
            dev = (y_j - y_j.sum() / n) * m_j
            scales.append(plan.agg_scale / torch.clamp_min((dev * dev).sum(), _SST_EPS))
        else:
            scales.append(plan.agg_scale / n)
    return scales, total > 0


def lstm_reference_grads(plan: FusedLSTMPlan, p, bn, consts, x, forcing, y, mask):
    """One step's forward and hand-written backward through time on one
    batch of windows ``x (B, T, F)``: returns ``(grad, batch_loss, valid)``
    with ``grad`` packed like ``p``."""
    f_dim, h_size, p_dim = plan.in_dim, plan.hidden, plan.out_dim
    o = plan.offsets()
    bsz, steps, _ = x.shape
    out_steps = y[0].shape[1]
    wi = p[o["wi"] : o["wh"]].view(4 * h_size, f_dim)
    wh = p[o["wh"] : o["b"]].view(4 * h_size, h_size)
    b = p[o["b"] : o["hw"]]
    hw = p[o["hw"] : o["hb"]].view(p_dim, h_size)
    hb = p[o["hb"] : o["g"]]

    xhat = None
    if plan.has_norm:
        xhat = (x - bn[:f_dim]) * torch.rsqrt(bn[f_dim:] + plan.norm_eps)
        x = xhat * p[:f_dim] + p[f_dim : 2 * f_dim]
    zero = x.new_zeros((bsz, h_size))
    h, c = zero, zero
    hs, cs = [], []
    for t in range(steps):
        *_, o_g, c = _cell(x[:, t] @ wi.T + h @ wh.T + b, c, h_size)
        h = o_g * torch.tanh(c)
        hs.append(h)
        cs.append(c)

    scales, valid = window_scales(plan, y, mask)
    nlo, nspan, glo, gspan, fixed = split_consts(plan, consts)
    sg = torch.sigmoid(p[o["g"] :])
    scalars = torch.cat([glo + gspan * sg, fixed])
    dglob = gspan * (sg * (1.0 - sg))

    loss_rows = x.new_zeros((bsz,))
    gglob = x.new_zeros((len(plan.global_names),))
    head_d = {}
    for tt in range(out_steps):
        t = steps - out_steps + tt
        raw, dact = _act_and_grad(plan.head_act, hs[t] @ hw.T + hb)
        if plan.scale_nn_outputs:
            s = torch.sigmoid(raw)
            neural, dneural = nlo + nspan * s, nspan * (s * (1.0 - s))
        else:
            neural, dneural = raw, torch.ones_like(raw)
        args = form_args(plan, neural, [c_[:, t] for c_ in forcing], scalars)
        outs = plan.form.torch_fn(*args)
        parts = plan.form.partials_fn(*args)
        cots = []
        for j in range(len(plan.target_names)):
            diff = (outs[plan.target_out[j]] - y[j][:, tt]) * mask[j][:, tt]
            if plan.loss == "mae":
                loss_rows = loss_rows + scales[j] * diff.abs()
                cots.append(scales[j] * torch.sign(diff))
            else:  # mse, and nseLoss with its own scale
                loss_rows = loss_rows + scales[j] * diff * diff
                cots.append((2.0 * scales[j]) * diff)
        dn, dg_rows = reference_cotangents(plan, neural, parts, cots)
        gglob = gglob + dg_rows.sum(0)
        head_d[t] = (dn * dneural) * dact

    g_hw, g_hb = torch.zeros_like(hw), torch.zeros_like(hb)
    g_wi, g_wh, g_b = torch.zeros_like(wi), torch.zeros_like(wh), torch.zeros_like(b)
    g_scale, g_bias = x.new_zeros((f_dim,)), x.new_zeros((f_dim,))
    dh_next, dc = zero, zero
    for t in range(steps - 1, -1, -1):
        dh = dh_next
        if t in head_d:
            g_hw = g_hw + head_d[t].T @ hs[t]
            g_hb = g_hb + head_d[t].sum(0)
            dh = dh + head_d[t] @ hw
        h_prev = hs[t - 1] if t > 0 else zero
        c_prev = cs[t - 1] if t > 0 else zero
        i_g, f_g, g_g, o_g, _ = _cell(x[:, t] @ wi.T + h_prev @ wh.T + b, c_prev, h_size)
        tanh_c = torch.tanh(cs[t])
        dc = dc + dh * o_g * (1.0 - tanh_c * tanh_c)
        dz = torch.cat([
            (dc * g_g) * i_g * (1.0 - i_g),
            (dc * c_prev) * f_g * (1.0 - f_g),
            (dc * i_g) * (1.0 - g_g * g_g),
            (dh * tanh_c) * o_g * (1.0 - o_g),
        ], dim=1)
        g_wi = g_wi + dz.T @ x[:, t]
        g_wh = g_wh + dz.T @ h_prev
        g_b = g_b + dz.sum(0)
        if plan.has_norm:
            dxn = dz @ wi
            g_scale = g_scale + (dxn * xhat[:, t]).sum(0)
            g_bias = g_bias + dxn.sum(0)
        dh_next = dz @ wh
        dc = dc * f_g

    grads = [g_scale, g_bias] if plan.has_norm else []
    grads += [g_wi.reshape(-1), g_wh.reshape(-1), g_b, g_hw.reshape(-1), g_hb, gglob * dglob]
    return torch.cat(grads), loss_rows.sum(), valid


def fused_lstm_reference(plan: FusedLSTMPlan, packed: FusedParams, opt_state,
                         data: FusedLSTMData, rows: torch.Tensor):
    """The plain PyTorch version of the kernel: ``rows.shape[0]`` epochs of
    ``data.n_batches`` steps over the windows ``rows[e, i·B : (i+1)·B]``.
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
            g, loss, valid = lstm_reference_grads(
                plan, p, bn, consts, data.x[idx], [c[idx] for c in data.forcing],
                [c[idx] for c in data.y], [c[idx] for c in data.mask],
            )
            p, slots, t = _reference_update(plan, p, slots, t, g, valid)
            epoch_loss = epoch_loss + torch.where(valid, loss, torch.zeros_like(loss))
    new_state = {**slots, "t": t.round().to(torch.int32)}
    return FusedParams(p, bn), new_state, epoch_loss / nb


# --------------------------------------------------------------------------
# kernel launch and the epoch function
# --------------------------------------------------------------------------

def launch_fused_lstm(plan: FusedLSTMPlan, packed: FusedParams, opt_state, data: FusedLSTMData,
                      rows: torch.Tensor, loss: torch.Tensor, *, lib=None) -> None:
    """Launch the CUDA kernel once over ``rows.shape[0]`` epochs, updating
    ``packed`` and ``opt_state`` in place and writing the mean loss into
    ``loss``; raises if the window does not fit or the launch is refused.
    Counts launches in ``launch_fused_lstm.launches``. ``lib`` is a
    measuring build of the kernel (``_build.measuring_library``) in place of the
    package's library; its launches are not counted."""
    steps, out_steps = data.x.shape[1], data.y[0].shape[1]
    if plan.sizes.tile_rows(steps, out_steps) is None:
        raise ValueError(f"a window of {steps} steps at hidden size {plan.hidden} does not fit "
                         "the fused LSTM kernel's shared memory")
    geometry = plan.geometry(data.batch, steps, out_steps)
    main_lib = _build.load_library()
    measuring = lib is not None
    lib = lib or main_lib
    if lib.eh_fused_lstm_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_lstm_args_size()} != {ctypes.sizeof(_Args)}"
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
    a.n_steps, a.n_out_steps = steps, out_steps
    a.threads, a.lanes, a.windows = geometry.threads, geometry.lanes, geometry.windows
    a.cluster, a.tiles, a.stages = geometry.cluster, geometry.tiles, geometry.stages
    a.res_floats = plan.sizes.pair_features()
    with torch.cuda.device(data.x.device):
        stream = torch.cuda.current_stream(data.x.device).cuda_stream
        rc = lib.eh_fused_lstm(ctypes.byref(a), plan.width, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused LSTM epoch kernel launch failed: {main_lib.eh_cuda_error_string(rc).decode()}")
    if not measuring:
        launch_fused_lstm.launches += 1


launch_fused_lstm.launches = 0

# the stamped build's stages, by stamp index (ehl_stamps in the source)
STAGES = ("step start", "input gather", "head and loss", "backward through time",
          "gradient sums", "gradient exchange", "update", "parameter exchange", "recurrence",
          "next scales", "ssts and epoch loss")


def stage_cycles(fn: "FusedLSTMEpoch", packed: FusedParams, opt_state, tensors: EpochTensors,
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
    lib = _build.measuring_library("fused_epoch_lstm.cu", "eh_fused_lstm", "-DEHL_STAMPS")
    launch_fused_lstm(plan, packed, opt_state, data, rows, loss, lib=lib)
    torch.cuda.synchronize(data.x.device)
    stamps = (ctypes.c_longlong * (len(STAGES) + 1))()
    rc = lib.eh_fused_lstm_stamps(stamps)
    if rc != 0:
        raise RuntimeError(f"reading the stage stamps failed: CUDA error {rc}")
    return dict(zip(STAGES + ("kernel",), list(stamps)))


class FusedLSTMEpoch(FusedEpoch):
    """:class:`~easyhybrid_tpu_torch.ops.fused_epoch.FusedEpoch` for an LSTM
    hybrid on sequence epoch tensors ``x (num_batches, batch, T, F)``:
    ``epochs_per_call`` epochs in one launch of kernel 4 on CUDA tensors,
    :func:`fused_lstm_reference` on CPU tensors."""

    _make_plan = staticmethod(plan_fused_lstm)
    _make_data = staticmethod(fused_lstm_data)
    _reference = staticmethod(fused_lstm_reference)
    _launch = staticmethod(launch_fused_lstm)


def make_fused_lstm_epoch(model, optimizer, logging: LoggingLoss, *, shuffle: Any = True,
                          epochs_per_call: int = 1) -> FusedLSTMEpoch:
    """Build the fused epoch of an LSTM hybrid (see :class:`FusedLSTMEpoch`);
    raises if the model, optimizer or loss is outside the envelope or the
    kernel form's probe check fails."""
    return FusedLSTMEpoch(model, optimizer, logging, shuffle=shuffle,
                          epochs_per_call=epochs_per_call)
