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
``(T_out x batch)`` window (every loss of the JAX kernel: ``mse``, ``mae``,
``nseLoss``, a traced ``ElementwiseLoss``, and the two-pass ``rmse``,
``pearsonLoss``, ``kgeLoss`` and ``pbkgeLoss``, whose cotangents follow the
window's prediction moments) and its
cotangent, the hand-written backward through time from per-step ``(x, h,
c)`` checkpoints (the kernel keeps the gates as well, the plain version
recomputes them), the batch-validity gate and the update by any optax rule
of the JAX kernel (``ops/fused_epoch.py``'s ``_OPTS``; lamb's per-leaf norms
are summed across the cluster's blocks in rank order).

The member axis (:meth:`FusedLSTMEpoch.members`, population training): one
launch trains K members, a thread-block cluster each, every state row, row
index and optimizer number per member, as kernel 2's
(:func:`fused_lstm_members_reference` is its plain version).

The packed layout (:class:`FusedLSTMPlan`, same scheme as kernel 2's):

* ``params``: ``[norm scale (F), norm bias (F)]`` with an input norm, then
  ``wi (4H, F)``, ``wh (4H, H)``, ``b (4H)``, the head's ``W (P, H)`` and
  ``b (P)``, all row-major, then the raw globals (G);
* ``bn``, ``opt_state`` and ``consts`` as in ``ops/fused_epoch.py``.

Two forms, picked by size alone (:func:`lstm_form`, a pure function of the
model and the window): this one-block form, every block of its cluster
holding all the parameters and their gradients, wherever its geometry fits
shared memory at one window a block (then it fits at every batch size); and
the cluster-split form (``ops/fused_lstm_split.py``, ``csrc/fused_lstm_split.cu``)
for the rest up to hidden size 256, 64 features and 32 steps. How a launch
of this form is cut is :meth:`FusedLSTMPlan.geometry`, a pure function of
the plan, the batch and the window: a window's recurrence in ``min(32,
width)`` lanes of one warp, a block's windows at once, a thread-block
cluster over the batch's windows, tiles walked only beyond that.
``csrc/fused_epoch_lstm.cu`` says what each choice is for.

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
    _OPT_WORDS,
    ELEMENTWISE,
    FUSED_LOSSES,
    LOSS_KINDS,
    MAX_SMEM_BYTES,
    MAX_TARGETS,
    TWO_PASS_LOSSES,
    FusedEpoch,
    FusedParams,
    PackedLayout,
    _act_and_grad,
    _check_member_shapes,
    _loss_name,
    _Optimizer,
    _reference_update,
    check_halt,
    obey_halt,
    fill_common_args,
    form_args,
    fused_members_reference,
    opt_slots,
    reference_cotangents,
    shared_plan_fields,
    slot_u,
    split_consts,
    stat_loss_cotangent,
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
    "fused_lstm_members_reference",
    "fused_lstm_reference",
    "launch_fused_lstm",
    "lstm_form",
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
# the hidden size both forms take together: the split form's cap
# (csrc/fused_lstm_split.cu, EHS_MAX_HIDDEN)
MAX_HIDDEN = 256
LSTM_LOSSES = FUSED_LOSSES  # every loss of the JAX kernel, and any traced ElementwiseLoss
_SST_EPS = 1e-12  # the floor of nseLoss's denominator (losses/metrics.py)


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

class _Sizes(NamedTuple):
    """What the kernel's shared memory depends on: the packed parameter
    count, features, hidden size, network outputs, globals, fixed values,
    targets, whether there is an input norm and whether the loss is a
    two-pass one (rmse, the statistic losses: the kernel keeps the trailing
    steps' predictions and the batch's moments)."""

    n_params: int
    f: int
    h: int
    p: int
    g: int
    k: int
    t: int
    norm: bool
    two_pass: bool = False

    def pair_features(self) -> int:
        """Features of a (window, step) pair in the kernel's pair arrays
        (``ehl_tile``): the cell's input and a 1 (and with a norm the
        normalised input and its cotangent), h, c and the four gates, which
        the backward overwrites with their cotangents."""
        return (3 * self.f if self.norm else self.f) + 6 * self.h + 1

    def fits_one_block(self, steps: int, out_steps: int, width: int) -> bool:
        """Whether the one-block form's geometry fits shared memory at one
        window a block, and so at every batch size, whatever the loss (the
        two-pass losses' kept predictions and moments counted)."""
        return (self._replace(two_pass=True).smem_floats(steps, out_steps, 1, min(32, width)) * 4
                <= MAX_SMEM_BYTES)

    def smem_floats(self, steps: int, out_steps: int, windows: int, lanes: int) -> int:
        """Shared-memory floats of one launch of the kernel with blocks
        holding ``windows`` windows of ``lanes`` lanes at once;
        ``ehl_smem_floats`` in csrc/fused_epoch_lstm.cu computes the same."""
        def ld(cols):
            return cols | 1

        warps = -(-windows * lanes // 32)
        return (2 * self.n_params + 2 * self.f + (2 * self.p + 2 * self.g + self.k)
                + (self.g + self.k) + self.g + 2 * self.f + 10 + warps * (6 * self.t + 1)
                + _OPT_WORDS + self.pair_features() * ld((steps + 1) * windows)
                + self.p * ld(out_steps * windows) + self.g * ld(min(lanes, out_steps) * windows)
                + (self.t * ld(out_steps * windows) + warps * 3 * self.t + 8 * self.t
                   if self.two_pass else 0))


def _sizes(model, loss=None) -> _Sizes:
    net = model.nn
    f, h, p, g = net.in_dim, net.hidden_size, net.out_dim, len(model.global_param_names)
    n_params = (2 * f if net.norm is not None else 0) + 4 * h * (f + h + 1) + p * (h + 1) + g
    return _Sizes(n_params, f, h, p, g, len(model.fixed_param_names), len(model.targets),
                  net.norm is not None, _loss_name(loss) in TWO_PASS_LOSSES)


def _width(hidden: int) -> Optional[int]:
    """The one-block form's compile-time hidden size for ``hidden``, or None
    past the largest."""
    return next((w for w in _HIDDEN_WIDTHS if w >= hidden), None)


def lstm_form(model, steps: int = 1, out_steps: int = 1) -> str:
    """Which form of kernel 4 trains an LSTM hybrid over windows of ``steps``
    steps with ``out_steps`` trailing ones: ``"one_block"`` where hidden size
    and features are at most 64 and the one-block geometry fits shared memory
    at one window a block, else ``"split"`` (``ops/fused_lstm_split.py``). A
    pure function of the model and the window; each form's envelope says why
    it refuses what it cannot take."""
    net = model.nn
    width = _width(net.hidden_size)
    if width is None or net.in_dim > MAX_WIDTH:
        return "split"
    return "one_block" if _sizes(model).fits_one_block(steps, out_steps, width) else "split"


def _window(tensors) -> Tuple[int, int]:
    """``(T, T_out)`` of sequence epoch tensors ``x (nb, B, T, F)``."""
    y = next(iter(tensors.y.values()))
    return int(tensors.x.shape[2]), int(y.shape[2]) if y.ndim > 2 else 0


def window_of(tensors) -> Tuple[int, int]:
    """The window of sequence epoch tensors, ``(1, 1)`` without them (or
    for tensors of rows, which the envelopes refuse by shape)."""
    if tensors is None or tensors.x.ndim != 4:
        return 1, 1
    steps, out_steps = _window(tensors)
    return steps, max(out_steps, 1)


def lstm_reason(model, optimizer, logging: LoggingLoss, tensors):
    """What both forms of kernel 4 refuse (see
    :func:`fused_epoch_lstm_unsupported_reason`), or None."""
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
    if net.in_dim > MAX_WIDTH or net.hidden_size > MAX_HIDDEN:
        return (f"{net.in_dim} features and hidden size {net.hidden_size} exceed the kernel's "
                f"caps of {MAX_WIDTH} features and hidden size {MAX_HIDDEN}")
    if net.out_dim > MAX_LSTM_OUT:
        return f"{net.out_dim} network outputs exceed the LSTM kernel's cap of {MAX_LSTM_OUT}"
    if len(model.targets) > MAX_TARGETS:
        return f"{len(model.targets)} targets exceed the kernel's cap of {MAX_TARGETS}"
    if logging.extra_loss is not None:
        return ("an extra_loss: the JAX kernel keeps an LSTM hybrid with any extra_loss off its "
                "kernel (easyhybrid_tpu/ops/fused_epoch.py:515-516: the weight-L2 key names the "
                "Dense weights, not the gates)")
    reason = mechanistic_reason(model) or training_spec_reason(optimizer, logging, LSTM_LOSSES)
    if reason is not None:
        return reason
    if tensors is not None and (tensors.x.ndim != 4 or _window(tensors)[1] == 0):
        return (f"x of shape {tuple(tensors.x.shape)} is not (num_batches, batch, time, "
                "features) with windowed targets")
    steps, out_steps = window_of(tensors)
    if out_steps > steps:
        return f"the output window ({out_steps}) is longer than the input window ({steps})"
    return None


def fused_epoch_lstm_unsupported_reason(model, optimizer, logging: LoggingLoss,
                                        tensors=None) -> Optional[str]:
    """Why the one-block form of kernel 4 cannot train ``model`` with this
    optimizer and loss, or None when it can.

    The envelope of both forms: a :class:`SingleNNHybridModel` whose network
    is an :class:`LSTMNet` in float32 with ``input_batchnorm`` ``"static"``
    or False; a mechanistic function with a kernel form; ``training_loss``
    any of the JAX kernel's (mse, mae, rmse, nseLoss, pearsonLoss, kgeLoss,
    pbkgeLoss) or an ``ElementwiseLoss`` the tracer expresses, with ``agg``
    sum or mean and no ``extra_loss``; an optimizer the kernels run
    (``fused_epoch.optimizer_reason``); up to 64 features and 8 network
    outputs and hidden size 256. With ``tensors``: ``x`` of shape
    ``(num_batches, batch, T, F)`` and windowed targets. Any batch size,
    shuffle mode and number of epochs per call. This form's own: hidden size
    up to 64 and a window whose one-block geometry fits shared memory
    (:func:`lstm_form`); the split form (``ops/fused_lstm_split.py``) takes
    the rest, up to 32 steps."""
    reason = lstm_reason(model, optimizer, logging, tensors)
    if reason is not None:
        return reason
    steps, out_steps = window_of(tensors)
    if _width(model.nn.hidden_size) is None:
        return (f"hidden size {model.nn.hidden_size} exceeds the one-block form's cap of "
                f"{_HIDDEN_WIDTHS[-1]} (the cluster-split form takes it)")
    if lstm_form(model, steps, out_steps) != "one_block":
        need = 4 * _sizes(model)._replace(two_pass=True).smem_floats(
            steps, out_steps, 1, min(32, _width(model.nn.hidden_size)))
        return (f"a window of {steps} steps at hidden size {model.nn.hidden_size} with "
                f"{model.nn.in_dim} features needs {need} bytes of shared memory at one window a "
                f"block; the one-block form has {MAX_SMEM_BYTES} (the cluster-split form takes it)")
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
        ("loss_sum", ctypes.c_int),
        ("optimizer", _Optimizer),
        ("halt", ctypes.c_void_p),
        ("threads", ctypes.c_int),
        ("lanes", ctypes.c_int),
        ("windows", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("stages", ctypes.c_int),
        ("res_floats", ctypes.c_int),
        ("n_members", ctypes.c_int),
        ("perm_stride", ctypes.c_int64),
        ("member_opt", ctypes.c_void_p),
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
    loss_form: Any = None  # the traced ElementwiseLoss (kernel_forms.LossForm) of ELEMENTWISE
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
    def two_pass(self) -> bool:
        """rmse or a statistic loss: the kernel's build that exchanges the
        window's prediction moments inside a step."""
        return self.loss in TWO_PASS_LOSSES

    @property
    def sizes(self) -> _Sizes:
        return _Sizes(self.n_params, self.in_dim, self.hidden, self.out_dim,
                      len(self.global_names), len(self.fixed_names), len(self.target_names),
                      self.has_norm, self.two_pass)

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
        a.loss_kind = LOSS_KINDS[self.loss]
        a.loss_nse = int(self.loss == "nseLoss")
        a.loss_sum = int(self.loss_form is not None and self.loss_form.normalize == "sum")
        return bytes(a)


def plan_fields(model, optimizer, logging: LoggingLoss, *, width: int) -> Dict[str, Any]:
    """The fields of a plan of either form for a model inside its envelope:
    the shared ones (``fused_epoch.shared_plan_fields``, the kernel form
    checked on probe values) and the network's sizes."""
    net = model.nn
    names = ["nn.wi", "nn.wh", "nn.b", "nn.head.weight", "nn.head.bias"]
    return dict(in_dim=net.in_dim, hidden=net.hidden_size, out_dim=net.out_dim,
                head_act=net.output_activation, width=width,
                **shared_plan_fields(model, optimizer, logging, names))


def plan_fused_lstm(model, optimizer, logging: LoggingLoss) -> FusedLSTMPlan:
    """Check the envelope and the kernel form (its outputs and partials on
    probe values) and lay out the model's parameters."""
    reason = fused_epoch_lstm_unsupported_reason(model, optimizer, logging)
    if reason is not None:
        raise ValueError(f"model not supported by the fused LSTM epoch kernel: {reason}")
    return FusedLSTMPlan(**plan_fields(model, optimizer, logging,
                                       width=_width(model.nn.hidden_size)))


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
    the batch's validity: ``agg_scale / max(Σ mask, 1)`` for mse, mae and an
    elementwise loss by mean, ``agg_scale`` for one by sum, ``agg_scale /
    max(Σ ((y − ȳ) m)², 1e-12)`` for nseLoss (``y`` is zero where masked, so
    its plain sum is the masked sum), as the JAX kernel builds ``inv_n``."""
    scales = []
    total = 0.0
    for y_j, m_j in zip(y, mask):
        count = m_j.sum()
        total = total + count
        n = torch.clamp_min(count, 1.0)
        if plan.loss == "nseLoss":
            dev = (y_j - y_j.sum() / n) * m_j
            scales.append(plan.agg_scale / torch.clamp_min((dev * dev).sum(), _SST_EPS))
        elif plan.loss_form is not None and plan.loss_form.normalize == "sum":
            scales.append(torch.full_like(n, plan.agg_scale))
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

    # pass A: every trailing step's head, the form's outputs and partials
    heads = []
    for tt in range(out_steps):
        t = steps - out_steps + tt
        raw, dact = _act_and_grad(plan.head_act, hs[t] @ hw.T + hb)
        if plan.scale_nn_outputs:
            s = torch.sigmoid(raw)
            neural, dneural = nlo + nspan * s, nspan * (s * (1.0 - s))
        else:
            neural, dneural = raw, torch.ones_like(raw)
        args = form_args(plan, neural, [c_[:, t] for c_ in forcing], scalars)
        heads.append((neural, dneural, dact, plan.form.torch_fn(*args),
                      plan.form.partials_fn(*args)))

    # each target's cotangents over the (B, T_out) window: a scale a row, or
    # (rmse, the statistic losses) from the window's prediction moments
    loss_rows = x.new_zeros((bsz,))
    batch_terms = []
    cots = []  # [target][step]
    for j in range(len(plan.target_names)):
        pred = torch.stack([h[3][plan.target_out[j]] for h in heads], dim=1)
        m, yj = mask[j], y[j]
        diff = (pred - yj) * m
        if plan.loss == "mae":
            loss_rows = loss_rows + (scales[j] * diff.abs()).sum(1)
            cot = scales[j] * torch.sign(diff)
        elif plan.loss == ELEMENTWISE:  # at (ŷ m, y), as the JAX kernel does
            loss_rows = loss_rows + (scales[j] * plan.loss_form.value_fn(pred * m, yj) * m).sum(1)
            cot = scales[j] * plan.loss_form.grad_fn(pred * m, yj) * m
        elif plan.loss == "rmse":
            n = torch.clamp_min(m.sum(), 1.0)
            r = torch.sqrt((diff * diff).sum() / n)
            batch_terms.append(plan.agg_scale * r)
            cot = (plan.agg_scale / (n * torch.clamp_min(r, 1e-30))) * diff
        elif plan.two_pass:  # the statistic losses
            term, cot = stat_loss_cotangent(plan.loss, plan.agg_scale, pred, yj, m)
            batch_terms.append(term)
        else:  # mse, and nseLoss with its own scale
            loss_rows = loss_rows + (scales[j] * diff * diff).sum(1)
            cot = (2.0 * scales[j]) * diff
        cots.append(cot)

    # pass B: the cotangents through the forms and heads
    gglob = x.new_zeros((len(plan.global_names),))
    head_d = {}
    for tt, (neural, dneural, dact, _, parts) in enumerate(heads):
        dn, dg_rows = reference_cotangents(plan, neural, parts, [c[:, tt] for c in cots])
        gglob = gglob + dg_rows.sum(0)
        head_d[steps - out_steps + tt] = (dn * dneural) * dact

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
    batch_loss = loss_rows.sum() if not batch_terms else sum(batch_terms[1:], batch_terms[0])
    return torch.cat(grads), batch_loss, valid


def fused_lstm_reference(plan: FusedLSTMPlan, packed: FusedParams, opt_state,
                         data: FusedLSTMData, rows: torch.Tensor, halt=None):
    """The plain PyTorch version of the kernel: ``rows.shape[0]`` epochs of
    ``data.n_batches`` steps over the windows ``rows[e, i·B : (i+1)·B]``.
    Returns ``(packed, opt_state, mean_loss)``; the loss is the last epoch's
    mean batch loss (empty batches count 0). ``halt``: ``obey_halt``."""
    packed0, opt0 = packed, opt_state
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
    return obey_halt(halt, packed0, opt0, (FusedParams(p, bn), new_state, epoch_loss / nb))


# --------------------------------------------------------------------------
# kernel launch and the epoch function
# --------------------------------------------------------------------------

def launch_args(plan: FusedLSTMPlan, packed: FusedParams, opt_state, data: FusedLSTMData,
                rows: torch.Tensor, loss: torch.Tensor, *, halt=None, member_opt=None) -> _Args:
    """The kernel's argument struct for a launch (see
    :func:`launch_fused_lstm`): the plan's static fields, the tensors'
    addresses, the window, the geometry and the member axis's count and
    strides; raises on a window that does not fit or shapes the kernel does
    not read."""
    steps, out_steps = data.x.shape[1], data.y[0].shape[1]
    members = packed.params.dim() == 2
    k = packed.params.shape[0] if members else 1
    _check_member_shapes(plan, packed, opt_state, rows, loss, member_opt, k, members)
    geometry = plan.geometry(data.batch, steps, out_steps)
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
    a.n_rows = rows.shape[-1]  # the epoch stride of a row index
    a.n_epochs = rows.shape[-2]
    a.n_members = k
    a.perm_stride = rows.shape[-2] * rows.shape[-1] if rows.dim() == 3 else 0
    a.member_opt = member_opt.data_ptr() if member_opt is not None else None
    a.n_batches, a.batch = data.n_batches, data.batch
    a.n_steps, a.n_out_steps = steps, out_steps
    a.threads, a.lanes, a.windows = geometry.threads, geometry.lanes, geometry.windows
    a.cluster, a.tiles, a.stages = geometry.cluster, geometry.tiles, geometry.stages
    a.res_floats = plan.sizes.pair_features()
    a.halt = check_halt(halt, data.x.device)
    return a


def launch_fused_lstm(plan: FusedLSTMPlan, packed: FusedParams, opt_state, data: FusedLSTMData,
                      rows: torch.Tensor, loss: torch.Tensor, *, lib=None, halt=None,
                      member_opt=None) -> None:
    """Launch the CUDA kernel once over ``rows.shape[-2]`` epochs, updating
    ``packed`` and ``opt_state`` in place and writing the mean loss into
    ``loss``; raises if the window does not fit or the launch is refused.
    Counts launches in ``launch_fused_lstm.launches``. ``lib`` is a
    measuring build of the kernel (``_build.measuring_library``) in place of the
    package's library; its launches are not counted. ``halt`` is the halt
    word (``ops/fused_epoch.py``): a halted launch writes nothing.

    The member axis (:meth:`FusedLSTMEpoch.members`): parameters ``(K, n)``
    train K members in one launch, a cluster each, with every state tensor
    stacked the same way (``t`` ``(K, 1)``, ``loss`` ``(K,)``); ``rows``
    ``(K, E, n)`` gives each member its own row index (else one is shared)
    and ``member_opt`` ``(K, len(OPT_SCALARS))`` its optimizer numbers
    (``ops/fused_epoch.py::member_opt_rows``; else the plan's)."""
    a = launch_args(plan, packed, opt_state, data, rows, loss, halt=halt, member_opt=member_opt)
    measuring = lib is not None
    lib = lib or _build.kernel_library("fused_epoch_lstm.cu", plan.form, plan.loss_form)
    if lib.eh_fused_lstm_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_lstm_args_size()} != {ctypes.sizeof(_Args)}"
        )
    with torch.cuda.device(data.x.device):
        stream = torch.cuda.current_stream(data.x.device).cuda_stream
        rc = lib.eh_fused_lstm(ctypes.byref(a), plan.width, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused LSTM epoch kernel launch failed: {lib.eh_cuda_error_string(rc).decode()}")
    if not measuring:
        launch_fused_lstm.launches += 1


launch_fused_lstm.launches = 0

# the stamped build's stages, by stamp index (ehl_stamps in the source)
STAGES = ("step start", "input gather", "head and loss", "backward through time",
          "gradient sums", "gradient exchange", "update", "parameter exchange", "recurrence",
          "next scales", "ssts and epoch loss", "moments exchange")


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


def fused_lstm_members_reference(plan: FusedLSTMPlan, packed: FusedParams, opt_state,
                                 data: FusedLSTMData, rows: torch.Tensor, *, specs=None):
    """The plain version of kernel 4's member axis: :func:`fused_lstm_reference`
    once per member, with that member's optimizer spec, row index (and so its
    windows) and state; the results stacked."""
    return fused_members_reference(plan, packed, opt_state, data, rows, specs=specs,
                                   reference=fused_lstm_reference)


class FusedLSTMEpoch(FusedEpoch):
    """:class:`~easyhybrid_tpu_torch.ops.fused_epoch.FusedEpoch` for an LSTM
    hybrid on sequence epoch tensors ``x (num_batches, batch, T, F)``:
    ``epochs_per_call`` epochs in one launch of kernel 4 on CUDA tensors,
    :func:`fused_lstm_reference` on CPU tensors; a population's members in
    one launch (:meth:`members`, kernel 4's member axis), or member by member
    on CPU tensors (:func:`fused_lstm_members_reference`)."""

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
