"""Fused hybrid forward (inference): a hand-written CUDA kernel for Hopper.

Counterpart of ``easyhybrid_tpu/ops/fused_forward.py``. The kernel
(``csrc/fused_forward.cu``) runs the whole forward of a SingleNN MLP hybrid
for every row: static or no input norm, the MLP, sigmoid bound scaling of
the neural outputs, the scaled globals and fixed parameters, the mechanistic
model, and a write of every mechanistic output and every scaled neural
parameter.

The mechanistic model enters the kernel as a **kernel form**
(``ops/kernel_forms.py``): the user's function traced with ``torch.fx`` and
emitted as a CUDA device function the kernel is built against, or, for a
function tagged with :func:`kernel_form`, the hand-written form the sources
hold (this release: ``"rbq10"``). Each argument of the form is mapped by
name to a forcing column, a neural parameter, a global, a fixed parameter,
or else to the function's keyword default. When the forward is built, the
function is evaluated once against the form's torch transcription on probe
values, and a mismatch raises. A function the tracer cannot express is
outside the envelope, with the tracer's reason.

On a CPU tensor the wrapper computes :func:`fused_forward_reference`, the
plain PyTorch version of the same function on the same packed parameters;
on a CUDA tensor it launches the kernel or raises. It never falls back.
:meth:`FusedForward.table` is the serving path around it: host rows in,
host columns out, one copy per array each way and one launch per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.hybrid import MultiNNHybridModel, SingleNNHybridModel, _call_mechanistic
from ..models.nn import MLP, get_activation
from . import _build
from .kernel_forms import FORM_RBQ10, MAX_ARGS, MAX_OUTPUTS, KernelForm, traced_form

__all__ = [
    "KERNEL_FORMS",
    "KernelForm",
    "FusedForward",
    "kernel_form",
    "rbq10",
    "supports_fused_forward",
    "fused_forward_unsupported_reason",
    "plan_fused_forward",
    "make_fused_forward",
    "fused_forward_reference",
    "launch_fused_forward",
    "bf16_round",
    "is_bf16",
]

# caps of the kernel; they must equal the EH_MAX_* defines of the source
MAX_WIDTH = 64
MAX_LAYERS = 8
MAX_FORCING = 8
MAX_SCALARS = 16
MAX_SMEM_FLOATS = 48 * 1024 // 4  # the envelope's cap on the packed parameters
_WIDTHS = (16, 32, 64)  # the kernel's compile-time widths
# rows one launch covers at most (whole chunks of batch_size): a larger table
# is launched one group of chunks at a time
_GROUP_ROWS = 1 << 20

_ACT_IDS = {
    "identity": 0, "linear": 0, "tanh": 1, "relu": 2, "sigmoid": 3,
    "swish": 4, "silu": 4, "gelu": 5, "softplus": 6, "selu": 7, "elu": 8,
    "leakyrelu": 9,
}
_SRC_FORCING, _SRC_NEURAL, _SRC_SCALAR, _SRC_CONST = 0, 1, 2, 3


# --------------------------------------------------------------------------
# kernel forms of the mechanistic model
# --------------------------------------------------------------------------

def _rbq10_torch(rb, Q10, ta, tref):
    return (rb * torch.pow(Q10, 0.1 * (ta - tref)),)


def _rbq10_partials(rb, Q10, ta, tref):
    # written in the order JAX's jvp of rb * Q10 ** e evaluates them
    e = 0.1 * (ta - tref)
    q = torch.pow(Q10, e)
    d_ta = rb * (q * torch.log(Q10)) * 0.1
    return ((q, rb * (e * torch.pow(Q10, e - 1.0)), d_ta, -d_ta),)


KERNEL_FORMS: Dict[str, KernelForm] = {
    "rbq10": KernelForm("rbq10", FORM_RBQ10, ("rb", "Q10", "ta", "tref"), 1, _rbq10_torch,
                        _rbq10_partials),
}


def kernel_form(name: str):
    """Tag a mechanistic function with the kernel form it computes."""
    if name not in KERNEL_FORMS:
        raise ValueError(f"unknown kernel form {name!r}; known: {sorted(KERNEL_FORMS)}")

    def tag(fn):
        fn.__kernel_form__ = name
        return fn

    return tag


@kernel_form("rbq10")
def rbq10(*, ta, rb, Q10, tref=15.0):
    """The quick-start respiration model ``rb * Q10^((ta - tref) / 10)``."""
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

def _form_of(model) -> Tuple[Optional[KernelForm], Optional[str]]:
    """``(form, None)``: the hand-written form the model's mechanistic
    function is tagged with, else the form traced from it; or ``(None,
    reason)`` when the tracer cannot express the function."""
    fn = model.mechanistic_model
    tag = getattr(fn, "__kernel_form__", None)
    if tag is not None:
        return KERNEL_FORMS[tag], None
    available = dict.fromkeys((*model.forcing, *model.neural_param_names,
                               *model.global_param_names, *model.fixed_param_names))
    form = traced_form(fn, tuple(available))
    return (None, form) if isinstance(form, str) else (form, None)


def _keyword_defaults(fn) -> Dict[str, object]:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return {}
    return {
        k: p.default
        for k, p in sig.parameters.items()
        if p.default is not inspect.Parameter.empty
    }


def _arg_sources(model, form: KernelForm):
    """Map each form argument to (source, index, constant); later sources
    win, as the model's forward merges parameters over forcing."""
    G = len(model.global_param_names)
    sources = {}
    for i, f in enumerate(model.forcing):
        sources[f] = (_SRC_FORCING, i, 0.0)
    for i, n in enumerate(model.neural_param_names):
        sources[n] = (_SRC_NEURAL, i, 0.0)
    for i, g in enumerate(model.global_param_names):
        sources[g] = (_SRC_SCALAR, i, 0.0)
    for i, f in enumerate(model.fixed_param_names):
        sources[f] = (_SRC_SCALAR, G + i, 0.0)
    defaults = _keyword_defaults(model.mechanistic_model)
    out = []
    for a in form.args:
        if a in sources:
            out.append(sources[a])
        elif isinstance(defaults.get(a), (int, float)):
            out.append((_SRC_CONST, 0, float(defaults[a])))
        else:
            return None, a
    return out, None


def fused_forward_unsupported_reason(model, *, training: bool = False,
                                     max_width: int = MAX_WIDTH) -> Optional[str]:
    """Why ``model`` is outside the kernel's envelope, or None if it is in.

    The envelope is the JAX kernel's (a SingleNN MLP hybrid with static or
    no input norm) plus this kernel's own limits: a mechanistic function
    the kernel forms take (tagged, or traced from the function) whose
    arguments all resolve, the 12
    named activations, float32 parameters with no ``compute_dtype`` or
    ``compute_dtype=torch.bfloat16`` (:func:`is_bf16`), and widths,
    depth and parameter counts within the caps above. ``training=True``
    asks for the model checks of the one-network training kernel (5):
    trainable input BatchNorm is allowed there, and the kernel checks its
    own memory. ``max_width`` is the widest layer the asking kernel takes.
    Kernels 2 and 3, which also train MultiNN branches, ask
    :func:`branches_unsupported_reason`."""
    if not isinstance(model, SingleNNHybridModel):
        return f"{type(model).__name__} is not a SingleNNHybridModel"
    net = model.nn
    if net is None or not model.neural_param_names:
        return "the model has no neural network"
    reason = _network_reason(net, training=training, max_width=max_width)
    if reason is not None:
        return reason
    reason = float32_reason(model)
    if reason is not None:
        return reason
    n_scalars = len(model.global_param_names) + len(model.fixed_param_names)
    if not training and _blob_floats(model) + n_scalars > MAX_SMEM_FLOATS:
        return "the packed parameters exceed the kernel's 48 KiB of shared memory"
    return mechanistic_reason(model)


def model_branches(model) -> Tuple[Tuple[str, object], ...]:
    """The networks of a model as the training kernels see them, the JAX
    kernel's branch view: ``((parameter prefix, network), ...)``, one
    single-output branch per neural parameter, in their order, for a MultiNN
    model (``model.nns``); else its one network (``model.nn``: an MLP, an
    LSTM, the networks of the sites), which gives every neural column; or
    none."""
    nns = getattr(model, "nns", None)
    if nns is not None:
        return tuple((f"nns.{name}", net) for name, net in nns.items())
    return (("nn", model.nn),) if getattr(model, "nn", None) is not None else ()


def branches_unsupported_reason(model, *, max_width: int = MAX_WIDTH) -> Optional[str]:
    """The model checks of the training kernels with branches (kernels 2
    and 3): a SingleNN or MultiNN hybrid whose every network is a float32
    MLP inside :func:`_network_reason` (trainable input BatchNorm allowed;
    ``max_width`` the asking kernel's widest layer), all with one input-norm
    mode, as the JAX package builds them; a model without a network and
    without neural parameters (globals only) has no branch. Then the
    mechanistic function, as for the forward kernel."""
    if not isinstance(model, (SingleNNHybridModel, MultiNNHybridModel)):
        return f"{type(model).__name__} is neither a SingleNNHybridModel nor a MultiNNHybridModel"
    branches = model_branches(model)
    for prefix, net in branches:
        reason = _network_reason(net, training=True, max_width=max_width)
        if reason is not None:
            return reason if len(branches) == 1 else f"branch {prefix[4:]!r}: {reason}"
    if sum(net.out_dim for _, net in branches) != len(model.neural_param_names):
        return (f"networks of {sum(net.out_dim for _, net in branches)} outputs for the neural "
                f"parameters {list(model.neural_param_names)}")
    if len({net.input_batchnorm for _, net in branches}) > 1:
        return "branches with different input norms (the kernel takes one mode for all)"
    if len({net.compute_dtype for _, net in branches}) > 1:
        return "branches with different compute_dtype (the kernel takes one for all)"
    reason = float32_reason(model)
    if reason is not None:
        return reason
    return mechanistic_reason(model)


def _network_reason(net, *, training: bool, max_width: int) -> Optional[str]:
    """Why one network is outside the kernels' MLP envelope, or None."""
    if not isinstance(net, MLP):
        return f"the network is a {type(net).__name__}, not an MLP"
    if net.input_batchnorm is True and not training:
        return "trainable input BatchNorm (input_batchnorm=True) is outside the kernel"
    if net.compute_dtype is not None and net.compute_dtype != torch.bfloat16:
        return (f"compute_dtype={net.compute_dtype} (the kernels take bfloat16 only, as the JAX "
                "kernel does)")
    for layer in net.layers:
        if not isinstance(layer.activation, str) or layer.activation not in _ACT_IDS:
            return f"activation {layer.activation!r} is not one of the kernel's {len(_ACT_IDS)} names"
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    if max(dims) > max_width:
        return f"layer widths {dims} exceed the kernel's cap of {max_width}"
    if len(dims) - 1 > MAX_LAYERS:
        return f"{len(dims) - 1} layers exceed the kernel's cap of {MAX_LAYERS}"
    return None


def is_bf16(model) -> bool:
    """Whether the model's networks run their products on bfloat16 operands
    (``compute_dtype=torch.bfloat16``): the kernels' bf16 builds
    (``-DEH_BF16``)."""
    return any(getattr(net, "compute_dtype", None) == torch.bfloat16
               for _, net in model_branches(model))


def float32_reason(model) -> Optional[str]:
    """Names a parameter or buffer that is not float32, if there is one."""
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if t.dtype != torch.float32:
            return f"{name} is {t.dtype}, not float32"
    return None


def mechanistic_reason(model) -> Optional[str]:
    """Why the kernels cannot evaluate the model's mechanistic function, or
    None: it must be tagged with a known kernel form or be traceable into
    one (``ops/kernel_forms.py``), with every argument resolved and the
    forcing columns and scalar parameters within the kernels' caps."""
    if len(model.forcing) > MAX_FORCING:
        return f"{len(model.forcing)} forcing columns exceed the cap of {MAX_FORCING}"
    n_scalars = len(model.global_param_names) + len(model.fixed_param_names)
    if n_scalars > MAX_SCALARS:
        return f"{n_scalars} global and fixed parameters exceed the cap of {MAX_SCALARS}"
    form, reason = _form_of(model)
    if form is None:
        return reason
    _, unresolved = _arg_sources(model, form)
    if unresolved is not None:
        return (
            f"kernel form {form.name!r} argument {unresolved!r} is neither a "
            "forcing column, a parameter nor a numeric keyword default"
        )
    return None


def supports_fused_forward(model) -> bool:
    return fused_forward_unsupported_reason(model) is None


# --------------------------------------------------------------------------
# plan: the packed parameters and the kernel's static arguments
# --------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``struct EhFusedForwardArgs`` in csrc/fused_forward.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("forcing", ctypes.c_void_p * MAX_FORCING),
        ("blob", ctypes.c_void_p),
        ("out", ctypes.c_void_p * MAX_OUTPUTS),
        ("neural_out", ctypes.c_void_p * MAX_WIDTH),
        ("n", ctypes.c_int64),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("acts", ctypes.c_int * MAX_LAYERS),
        ("has_norm", ctypes.c_int),
        ("norm_eps", ctypes.c_float),
        ("blob_floats", ctypes.c_int),
        ("pp_off_w", ctypes.c_int * MAX_LAYERS),
        ("pp_off_b", ctypes.c_int * MAX_LAYERS),
        ("tail_off", ctypes.c_int),
        ("n_globals", ctypes.c_int),
        ("n_fixed", ctypes.c_int),
        ("scale_nn_outputs", ctypes.c_int),
        ("form", ctypes.c_int),
        ("n_args", ctypes.c_int),
        ("arg_src", ctypes.c_int * MAX_ARGS),
        ("arg_idx", ctypes.c_int * MAX_ARGS),
        ("arg_const", ctypes.c_float * MAX_ARGS),
        ("n_out", ctypes.c_int),
    ]


def _blob_floats(model) -> int:
    net = model.nn
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    n = 4 * dims[0] if net.norm is not None else 0
    n += sum(dims[i + 1] * (dims[i] + 1) for i in range(len(dims) - 1))
    n += 2 * dims[-1] + 3 * len(model.global_param_names) + len(model.fixed_param_names)
    return n


def _padded_blob(blob: torch.Tensor, dims, has_norm: bool):
    """The kernel's copy of the packed parameters: every weight row padded
    with zeros to a multiple of 4 floats and every layer starting on a
    multiple of 4, so that a row is read 16 bytes at a time; the whole a
    multiple of 4. Returns it with each layer's weight and bias offsets and
    the offset of the rest (bounds, globals, fixed values)."""
    def up4(n):
        return -(-n // 4) * 4

    src = off = 4 * dims[0] if has_norm else 0
    parts, pp_w, pp_b = [blob[:src]], [], []
    for din, dout in zip(dims[:-1], dims[1:]):
        parts.append(blob.new_zeros((up4(off) - off,)))
        off = up4(off)
        pp_w.append(off)
        parts.append(F.pad(blob[src : src + dout * din].view(dout, din), (0, up4(din) - din)))
        src, off = src + dout * din, off + dout * up4(din)
        pp_b.append(off)
        parts.append(blob[src : src + dout])
        src, off = src + dout, off + dout
    tail = off
    off += blob.numel() - src
    parts += [blob[src:], blob.new_zeros((up4(off) - off,))]
    return torch.cat([t.reshape(-1) for t in parts]).contiguous(), pp_w, pp_b, tail


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """What the kernel and its plain version read: the packed parameter
    blob (on the model's device; the kernel's padded copy beside it) and
    the static layout."""

    dims: Tuple[int, ...]
    acts: Tuple[str, ...]
    has_norm: bool
    norm_eps: float
    scale_nn_outputs: bool
    forcing_names: Tuple[str, ...]
    neural_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    n_globals: int
    n_fixed: int
    form: KernelForm
    arg_sources: Tuple[Tuple[int, int, float], ...]
    blob: torch.Tensor
    width: int
    bf16: bool = False  # compute_dtype=bfloat16: the kernel's bf16 build

    @functools.cached_property
    def kernel_blob(self):
        """``(padded blob, weight offsets, bias offsets, tail offset)``: the
        kernel's layout of :attr:`blob` (:func:`_padded_blob`)."""
        return _padded_blob(self.blob, self.dims, self.has_norm)

    @property
    def n_features(self) -> int:
        return self.dims[0]

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernel's static arguments, packed once; each launch copies
        them and fills in the pointers and the row count."""
        a = _Args()
        padded, pp_w, pp_b, tail = self.kernel_blob
        a.blob = padded.data_ptr()
        a.n_layers = len(self.dims) - 1
        a.dims[: len(self.dims)] = self.dims
        a.acts[: len(self.acts)] = [_ACT_IDS[act] for act in self.acts]
        a.has_norm = int(self.has_norm)
        a.norm_eps = self.norm_eps
        a.blob_floats = padded.numel()
        a.pp_off_w[: len(pp_w)] = pp_w
        a.pp_off_b[: len(pp_b)] = pp_b
        a.tail_off = tail
        a.n_globals, a.n_fixed = self.n_globals, self.n_fixed
        a.scale_nn_outputs = int(self.scale_nn_outputs)
        a.form = self.form.form_id
        a.n_args = len(self.arg_sources)
        for i, (src, idx, const) in enumerate(self.arg_sources):
            a.arg_src[i], a.arg_idx[i], a.arg_const[i] = src, idx, const
        a.n_out = len(self.output_names)
        return bytes(a)


def _probe_outputs(model, form: KernelForm, arg_sources) -> Tuple[str, ...]:
    """Evaluate the mechanistic function and its form's transcription on
    probe values; return the function's output names, or raise on a
    mismatch (a function tagged with a form it does not compute)."""
    gen = torch.Generator().manual_seed(20240)
    n = 257
    table = model.param_table

    def within(name, shape):
        lo, hi = table.lower_of(name), table.upper_of(name)
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    kwargs = {f: -10.0 + 50.0 * torch.rand((n,), generator=gen) for f in model.forcing}
    kwargs.update({p: within(p, (n,)) for p in model.neural_param_names})
    kwargs.update({g: within(g, (1,)) for g in model.global_param_names})
    kwargs.update({f: model.fixed.as_dict()[f].detach().cpu() for f in model.fixed_param_names})
    want = _call_mechanistic(model.mechanistic_model, kwargs)
    args = [
        const if src == _SRC_CONST else kwargs[name]
        for name, (src, _, const) in zip(form.args, arg_sources)
    ]
    got = form.torch_fn(*args)
    fn_name = getattr(model.mechanistic_model, "__name__", model.mechanistic_model)
    if len(want) != form.n_outputs:
        raise ValueError(
            f"mechanistic model {fn_name!r} takes the form {form.name!r} but returns "
            f"{len(want)} outputs {sorted(want)}; the form has {form.n_outputs}"
        )
    for (key, w), g in zip(want.items(), got):
        w = torch.as_tensor(w, dtype=torch.float32)
        g = torch.as_tensor(g, dtype=torch.float32)
        if w.shape != g.shape and w.numel() == 1:  # an output of constants, broadcast
            w = w.reshape(()).expand(g.shape)
        if w.shape != g.shape or not torch.allclose(w, g, rtol=1e-5, atol=1e-6, equal_nan=True):
            raise ValueError(
                f"mechanistic model {fn_name!r} takes the form {form.name!r} but its "
                f"output {key!r} disagrees with the form on probe values"
            )
    check_form_partials(form, args)
    return tuple(want)


def check_form_partials(form: KernelForm, args) -> None:
    """Hold the form's partials (hand-written, or emitted by the tracer)
    against ``torch.func.jvp`` of its transcription, one argument at a time;
    raise on a mismatch."""
    n = max(int(torch.as_tensor(a).numel()) for a in args)
    prim = tuple(torch.as_tensor(a, dtype=torch.float32).expand(n).clone() for a in args)
    parts = form.partials_fn(*prim)
    for i, name in enumerate(form.args):
        tangents = tuple(
            torch.ones_like(p) if j == i else torch.zeros_like(p) for j, p in enumerate(prim)
        )
        _, want = torch.func.jvp(form.torch_fn, prim, tangents)
        for o in range(form.n_outputs):
            got = torch.as_tensor(parts[o][i], dtype=torch.float32).expand(n)
            if not torch.allclose(got, want[o], rtol=1e-4, atol=1e-6, equal_nan=True):
                raise ValueError(
                    f"kernel form {form.name!r}: its partial of output {o} with "
                    f"respect to {name!r} disagrees with torch.func.jvp on probe values"
                )


def plan_fused_forward(model) -> FusedPlan:
    """Check the envelope, run the form's probe check and pack the model's
    current parameters (a snapshot) for the kernel."""
    reason = fused_forward_unsupported_reason(model)
    if reason is not None:
        raise ValueError(f"model not supported by the fused forward kernel: {reason}")
    net = model.nn
    form, _ = _form_of(model)
    arg_sources, _ = _arg_sources(model, form)
    output_names = _probe_outputs(model, form, arg_sources)
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    table = model.param_table
    dev = net.layers[0].weight.device

    def floats(values):
        return torch.tensor(values, dtype=torch.float32, device=dev)

    def span(names):  # upper - lower in double, rounded once, as scale_param
        return floats([table.upper_of(n) - table.lower_of(n) for n in names])

    parts = []  # an MLP's layers always have a bias and its norm is affine
    if net.norm is not None:
        parts += [net.norm.mean, net.norm.var, net.norm.scale, net.norm.bias]
    for layer in net.layers:
        parts += [layer.weight, layer.bias]
    neural, globals_ = model.neural_param_names, model.global_param_names
    parts += [floats([table.lower_of(n) for n in neural]), span(neural)]
    parts.append(torch.cat([model.globals.as_dict()[g] for g in globals_])
                 if globals_ else floats([]))
    parts += [floats([table.lower_of(g) for g in globals_]), span(globals_)]
    parts.append(torch.cat([model.fixed.as_dict()[f] for f in model.fixed_param_names])
                 if model.fixed_param_names else floats([]))
    blob = torch.cat([p.detach().reshape(-1).to(dev, torch.float32) for p in parts])
    return FusedPlan(
        dims=dims,
        acts=tuple(layer.activation for layer in net.layers),
        has_norm=net.norm is not None,
        norm_eps=net.norm.eps if net.norm is not None else 0.0,
        scale_nn_outputs=bool(model.scale_nn_outputs),
        forcing_names=tuple(model.forcing),
        neural_names=tuple(neural),
        output_names=output_names,
        n_globals=len(globals_),
        n_fixed=len(model.fixed_param_names),
        form=form,
        arg_sources=tuple(arg_sources),
        blob=blob.contiguous(),
        width=next(w for w in _WIDTHS if w >= max(dims)),
        bf16=is_bf16(model),
    )


# --------------------------------------------------------------------------
# plain version and kernel launch
# --------------------------------------------------------------------------

def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16 (ties to even), in its own
    dtype: ``astype(bfloat16)`` and back, the kernels' ``ehe_bf16``."""
    return t.to(torch.bfloat16).to(t.dtype)


def fused_forward_reference(plan: FusedPlan, x, forcing) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same function on the
    same packed parameters, ``{output…, neural parameter…}``. Under
    ``plan.bf16`` each layer's input and weights are rounded to bfloat16
    and multiplied in float32, as the JAX ``Dense`` does."""
    blob = plan.blob.to(x.device)
    pos = 0

    def take(count):
        nonlocal pos
        pos += count
        return blob[pos - count : pos]

    dims = plan.dims
    h = x
    if plan.has_norm:
        f = dims[0]
        mean, var, scale, bias = take(f), take(f), take(f), take(f)
        h = (h - mean) * torch.rsqrt(var + plan.norm_eps) * scale + bias
    for i, act in enumerate(plan.acts):
        w = take(dims[i + 1] * dims[i]).view(dims[i + 1], dims[i])
        b = take(dims[i + 1])
        if plan.bf16:
            h, w = bf16_round(h), bf16_round(w)
        h = get_activation(act)(F.linear(h, w) + b)
    p = dims[-1]
    nlo, nspan = take(p), take(p)
    neural = {}
    for i, name in enumerate(plan.neural_names):
        col = h[:, i]
        neural[name] = nlo[i] + nspan[i] * torch.sigmoid(col) if plan.scale_nn_outputs else col
    g = plan.n_globals
    graw, glo, gspan = take(g), take(g), take(g)
    scalars = torch.cat([glo + gspan * torch.sigmoid(graw), take(plan.n_fixed)])
    args = []
    for src, idx, const in plan.arg_sources:
        if src == _SRC_FORCING:
            args.append(forcing[plan.forcing_names[idx]])
        elif src == _SRC_NEURAL:
            args.append(neural[plan.neural_names[idx]])
        elif src == _SRC_SCALAR:
            args.append(scalars[idx : idx + 1])
        else:
            args.append(const)
    outs = plan.form.torch_fn(*args)  # an output of globals alone is broadcast to the rows
    return {**{k: v.expand(x.shape[0]) for k, v in zip(plan.output_names, outs)}, **neural}


def launch_fused_forward(plan: FusedPlan, x, forcing, outputs) -> None:
    """Launch the CUDA kernel once over the rows of ``x`` (checked CUDA
    float32 tensors), writing into ``outputs`` (name → ``(N,)``); raises if
    the launch is refused. Counts launches in ``launch_fused_forward.launches``."""
    lib = _build.kernel_library("fused_forward.cu", plan.form, bf16=plan.bf16, width=plan.width)
    if lib.eh_fused_forward_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_forward_args_size()} != {ctypes.sizeof(_Args)}"
        )
    a = _Args.from_buffer_copy(plan.args_bytes)
    a.x = x.data_ptr()
    a.n = x.shape[0]
    for i, name in enumerate(plan.forcing_names):
        a.forcing[i] = forcing[name].data_ptr()
    for i, name in enumerate(plan.output_names):
        a.out[i] = outputs[name].data_ptr()
    for i, name in enumerate(plan.neural_names):
        a.neural_out[i] = outputs[name].data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.eh_fused_forward(ctypes.byref(a), plan.width, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused forward kernel launch failed: {lib.eh_cuda_error_string(rc).decode()}"
        )
    launch_fused_forward.launches += 1


launch_fused_forward.launches = 0


def padded_rows(a: np.ndarray, padded: int, device) -> torch.Tensor:
    """Host rows ``a`` in float32 on ``device``, in a buffer of ``padded``
    rows: one copy of ``a``, the padding rows zeroed on the device."""
    host = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    buf = torch.empty((padded,) + tuple(host.shape[1:]), dtype=torch.float32, device=device)
    buf[: host.shape[0]].copy_(host)
    if padded > host.shape[0]:
        buf[host.shape[0]:].zero_()
    return buf


class FusedForward:
    """``fn(x, forcing) -> {output…, neural parameter…}`` over a snapshot of
    the model's parameters. On CUDA tensors the rows go through the kernel
    in one launch (one per group of ``_GROUP_ROWS`` rows, whole chunks of
    ``batch_size``: rows are independent, so the bits are those of one
    launch per chunk, the JAX kernel's grid step); on CPU tensors the plain
    version computes the same function. :meth:`table` serves host rows."""

    def __init__(self, model, *, batch_size: int = 1024):
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive; got {batch_size}")
        self.plan = plan_fused_forward(model)
        self.batch_size = int(batch_size)
        self.group_rows = max(1, _GROUP_ROWS // self.batch_size) * self.batch_size

    def _check(self, x, forcing):
        plan = self.plan
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != plan.n_features:
            raise ValueError(
                f"x must be float32 of shape (N, {plan.n_features}); got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        cols = {}
        for name in plan.forcing_names:
            if name not in forcing:
                raise KeyError(f"forcing column {name!r} is missing")
            col = forcing[name]
            if col.dtype != torch.float32 or tuple(col.shape) != (x.shape[0],):
                raise ValueError(
                    f"forcing {name!r} must be float32 of shape ({x.shape[0]},); "
                    f"got {col.dtype} {tuple(col.shape)}"
                )
            if col.device != x.device:
                raise ValueError(f"forcing {name!r} is on {col.device}, x on {x.device}")
            cols[name] = col
        return cols

    def reference(self, x, forcing) -> Dict[str, torch.Tensor]:
        """The plain PyTorch version on ``x``'s device (no launch)."""
        return fused_forward_reference(self.plan, x, self._check(x, forcing))

    def __call__(self, x, forcing: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cols = self._check(x, forcing)
        if x.device.type == "cpu":
            return fused_forward_reference(self.plan, x, cols)
        if x.device.type != "cuda":
            raise ValueError(f"the fused forward runs on CUDA or CPU tensors; got {x.device}")
        if self.plan.blob.device != x.device:
            raise ValueError(
                f"the model's parameters are on {self.plan.blob.device}, x on {x.device}"
            )
        if not x.is_contiguous() or not all(c.is_contiguous() for c in cols.values()):
            raise ValueError("the fused forward kernel takes contiguous tensors")
        n = x.shape[0]
        names = self.plan.output_names + self.plan.neural_names
        outputs = {k: torch.empty((n,), dtype=torch.float32, device=x.device) for k in names}
        for start in range(0, n, self.group_rows):
            end = min(start + self.group_rows, n)
            launch_fused_forward(
                self.plan,
                x[start:end],
                {k: c[start:end] for k, c in cols.items()},
                {k: o[start:end] for k, o in outputs.items()},
            )
        return outputs

    def table(self, x: np.ndarray, forcing: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The serving path: host rows ``x (n, F)`` and forcing columns in,
        ``{output…, neural parameter…}`` host columns of ``n`` rows out. Each
        input array is copied once into a buffer of whole chunks of
        ``batch_size`` rows on the model's device, its padding rows zeroed
        there; the rows are computed by one launch (one per group of
        ``_GROUP_ROWS`` rows for a larger table); each output comes back in
        one copy, the padding rows cut. With the model on the CPU the plain
        version computes the same rows."""
        dev = self.plan.blob.device
        n = int(x.shape[0])
        padded = max(1, -(-n // self.batch_size)) * self.batch_size
        out = self(padded_rows(x, padded, dev),
                   {name: padded_rows(forcing[name], padded, dev)
                    for name in self.plan.forcing_names})
        return {k: v[:n].cpu().numpy() for k, v in out.items()}


def make_fused_forward(model, *, batch_size: int = 1024) -> FusedForward:
    """Build the fused forward of ``model`` (see :class:`FusedForward`);
    raises if the model is outside the envelope or its kernel form's probe
    check fails."""
    return FusedForward(model, batch_size=batch_size)
