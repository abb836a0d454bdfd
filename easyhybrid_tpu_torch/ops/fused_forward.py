"""Fused hybrid forward (inference): a hand-written CUDA kernel for Hopper.

Counterpart of ``easyhybrid_tpu/ops/fused_forward.py``. The kernel
(``csrc/fused_forward.cu``) runs the whole forward of a SingleNN MLP hybrid
for every row: static or no input norm, the MLP, sigmoid bound scaling of
the neural outputs, the scaled globals and fixed parameters, the mechanistic
model, and a write of every mechanistic output and every scaled neural
parameter.

CUDA cannot trace an arbitrary Python function into the kernel the way
Pallas does, so the mechanistic model enters in a fixed **kernel form**: a
function tagged with :func:`kernel_form` names a form that the kernel
implements (this release: ``"rbq10"``). Each argument of the form is mapped
by name to a forcing column, a neural parameter, a global, a fixed
parameter, or else to the function's keyword default. When the forward is
built, the tagged function is evaluated once against the form's torch
transcription on probe values, and a mismatch raises.

On a CPU tensor the wrapper computes :func:`fused_forward_reference`, the
plain PyTorch version of the same function on the same packed parameters;
on a CUDA tensor it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.hybrid import SingleNNHybridModel, _call_mechanistic
from ..models.nn import MLP, get_activation
from . import _build

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
]

# caps of the kernel; they must equal the EH_MAX_* defines of the source
MAX_WIDTH = 64
MAX_LAYERS = 8
MAX_FORCING = 8
MAX_OUTPUTS = 8
MAX_ARGS = 8
MAX_SCALARS = 16
MAX_SMEM_FLOATS = 48 * 1024 // 4
_WIDTHS = (16, 32, 64)  # the kernel's compile-time widths

_ACT_IDS = {
    "identity": 0, "linear": 0, "tanh": 1, "relu": 2, "sigmoid": 3,
    "swish": 4, "silu": 4, "gelu": 5, "softplus": 6, "selu": 7, "elu": 8,
    "leakyrelu": 9,
}
_SRC_FORCING, _SRC_NEURAL, _SRC_SCALAR, _SRC_CONST = 0, 1, 2, 3


# --------------------------------------------------------------------------
# kernel forms of the mechanistic model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelForm:
    """A mechanistic model the kernel implements: its id in the CUDA source,
    its argument names in kernel order, and its torch transcription
    ``torch_fn(*args) -> tuple`` of ``n_outputs`` tensors, in the order of
    the outputs of the tagged function."""

    name: str
    form_id: int
    args: Tuple[str, ...]
    n_outputs: int
    torch_fn: Callable


def _rbq10_torch(rb, Q10, ta, tref):
    return (rb * torch.pow(Q10, 0.1 * (ta - tref)),)


KERNEL_FORMS: Dict[str, KernelForm] = {
    "rbq10": KernelForm("rbq10", 0, ("rb", "Q10", "ta", "tref"), 1, _rbq10_torch),
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

def _form_of(fn) -> Optional[KernelForm]:
    return KERNEL_FORMS.get(getattr(fn, "__kernel_form__", None))


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


def fused_forward_unsupported_reason(model) -> Optional[str]:
    """Why ``model`` is outside the kernel's envelope, or None if it is in.

    The envelope is the JAX kernel's (a SingleNN MLP hybrid with static or
    no input norm) plus this kernel's own limits: a mechanistic function
    tagged with a known kernel form whose arguments all resolve, the 12
    named activations, float32 with no ``compute_dtype``, and widths,
    depth and parameter counts within the caps above."""
    if not isinstance(model, SingleNNHybridModel):
        return f"{type(model).__name__} is not a SingleNNHybridModel"
    net = model.nn
    if net is None or not model.neural_param_names:
        return "the model has no neural network"
    if not isinstance(net, MLP):
        return f"the network is a {type(net).__name__}, not an MLP"
    if net.input_batchnorm is True:
        return "trainable input BatchNorm (input_batchnorm=True) is outside the kernel"
    if net.compute_dtype is not None:
        return f"compute_dtype={net.compute_dtype} (the kernel runs float32)"
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if t.dtype != torch.float32:
            return f"{name} is {t.dtype}, not float32"
    for layer in net.layers:
        if not isinstance(layer.activation, str) or layer.activation not in _ACT_IDS:
            return f"activation {layer.activation!r} is not one of the kernel's {len(_ACT_IDS)} names"
    dims = (net.in_dim,) + net.hidden + (net.out_dim,)
    if max(dims) > MAX_WIDTH:
        return f"layer widths {dims} exceed the kernel's cap of {MAX_WIDTH}"
    if len(dims) - 1 > MAX_LAYERS:
        return f"{len(dims) - 1} layers exceed the kernel's cap of {MAX_LAYERS}"
    if len(model.forcing) > MAX_FORCING:
        return f"{len(model.forcing)} forcing columns exceed the cap of {MAX_FORCING}"
    n_scalars = len(model.global_param_names) + len(model.fixed_param_names)
    if n_scalars > MAX_SCALARS:
        return f"{n_scalars} global and fixed parameters exceed the cap of {MAX_SCALARS}"
    if _blob_floats(model) + n_scalars > MAX_SMEM_FLOATS:
        return "the packed parameters exceed the kernel's 48 KiB of shared memory"
    form = _form_of(model.mechanistic_model)
    if form is None:
        name = getattr(model.mechanistic_model, "__name__", model.mechanistic_model)
        return f"mechanistic model {name!r} carries no kernel form (see kernel_form)"
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


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """What the kernel and its plain version read: the packed parameter
    blob (on the model's device) and the static layout."""

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

    @property
    def n_features(self) -> int:
        return self.dims[0]

    @functools.cached_property
    def args_bytes(self) -> bytes:
        """The kernel's static arguments, packed once; each launch copies
        them and fills in the pointers and the row count."""
        a = _Args()
        a.blob = self.blob.data_ptr()
        a.n_layers = len(self.dims) - 1
        a.dims[: len(self.dims)] = self.dims
        a.acts[: len(self.acts)] = [_ACT_IDS[act] for act in self.acts]
        a.has_norm = int(self.has_norm)
        a.norm_eps = self.norm_eps
        a.blob_floats = self.blob.numel()
        a.n_globals, a.n_fixed = self.n_globals, self.n_fixed
        a.scale_nn_outputs = int(self.scale_nn_outputs)
        a.form = self.form.form_id
        a.n_args = len(self.arg_sources)
        for i, (src, idx, const) in enumerate(self.arg_sources):
            a.arg_src[i], a.arg_idx[i], a.arg_const[i] = src, idx, const
        a.n_out = len(self.output_names)
        return bytes(a)


def _probe_outputs(model, form: KernelForm, arg_sources) -> Tuple[str, ...]:
    """Evaluate the tagged function and the form's transcription on probe
    values; return the function's output names, or raise on a mismatch."""
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
            f"mechanistic model {fn_name!r} is tagged {form.name!r} but returns "
            f"{len(want)} outputs {sorted(want)}; the form has {form.n_outputs}"
        )
    for (key, w), g in zip(want.items(), got):
        w = torch.as_tensor(w, dtype=torch.float32)
        g = torch.as_tensor(g, dtype=torch.float32)
        if w.shape != g.shape or not torch.allclose(w, g, rtol=1e-5, atol=1e-6, equal_nan=True):
            raise ValueError(
                f"mechanistic model {fn_name!r} is tagged {form.name!r} but its "
                f"output {key!r} disagrees with the form on probe values"
            )
    return tuple(want)


def plan_fused_forward(model) -> FusedPlan:
    """Check the envelope, run the form's probe check and pack the model's
    current parameters (a snapshot) for the kernel."""
    reason = fused_forward_unsupported_reason(model)
    if reason is not None:
        raise ValueError(f"model not supported by the fused forward kernel: {reason}")
    net = model.nn
    form = _form_of(model.mechanistic_model)
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
    )


# --------------------------------------------------------------------------
# plain version and kernel launch
# --------------------------------------------------------------------------

def fused_forward_reference(plan: FusedPlan, x, forcing) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same function on the
    same packed parameters, ``{output…, neural parameter…}``."""
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
    outs = plan.form.torch_fn(*args)
    return {**dict(zip(plan.output_names, outs)), **neural}


def launch_fused_forward(plan: FusedPlan, x, forcing, outputs) -> None:
    """Launch the CUDA kernel once over the rows of ``x`` (checked CUDA
    float32 tensors), writing into ``outputs`` (name → ``(N,)``); raises if
    the launch is refused. Counts launches in ``launch_fused_forward.launches``."""
    lib = _build.load_library()
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


class FusedForward:
    """``fn(x, forcing) -> {output…, neural parameter…}`` over a snapshot of
    the model's parameters. On CUDA tensors the rows go through the kernel
    in launches of at most ``batch_size`` rows (one launch per batch, as
    the JAX kernel runs one grid step per batch); on CPU tensors the plain
    version computes the same function."""

    def __init__(self, model, *, batch_size: int = 1024):
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive; got {batch_size}")
        self.plan = plan_fused_forward(model)
        self.batch_size = int(batch_size)

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
        for start in range(0, n, self.batch_size):
            end = min(start + self.batch_size, n)
            launch_fused_forward(
                self.plan,
                x[start:end],
                {k: c[start:end] for k, c in cols.items()},
                {k: o[start:end] for k, o in outputs.items()},
            )
        return outputs


def make_fused_forward(model, *, batch_size: int = 1024) -> FusedForward:
    """Build the fused forward of ``model`` (see :class:`FusedForward`);
    raises if the model is outside the envelope or its kernel form's probe
    check fails."""
    return FusedForward(model, batch_size=batch_size)
