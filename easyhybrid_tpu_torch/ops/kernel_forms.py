"""Kernel forms: the mechanistic model as the CUDA kernels evaluate it.

The JAX kernels trace the user's jnp function into the kernel and
differentiate it in forward mode. The port does the same in two steps. The
function is traced once with ``torch.fx`` on a wrapper that takes one
argument per name the model passes it (forcing, neural, global and fixed
parameters, as ``_call_mechanistic`` passes them) and calls it by keyword.
The graph is lowered to a short elementwise program (:class:`_Program`),
which is then

* emitted as a CUDA header: ``eh_traced_form`` (the outputs and every
  partial ``∂output/∂argument`` in forward mode, common subexpressions taken
  once, partials that are structurally zero dropped) and
  ``eh_traced_form_out`` (the outputs alone); each kernel is built against
  it (``ops/_build.py::form_library``);
* evaluated by torch, instruction by instruction in the same order, as the
  plain versions' ``torch_fn`` and ``partials_fn``.

The operation set: ``+ - * /``, unary minus, ``**`` with a traced value or a
constant on either side, ``torch.exp``, ``log``, ``sqrt``, ``sigmoid``,
``tanh``, ``abs``, ``minimum``, ``maximum``, ``clamp`` and ``where`` over a
comparison, and float constants. Anything else (another operation, a
module, a tensor constant, ``math.exp`` on a traced value, control flow on
a value) is refused with a reason that names it; such a model trains on the
torch engine.

The partials follow torch's forward-mode formulas, which the exactness gate
and the torch epoch share: half of each tangent at a tie of ``maximum`` /
``minimum``; at a ``clamp`` bound the tangent passes (and at a tie of
``clamp_min`` / ``clamp_max`` with a traced bound the value's); ``sgn`` for ``abs``;
``pow``'s exponent partial is 0 where the base is 0 and the exponent is not
negative. Values keep NaN where torch's ``maximum`` / ``minimum`` do.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import math
import operator
import struct
import weakref
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import torch
import torch.fx

__all__ = ["KernelForm", "LossForm", "MAX_ARGS", "MAX_OUTPUTS", "FORM_RBQ10", "FORM_TRACED",
           "traced_form", "traced_loss"]

# caps of the kernels: EH_MAX_ARGS and EH_MAX_OUT in csrc/eh_device.cuh
MAX_ARGS = 8
MAX_OUTPUTS = 8
# the forms' ids in csrc/eh_device.cuh (FORM_*)
FORM_RBQ10, FORM_TRACED = 0, 1


@dataclasses.dataclass(frozen=True)
class KernelForm:
    """A mechanistic model the kernels implement: its id in the CUDA
    sources, its argument names in kernel order, its torch transcription
    ``torch_fn(*args) -> tuple`` of ``n_outputs`` tensors (in the order of
    the function's outputs), and the transcription of its partials
    ``partials_fn(*args) -> tuple`` (one per output) of tuples (one per
    argument) of ``∂output/∂argument``, which the training kernels use in
    place of automatic differentiation. A traced form carries the CUDA
    header its kernels are built against (``header``); a hand-written form
    lives in ``csrc/eh_device.cuh`` and has none."""

    name: str
    form_id: int
    args: Tuple[str, ...]
    n_outputs: int
    torch_fn: Callable
    partials_fn: Callable
    header: Optional[str] = None

    @property
    def header_hash(self) -> str:
        """A hash of the header's text, which names the header's file."""
        return hashlib.sha256(self.header.encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# the elementwise program
# --------------------------------------------------------------------------

_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_BOOL = tuple(_CMP) + ("and",)

_TORCH_OPS = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "abs": torch.abs, "sgn": torch.sgn,
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div, "pow": torch.pow,
    "max": torch.maximum, "min": torch.minimum, "and": torch.logical_and,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge, "eq": torch.eq,
    "ne": torch.ne, "select": torch.where,
    "clamp": torch.clamp, "clamp_t": torch.clamp,
    "clamp_lo": lambda x, lo: torch.clamp(x, min=lo),
    "clamp_hi": lambda x, hi: torch.clamp(x, max=hi),
    "clamp_min_t": torch.clamp_min, "clamp_max_t": torch.clamp_max,
}
# CUDA's single-precision functions (no --use_fast_math); maximum and minimum
# keep NaN as torch's do, and pick as torch's CPU kernels do at signed zeros
_MAX = "eht_max({0}, {1})"
_MIN = "eht_min({0}, {1})"
_CUDA_OPS = {
    "neg": "-{0}", "exp": "expf({0})", "log": "logf({0})", "sqrt": "sqrtf({0})",
    "sigmoid": "1.0f / (1.0f + expf(-{0}))", "tanh": "tanhf({0})", "abs": "fabsf({0})",
    "sgn": "(float)((0.0f < {0}) - ({0} < 0.0f))",
    "add": "{0} + {1}", "sub": "{0} - {1}", "mul": "{0} * {1}", "div": "{0} / {1}",
    "pow": "powf({0}, {1})", "max": _MAX, "min": _MIN, "and": "{0} && {1}",
    "select": "{0} ? {1} : {2}",
    "clamp": "eht_min(eht_max({0}, {1}), {2})", "clamp_t": "eht_min(eht_max({0}, {1}), {2})",
    "clamp_lo": _MAX, "clamp_hi": _MIN, "clamp_min_t": _MAX, "clamp_max_t": _MIN,
    **{op: "{0} " + sym + " {1}" for op, sym in _CMP.items()},
}
# guarded: a kernel built against a form and a loss includes both headers
_HEADER_HELPERS = """\
#ifndef EHT_HELPERS
#define EHT_HELPERS
__device__ __forceinline__ float eht_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? b : a);
}
__device__ __forceinline__ float eht_min(float a, float b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
#endif
"""


def _f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _bits_f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


class _Program:
    """Straight-line float32 code in static single assignment. ``ops[i]`` is
    ``(op, operands)``: ``arg`` (operand: the argument's index), ``const``
    (operand: the float32's bits), an operation of ``_TORCH_OPS`` (operands:
    instructions), the comparisons and ``and`` giving bools. Adding an
    instruction that exists returns the existing one, so common
    subexpressions are taken once. ``logs`` holds, for a constant that is a
    base of ``pow``, the logarithm of the constant as the user wrote it."""

    def __init__(self):
        self.ops: List[Tuple[str, Tuple[int, ...]]] = []
        self._index: Dict[Tuple[str, Tuple[int, ...]], int] = {}
        self.logs: Dict[int, float] = {}
        # the constants as tensors, made once per device: a tensor made from a
        # number on the card is a copy that waits for the device
        self._consts: Dict[Tuple[int, str], torch.Tensor] = {}

    def add(self, op: str, *operands: int) -> int:
        key = (op, operands)
        if key not in self._index:
            self._index[key] = len(self.ops)
            self.ops.append(key)
        return self._index[key]

    def const(self, value: float) -> int:
        return self.add("const", _f32_bits(value))

    def select(self, cond: int, a: int, b: int) -> int:
        return a if a == b else self.add("select", cond, a, b)

    def mul(self, a: int, b: int) -> int:
        one = self.const(1.0)
        if a == one:  # 1 * x is x, exactly
            return b
        return a if b == one else self.add("mul", a, b)

    def is_bool(self, v: int) -> bool:
        return self.ops[v][0] in _BOOL

    def closure(self, roots: Sequence[int]) -> List[int]:
        """The instructions ``roots`` depend on, in program order."""
        need, stack = set(), list(roots)
        while stack:
            v = stack.pop()
            if v not in need:
                need.add(v)
                op, operands = self.ops[v]
                if op not in ("arg", "const"):
                    stack.extend(operands)
        return sorted(need)

    def depends(self) -> List[FrozenSet[int]]:
        """The arguments each instruction depends on."""
        out: List[FrozenSet[int]] = []
        for op, x in self.ops:
            if op == "arg":
                out.append(frozenset(x))
            elif op == "const":
                out.append(frozenset())
            else:
                out.append(frozenset().union(*(out[i] for i in x)))
        return out

    def evaluate(self, roots: Sequence[int], args) -> Dict[int, torch.Tensor]:
        """Every instruction ``roots`` depend on, by torch, in program order."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        device = tensors[0].device if tensors else None
        val: Dict[int, torch.Tensor] = {}
        for v in self.closure(roots):
            op, x = self.ops[v]
            if op == "arg":
                val[v] = torch.as_tensor(args[x[0]], dtype=torch.float32, device=device)
            elif op == "const":
                key = (v, str(device))
                if key not in self._consts:
                    self._consts[key] = torch.tensor(_bits_f32(x[0]), dtype=torch.float32,
                                                     device=device)
                val[v] = self._consts[key]
            else:
                val[v] = _TORCH_OPS[op](*(val[i] for i in x))
        return val

    def emit(self, roots: Sequence[int]) -> List[str]:
        """CUDA statements for every instruction ``roots`` depend on;
        constants by their float32 bits."""
        lines = []
        for v in self.closure(roots):
            op, x = self.ops[v]
            if op == "arg":
                expr = f"av[{x[0]}]"
            elif op == "const":
                expr = f"__int_as_float((int)0x{x[0]:08x}u)"
            else:
                expr = _CUDA_OPS[op].format(*(f"v{i}" for i in x))
            lines.append(f"  const {'bool' if op in _BOOL else 'float'} v{v} = {expr};")
        return lines


# --------------------------------------------------------------------------
# forward-mode partials
# --------------------------------------------------------------------------

class _Tangents:
    """The tangent of each instruction with respect to argument ``arg``,
    built into the same program by torch's forward-mode formulas; ``None``
    where it is structurally zero."""

    def __init__(self, prog: _Program, arg: int, depends: List[FrozenSet[int]]):
        self.p, self.arg, self.depends = prog, arg, depends
        self.t: Dict[int, Optional[int]] = {}

    def of(self, v: int) -> Optional[int]:
        if v not in self.t:
            self.t[v] = self._rule(v) if self.arg in self.depends[v] else None
        return self.t[v]

    def _rule(self, v: int) -> int:
        p = self.p
        op, x = p.ops[v]
        zero, one = p.const(0.0), p.const(1.0)
        if op == "arg":
            return one
        if op in _BOOL:
            return None
        t = [None if p.is_bool(i) else self.of(i) for i in x]
        tz = [zero if ti is None else ti for ti in t]
        if op == "select":
            return p.select(x[0], tz[1], tz[2])
        a, ta = x[0], t[0]
        if op == "neg":
            return p.add("neg", ta)
        if op == "exp":  # self_t * result
            return p.mul(ta, v)
        if op == "log":  # self_t / self
            return p.add("div", ta, a)
        if op == "sqrt":  # self_t / (2 * result)
            return p.add("div", ta, p.mul(p.const(2.0), v))
        if op == "sigmoid":  # self_t * (1 - result) * result
            return p.mul(p.mul(ta, p.add("sub", one, v)), v)
        if op == "tanh":  # self_t * (1 - result * result)
            return p.mul(ta, p.add("sub", one, p.mul(v, v)))
        if op == "abs":  # self_t * sgn(self): 0 at 0
            return p.mul(ta, p.add("sgn", a))
        if op == "clamp":  # constant bounds: the tangent where lo <= x <= hi, else 0
            inside = p.add("and", p.add("ge", a, x[1]), p.add("le", a, x[2]))
            return p.select(inside, ta, zero)
        b, tb = x[1], t[1]
        if op == "clamp_t":  # traced bounds, torch's clamp_jvp
            hi, thi = x[2], tz[2]
            pick = p.select(p.add("gt", a, hi), thi, tz[0])
            pick = p.select(p.add("lt", a, b), tz[1], pick)
            return p.select(p.add("gt", b, hi), thi, pick)
        if op == "clamp_lo":  # traced bounds, torch's clamp_jvp
            return p.select(p.add("gt", a, b), tz[0], tz[1])
        if op == "clamp_hi":
            return p.select(p.add("lt", a, b), tz[0], tz[1])
        if op == "clamp_min_t":  # torch.clamp_min's own: the tangent passes at a tie
            return p.select(p.add("ge", a, b), tz[0], tz[1])
        if op == "clamp_max_t":
            return p.select(p.add("le", a, b), tz[0], tz[1])
        if op in ("add", "sub"):
            if ta is None:
                return tb if op == "add" else p.add("neg", tb)
            return ta if tb is None else p.add(op, ta, tb)
        if op == "mul":
            if ta is None:
                return p.mul(a, tb)
            return p.mul(ta, b) if tb is None else p.add("add", p.mul(ta, b), p.mul(a, tb))
        if op == "div":  # (self_t - other_t * result) / other
            if tb is None:
                return p.add("div", ta, b)
            num = p.mul(tb, v)
            return p.add("div", p.add("neg", num) if ta is None else p.add("sub", ta, num), b)
        if op in ("max", "min"):  # half of each at a tie, else the chosen side's
            tie = p.mul(p.add("add", tz[0], tz[1]), p.const(0.5))
            pick = p.select(p.add("gt" if op == "max" else "lt", a, b), tz[0], tz[1])
            return p.select(p.add("eq", a, b), tie, pick)
        if op == "pow":
            return self._pow(v, a, b, t)
        raise AssertionError(op)

    def _pow(self, v: int, a: int, b: int, t) -> int:
        """torch's forward mode of ``a ** b``: the base's term
        ``where(b == 0, 0, t_a * (b * a ** (b - 1)))`` plus the exponent's
        ``t_b * where(a == 0 & b >= 0, 0, result * log(a))``. An operand that
        depends on some argument has a tangent, zero where it does not depend
        on this one, and a factor that is not finite then gives NaN, as
        ``torch.func.jvp`` gives it; a constant operand has none."""
        p = self.p
        zero, one = p.const(0.0), p.const(1.0)
        terms = []
        if self.depends[a]:
            fa = p.select(p.add("eq", b, zero), zero,
                          p.mul(b, p.add("pow", a, p.add("sub", b, one))))
            terms.append(p.mul(zero if t[0] is None else t[0], fa))
        if self.depends[b]:
            log_a = p.const(p.logs[a]) if a in p.logs else p.add("log", a)
            fb = p.mul(v, log_a)
            if a not in p.logs or p.logs[a] == -math.inf:  # a base that may be 0
                masked = p.add("and", p.add("eq", a, zero), p.add("ge", b, zero))
                fb = p.select(masked, zero, fb)
            terms.append(p.mul(zero if t[1] is None else t[1], fb))
        return terms[0] if len(terms) == 1 else p.add("add", *terms)


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

class _Refused(Exception):
    """The function is outside what the tracer expresses; the message is the
    engine reason."""


_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul", operator.truediv: "div",
    operator.neg: "neg", operator.pow: "pow", operator.abs: "abs",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt", operator.ge: "ge",
    operator.eq: "eq", operator.ne: "ne",
    torch.add: "add", torch.sub: "sub", torch.mul: "mul", torch.div: "div", torch.neg: "neg",
    torch.pow: "pow", torch.exp: "exp", torch.log: "log", torch.sqrt: "sqrt",
    torch.sigmoid: "sigmoid", torch.tanh: "tanh", torch.abs: "abs",
    torch.maximum: "max", torch.minimum: "min", torch.clamp: "clamp", torch.clip: "clamp",
    torch.clamp_min: "clamp_min", torch.clamp_max: "clamp_max",
    torch.where: "where", torch.lt: "lt", torch.le: "le", torch.gt: "gt", torch.ge: "ge",
    torch.eq: "eq", torch.ne: "ne",
}
_METHODS = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div", "neg": "neg", "pow": "pow",
    "exp": "exp", "log": "log", "sqrt": "sqrt", "sigmoid": "sigmoid", "tanh": "tanh",
    "abs": "abs", "clamp": "clamp", "clip": "clamp", "maximum": "max", "minimum": "min",
    "clamp_min": "clamp_min", "clamp_max": "clamp_max",
}
_SET = ("+ - * / **, exp, log, sqrt, sigmoid, tanh, abs, minimum, maximum, clamp, clamp_min, "
        "clamp_max and where over a comparison")


def _target_name(node: torch.fx.Node) -> str:
    t = node.target
    if node.op == "call_method":
        return f"Tensor.{t}"
    if node.op != "call_function":
        return f"{node.op} {t!r}"
    name = getattr(t, "__name__", repr(t))
    if getattr(torch, name, None) is t:
        return f"torch.{name}"
    module = getattr(t, "__module__", None) or ""
    return f"{module}.{name}" if module else name


class _Lowering:
    """The fx graph of the wrapper, lowered into a :class:`_Program`; only
    the arguments in ``index`` (name -> argument index) may be used."""

    def __init__(self, graph: torch.fx.Graph, index: Dict[str, int]):
        self.p = _Program()
        self.env: Dict[torch.fx.Node, Optional[int]] = {}
        self.outputs: Dict[str, int] = {}
        self.placeholders: Dict[int, str] = {}
        for node in graph.nodes:
            if node.op == "placeholder":
                self.env[node] = (self.p.add("arg", index[node.target])
                                  if node.target in index else None)
                if node.target in index:
                    self.placeholders[self.env[node]] = node.target
            elif node.op in ("call_function", "call_method"):
                self.env[node] = self._call(node)
            elif node.op == "output":
                self._outputs(node.args[0])
            else:
                raise _Refused(f"{_target_name(node)} (a traced form takes no modules, "
                               "attributes or tensor constants)")

    def value(self, x, where: str) -> int:
        if isinstance(x, torch.fx.Node):
            v = self.env[x]
            if v is not None and self.p.is_bool(v):
                raise _Refused(f"{where} takes a comparison as a number (a comparison may "
                               "only be the condition of where)")
            return v
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            return self.p.const(float(x))
        raise _Refused(f"{where} takes an operand of type {type(x).__name__}")

    def _call(self, node: torch.fx.Node) -> int:
        op = (_METHODS if node.op == "call_method" else _FUNCTIONS).get(node.target)
        name = _target_name(node)
        if op is None:
            raise _Refused(f"operation {name} is outside the traced forms' set ({_SET})")
        args, kwargs = list(node.args), dict(node.kwargs)
        if op == "clamp":
            return self._clamp(name, args, kwargs)
        if op in ("clamp_min", "clamp_max"):  # one bound
            key = "min" if op == "clamp_min" else "max"
            bound = kwargs.pop(key, args[1] if len(args) > 1 else None)
            if bound is None:
                raise _Refused(f"{name} without a bound")
            if not isinstance(bound, torch.fx.Node):  # a constant: clamp's
                return self._clamp(name, args[:1], {**kwargs, key: bound})
            if kwargs:
                raise _Refused(f"{name} with keyword arguments {sorted(kwargs)}")
            ids = [self.value(args[0], name), self.value(bound, name)]
            return None if None in ids else self.p.add(op + "_t", *ids)
        if kwargs:
            raise _Refused(f"{name} with keyword arguments {sorted(kwargs)}")
        if op == "where":
            cond = args[0] if len(args) == 3 else None
            if not (isinstance(cond, torch.fx.Node) and cond.target in _FUNCTIONS
                    and _FUNCTIONS[cond.target] in _CMP):
                raise _Refused(f"{name} without a comparison of two values as its condition")
            ids = [self.env[cond], self.value(args[1], name), self.value(args[2], name)]
            return None if None in ids else self.p.select(*ids)
        if op == "pow":
            return self._pow(name, *args)
        ids = [self.value(a, name) for a in args]
        if None in ids:  # on an argument the outputs do not use
            return None
        return self.p.mul(*ids) if op == "mul" else self.p.add(op, *ids)

    def _pow(self, name: str, base, exponent) -> int:
        """``base ** exponent``. A constant exponent is taken as torch takes
        it: 0 and 1 exactly, 2 and 3 as products, 0.5 as a square root, -1 as
        a reciprocal, any other by pow."""
        p = self.p
        b, e = self.value(base, name), self.value(exponent, name)
        if b is None or e is None:
            return None
        if not isinstance(exponent, torch.fx.Node):
            c = float(exponent)
            if c == 0.0:
                return p.const(1.0)
            if c == 1.0:
                return b
            if c == 2.0:
                return p.mul(b, b)
            if c == 3.0:
                return p.mul(p.mul(b, b), b)
            if c == 0.5:
                return p.add("sqrt", b)
            if c == -1.0:
                return p.add("div", p.const(1.0), b)
            return p.add("pow", b, e)
        if not isinstance(base, torch.fx.Node):  # torch takes log(base) of the scalar
            c = float(base)
            p.logs.setdefault(b, math.log(c) if c > 0 else -math.inf if c == 0 else math.nan)
        return p.add("pow", b, e)

    def _clamp(self, name: str, args, kwargs) -> int:
        bounds = list(args[1:3]) + [None] * (3 - len(args))
        lo, hi = kwargs.pop("min", bounds[0]), kwargs.pop("max", bounds[1])
        if kwargs:
            raise _Refused(f"{name} with keyword arguments {sorted(kwargs)}")
        traced = {isinstance(bound, torch.fx.Node) for bound in (lo, hi) if bound is not None}
        if not traced:
            raise _Refused(f"{name} without a bound")
        if len(traced) == 2:
            raise _Refused(f"{name} with one constant and one traced bound")
        x = self.value(args[0], name)
        ids = [self.value(bound, name) for bound in (lo, hi) if bound is not None]
        if x is None or None in ids:
            return None
        if traced == {False}:  # constant bounds, a missing one infinite
            return self.p.add("clamp", x, self.p.const(-math.inf if lo is None else float(lo)),
                              self.p.const(math.inf if hi is None else float(hi)))
        if lo is not None and hi is not None:
            return self.p.add("clamp_t", x, *ids)
        return self.p.add("clamp_lo" if lo is not None else "clamp_hi", x, *ids)

    def _outputs(self, out) -> None:
        if hasattr(out, "_asdict"):
            out = out._asdict()
        if not isinstance(out, dict):
            raise _Refused(f"the function returns a {type(out).__name__}, not a dict of "
                           "named outputs")
        for key, x in out.items():
            v = self.value(x, f"output {key!r}")
            if v is None:
                raise _Refused(f"output {key!r} is an argument the model does not pass")
            self.outputs[str(key)] = v


def _wrapper(fn, names: Sequence[str]):
    """``traced(a, b, ...)`` calling ``fn(a=a, b=b, ...)``: one argument per
    name, for ``torch.fx.symbolic_trace``."""
    src = (f"def traced({', '.join(names)}):\n"
           f"    return __eh_mechanistic__({', '.join(f'{n}={n}' for n in names)})\n")
    scope = {"__eh_mechanistic__": fn}
    exec(compile(src, "<traced kernel form>", "exec"), scope)
    return scope["traced"]


def _argument_names(fn, available: Sequence[str]) -> List[str]:
    """The names ``_call_mechanistic`` passes ``fn`` from ``available``."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        raise _Refused("it has no signature to trace") from None
    kinds = inspect.Parameter
    named = [q for q in sig.parameters.values()
             if q.kind in (kinds.POSITIONAL_OR_KEYWORD, kinds.KEYWORD_ONLY)]
    var_kw = any(q.kind is kinds.VAR_KEYWORD for q in sig.parameters.values())
    if var_kw and not named:
        raise _Refused("it takes only **kwargs: the tracer needs its arguments by name")
    for q in sig.parameters.values():
        if q.kind is kinds.POSITIONAL_ONLY and q.default is q.empty:
            raise _Refused(f"it takes {q.name!r} by position only")
    given = set(available)
    for q in named:
        if q.default is q.empty and q.name not in given:
            raise _Refused(f"argument {q.name!r} is neither a forcing column, a "
                           "parameter nor a keyword default")
    names = [q.name for q in named if q.name in given]
    if var_kw:
        names += [n for n in available if n not in names]
    return names


def _trace(fn, available: Tuple[str, ...]) -> KernelForm:
    names = _argument_names(fn, available)
    try:
        graph = torch.fx.symbolic_trace(_wrapper(fn, names)).graph
    except torch.fx.proxy.TraceError as e:
        raise _Refused(f"control flow on a traced value ({e})") from None
    except Exception as e:  # the user's code raised while traced: that is the reason
        raise _Refused(f"tracing it raised {type(e).__name__}: {e}") from None
    # lower once to find the arguments the outputs use, then again over those
    low = _Lowering(graph, {n: i for i, n in enumerate(names)})
    used = [low.placeholders[v] for v in low.p.closure(list(low.outputs.values()))
            if low.p.ops[v][0] == "arg"]
    args = [n for n in names if n in used]
    if not args:
        raise _Refused("it uses none of its arguments")
    if not low.outputs:
        raise _Refused("it returns no outputs")
    if len(low.outputs) > MAX_OUTPUTS:
        raise _Refused(f"{len(low.outputs)} outputs exceed the kernels' cap of {MAX_OUTPUTS}")
    if len(args) > MAX_ARGS:
        raise _Refused(f"{len(args)} arguments exceed the kernels' cap of {MAX_ARGS}")
    low = _Lowering(graph, {n: i for i, n in enumerate(args)})
    prog, outs = low.p, list(low.outputs.values())
    depends = prog.depends()
    parts = [[None] * len(args) for _ in outs]
    for i in range(len(args)):
        tangents = _Tangents(prog, i, depends)
        for o, v in enumerate(outs):
            parts[o][i] = tangents.of(v)
    return KernelForm(
        name=f"traced {getattr(fn, '__name__', type(fn).__name__)}", form_id=FORM_TRACED, args=tuple(args), n_outputs=len(outs),
        torch_fn=_torch_fn(prog, outs), partials_fn=_partials_fn(prog, parts),
        header=_header(prog, outs, parts, len(args)))


def _torch_fn(prog: _Program, outs: List[int]) -> Callable:
    def torch_fn(*args):
        val = prog.evaluate(outs, args)
        shape = torch.broadcast_shapes(*(torch.as_tensor(a).shape for a in args))
        return tuple(val[v].expand(shape) for v in outs)

    return torch_fn


def _partials_fn(prog: _Program, parts: List[List[Optional[int]]]) -> Callable:
    roots = [v for row in parts for v in row if v is not None]

    def partials_fn(*args):
        val = prog.evaluate(roots, args)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        zero = torch.zeros((), dtype=torch.float32,
                           device=tensors[0].device if tensors else None)
        return tuple(tuple(zero if v is None else val[v] for v in row) for row in parts)

    return partials_fn


def _header(prog: _Program, outs: List[int], parts, n_args: int) -> str:
    """The CUDA header of the form: a pure function of the program."""
    pd = [(o, i, v) for o, row in enumerate(parts) for i, v in enumerate(row) if v is not None]
    lines = [
        f"// A traced kernel form: {n_args} arguments, {len(outs)} outputs; generated by",
        "// easyhybrid_tpu_torch/ops/kernel_forms.py from the function's graph.",
        "#pragma once", "", _HEADER_HELPERS,
        "// the outputs and their partials with respect to every argument (those not",
        "// written are structurally zero: the caller zeroed them)",
        "__device__ __forceinline__ void eh_traced_form(const float (&av)[EH_MAX_ARGS],",
        "                                               float (&out)[EH_MAX_OUT],",
        "                                               float (&pd)[EH_MAX_OUT][EH_MAX_ARGS]) {",
        *prog.emit(outs + [v for _, _, v in pd]),
        *(f"  out[{o}] = v{v};" for o, v in enumerate(outs)),
        *(f"  pd[{o}][{i}] = v{v};" for o, i, v in pd),
        "}", "",
        "// the outputs alone, for inference",
        "__device__ __forceinline__ void eh_traced_form_out(const float (&av)[EH_MAX_ARGS],",
        "                                                   float (&out)[EH_MAX_OUT]) {",
        *prog.emit(outs),
        *(f"  out[{o}] = v{v};" for o, v in enumerate(outs)),
        "}", "",
    ]
    return "\n".join(lines)


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def traced_form(fn, available: Sequence[str]) -> Union[KernelForm, str]:
    """The traced kernel form of mechanistic function ``fn`` for a model
    that passes it the names ``available`` (forcing columns, then neural,
    global and fixed parameters), or the reason it cannot be traced. Cached
    per function object and names, so a ``train()`` and a ``predict`` trace
    once."""
    key = tuple(available)
    try:
        per_fn = _CACHE.setdefault(fn, {})
    except TypeError:  # not weakly referenceable: traced each time
        per_fn = {}
    if key not in per_fn:
        try:
            per_fn[key] = _trace(fn, key)
        except _Refused as e:
            name = getattr(fn, "__name__", type(fn).__name__)
            per_fn[key] = f"mechanistic model {name!r} has no kernel form: {e}"
    return per_fn[key]


# --------------------------------------------------------------------------
# the elementwise training loss
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LossForm:
    """An :class:`~easyhybrid_tpu_torch.losses.specs.ElementwiseLoss` as the
    training kernels evaluate it: ``ℓ(ŷ, y)`` with its args as float32
    constants, traced into the same elementwise program as a kernel form.
    ``value_fn(yh, y)`` and ``grad_fn(yh, y)`` (``dℓ/dŷ``, forward mode as
    :class:`_Tangents` takes it) evaluate the program with torch; ``header``
    is the CUDA header of ``eh_traced_loss(yh, y, val, dval)`` the kernels
    are built against (``ops/_build.py::form_library``). ``normalize`` is the
    spec's: ``"mean"`` scales the masked sum by ``agg / n``, ``"sum"`` by
    ``agg``."""

    name: str
    normalize: str
    value_fn: Callable
    grad_fn: Callable
    header: str

    @property
    def header_hash(self) -> str:
        return hashlib.sha256(self.header.encode()).hexdigest()[:16]


def _trace_loss(spec) -> LossForm:
    fn, args, kwargs = spec.fn, tuple(spec.args), dict(spec.kwargs)

    def loss(y_hat, y):
        return {"loss": fn(y_hat, y, *args, **kwargs)}

    try:
        graph = torch.fx.symbolic_trace(loss).graph
    except torch.fx.proxy.TraceError as e:
        raise _Refused(f"control flow on a traced value ({e})") from None
    except Exception as e:  # the user's code raised while traced: that is the reason
        raise _Refused(f"tracing it raised {type(e).__name__}: {e}") from None
    low = _Lowering(graph, {"y_hat": 0, "y": 1})
    prog, out = low.p, low.outputs["loss"]
    grad = _Tangents(prog, 0, prog.depends()).of(out)
    if grad is None:  # the loss does not depend on the prediction
        grad = prog.const(0.0)
    value_fn, grad_fn = _torch_fn(prog, [out]), _torch_fn(prog, [grad])
    lines = [
        "// A traced elementwise loss l(yh, y) and dl/dyh; generated by",
        "// easyhybrid_tpu_torch/ops/kernel_forms.py from the loss function's graph.",
        "#pragma once", "", _HEADER_HELPERS,
        "__device__ __forceinline__ void eh_traced_loss(float yh, float y, float& val, float& dval) {",
        "  const float av[2] = {yh, y};",
        *prog.emit([out, grad]),
        f"  val = v{out};",
        f"  dval = v{grad};",
        "}", "",
    ]
    return LossForm(
        name=spec.name or getattr(spec.fn, "__name__", type(spec.fn).__name__),
        normalize=spec.normalize,
        value_fn=lambda yh, y: value_fn(yh, y)[0],
        grad_fn=lambda yh, y: grad_fn(yh, y)[0],
        header="\n".join(lines))


_LOSS_CACHE: Dict[object, Union[LossForm, str]] = {}


def traced_loss(spec) -> Union[LossForm, str]:
    """The kernel form of an elementwise training loss (``ElementwiseLoss``),
    or the reason it has none: ``"training loss '<name>' has no kernel form:
    <cause>"``. Cached per spec, as :func:`traced_form` per function."""
    try:
        hash(spec)
        key = spec
    except TypeError:  # an unhashable argument: traced each time
        key = None
    if key is None or key not in _LOSS_CACHE:
        try:
            got: Union[LossForm, str] = _trace_loss(spec)
        except _Refused as e:
            name = spec.name or getattr(spec.fn, "__name__", type(spec.fn).__name__)
            got = f"training loss {name!r} has no kernel form: {e}"
        if key is None:
            return got
        _LOSS_CACHE[key] = got
    return _LOSS_CACHE[key]
