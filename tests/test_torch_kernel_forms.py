"""Traced kernel forms (``ops/kernel_forms.py``): the tracer's operations
against the user's function (equal bits) and their partials against
``torch.func.jvp`` (rtol 1e-4, atol 1e-6), NaN and tie points, each refusal
with its cause, the emitted header (a pure function of the graph, its
constants as bits, and its arithmetic compiled on the host by g++ against the
plain version, rtol 1e-5), the build's plumbing and its refusal to fall back;
the envelopes of the three models of the repository that had no kernel form;
and the plain version of each of the five kernels with a traced form against
the JAX kernel in interpret mode, at the tolerances of that kernel's own
parity tests."""

import ctypes
import math
import re
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.data.prepare import HybridData as JaxHybridData
from easyhybrid_tpu.ops.fused_epoch import _pick_batch_chunks
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.ops.fused_forward import make_fused_forward as jax_make_fused_forward
from easyhybrid_tpu.ops.fused_multisite import make_fused_multisite_epoch as jax_fused_multisite
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_forward as ff
from easyhybrid_tpu_torch.ops import kernel_forms as kf
from easyhybrid_tpu_torch.training import epoch as tepoch
from test_torch_fused_epoch import assert_model_matches, jax_perms
from test_torch_fused_lstm import setup as lstm_setup

LL = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
JLL = eh.LoggingLoss(training_loss="mse", loss_types=("mse",))
RBQ10_PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}
EXPO_PARAMS = {"rb": (2.0, 0.0, 8.0), "k": (0.05, 0.0, 0.2)}


# the repository's mechanistic functions that had no kernel form: a copy of
# examples/rbq10.py's, the two-output model of tests/test_fused.py (torch and
# jnp), and the exponential model of examples/expo_hybrid.py
def rbq10(*, ta, rb, Q10, tref=15.0):
    reco = rb * Q10 ** (0.1 * (ta - tref))
    return {"reco": reco}


def two_outputs(*, ta, rb, gpp_max, Q10):
    reco = rb * Q10 ** (0.1 * (ta - 15.0))
    gpp = gpp_max * (1.0 - torch.exp(-0.1 * ta))
    return {"reco": reco, "nee": reco - gpp}


def two_outputs_jnp(*, ta, rb, gpp_max, Q10):
    reco = rb * Q10 ** (0.1 * (ta - 15.0))
    gpp = gpp_max * (1.0 - jnp.exp(-0.1 * ta))
    return {"reco": reco, "nee": reco - gpp}


def expo_model(*, ta, rb, k):
    return {"reco": rb * np.e ** (k * ta)}


TWO_SPEC = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco", "nee"],
    parameters={**RBQ10_PARAMS, "gpp_max": (5.0, 0.0, 20.0)},
    neural_param_names=["rb", "gpp_max"], global_param_names=["Q10"],
    hidden_layers=[8], activation="tanh", scale_nn_outputs=True, input_batchnorm="static")
EXPO_SPEC = dict(
    predictors=["sw_pot", "moisture"], forcing=["ta"], targets=["reco"], parameters=EXPO_PARAMS,
    neural_param_names=["rb", "k"], hidden_layers=[16, 16], activation="swish",
    scale_nn_outputs=True, input_batchnorm="static")
RBQ10_SPEC = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"], parameters=RBQ10_PARAMS,
    neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
    activation="swish", scale_nn_outputs=True, input_batchnorm="static")


def expo_columns(n, seed=0):
    """The data of examples/expo_hybrid.py: rb and k from sw_pot and moisture."""
    rng = np.random.default_rng(seed)
    ta = rng.normal(12.0, 6.0, n).astype(np.float32)
    sw_pot = np.abs(50 + 20 * rng.standard_normal(n)).astype(np.float32)
    moisture = rng.random(n).astype(np.float32)
    reco = (2.0 + 0.02 * (sw_pot - sw_pot.mean())) * np.exp((0.05 + 0.03 * moisture) * ta)
    reco = reco + 0.1 * rng.standard_normal(n)
    return dict(ta=ta, sw_pot=sw_pot, moisture=moisture, reco=reco.astype(np.float32))


def two_output_columns(n, seed=7):
    """RbQ10 rows with a second target, nee, and 15% of each target NaN."""
    cols = et.rbq10_columns(n, seed=seed)
    rng = np.random.default_rng(0)
    cols["nee"] = (cols["reco"] - 5.0 * (1.0 - np.exp(-0.1 * cols["ta"]))).astype(np.float32)
    for k in ("reco", "nee"):
        cols[k] = cols[k].copy()
        cols[k][rng.random(n) < 0.15] = np.nan
    return cols


# --------------------------------------------------------------------------
# the tracer, operation by operation
# --------------------------------------------------------------------------

OPS = {
    "add": lambda *, a, b: {"y": a + b + 0.25},
    "sub": lambda *, a, b: {"y": a - b - 1.5},
    "mul": lambda *, a, b: {"y": a * b * 3.0},
    "div": lambda *, a, b: {"y": a / b / 7.0},
    "neg": lambda *, a, b: {"y": -a * b},
    "pow": lambda *, a, b: {"y": a ** b},
    "pow_constant_exponent": lambda *, a, b: {"y": a ** 2 + b ** 3 + a ** 0.5 + b ** 1.7 + a ** -1},
    "pow_constant_base": lambda *, a, b: {"y": np.e ** (a * b) + 2.0 ** b},
    "exp": lambda *, a, b: {"y": torch.exp(a * b)},
    "log": lambda *, a, b: {"y": torch.log(a) * b},
    "sqrt": lambda *, a, b: {"y": torch.sqrt(a) + b},
    "sigmoid": lambda *, a, b: {"y": torch.sigmoid(a - b)},
    "tanh": lambda *, a, b: {"y": torch.tanh(a * b)},
    "abs": lambda *, a, b: {"y": torch.abs(a - b) * a},
    "minimum": lambda *, a, b: {"y": torch.minimum(a, b) * a},
    "maximum": lambda *, a, b: {"y": torch.maximum(a, b) * b},
    "clamp": lambda *, a, b: {"y": torch.clamp(a, min=0.8, max=1.6) * b},
    "clamp_traced_bound": lambda *, a, b: {"y": torch.clamp(a, min=b) + torch.clamp(a, max=b)},
    "clamp_traced_bounds": lambda *, a, b: {"y": torch.clamp(a, b - 0.25, b + 0.25)},
    "where": lambda *, a, b: {"y": torch.where(a > b, a * b, b - a)},
    "constants": lambda *, a, b: {"y": 0.1 * (a - 15.0) * b, "z": 2.5},
}


def probe(n=257, seed=0):
    """Two arguments in (0.5, 2.5), equal in their first 16 rows (ties), with
    rows on the clamp's bounds."""
    g = torch.Generator().manual_seed(seed)
    a, b = 0.5 + 2.0 * torch.rand(n, generator=g), 0.5 + 2.0 * torch.rand(n, generator=g)
    b[:16] = a[:16]
    a[16], a[17] = 0.8, 1.6
    a[18], a[19] = b[18] - 0.25, b[19] + 0.25
    return a, b


def assert_partials_match_jvp(form, args, rtol=1e-4, atol=1e-6):
    parts = form.partials_fn(*args)
    n = args[0].numel()
    for i in range(len(form.args)):
        tangents = tuple(torch.ones_like(a) if j == i else torch.zeros_like(a)
                         for j, a in enumerate(args))
        _, want = torch.func.jvp(form.torch_fn, tuple(args), tangents)
        for o in range(form.n_outputs):
            torch.testing.assert_close(parts[o][i].expand(n), want[o], rtol=rtol, atol=atol,
                                       equal_nan=True, msg=f"d output {o} / d {form.args[i]}")


@pytest.mark.parametrize("op", list(OPS))
def test_each_operation_traces_to_the_function_and_its_jvp(op):
    fn = OPS[op]
    form = kf.traced_form(fn, ("a", "b"))
    assert isinstance(form, kf.KernelForm), form
    a, b = probe()
    want = fn(a=a, b=b)
    got = form.torch_fn(*(dict(a=a, b=b)[name] for name in form.args))
    assert form.n_outputs == len(want)
    for (key, w), g in zip(want.items(), got):
        w = torch.as_tensor(w, dtype=torch.float32).expand(g.shape)
        assert torch.equal(w.view(torch.int32), g.view(torch.int32)), key  # equal bits
    assert_partials_match_jvp(form, [dict(a=a, b=b)[name] for name in form.args])


def test_nan_inputs_propagate_as_the_references_give_them():
    """A NaN argument: the function's NaN rows; partials as torch.func.jvp
    gives them on the rows without NaN, and as jax.jvp gives them on every
    row. On a NaN row torch's jvp also carries NaN through the zero tangents
    of the other arguments (0 * NaN), where JAX's symbolic zeros, and the
    traced partials, carry none."""
    cases = [(rbq10, ("ta", "rb", "Q10")), (expo_model, ("ta", "rb", "k")),
             (lambda *, a, b: {"y": a ** 2 * b + np.e ** (0.1 * b)}, ("a", "b"))]
    for fn, names in cases:
        form = kf.traced_form(fn, names)
        g = torch.Generator().manual_seed(1)
        args = [0.5 + 2.0 * torch.rand(64, generator=g) for _ in form.args]
        args[0][::5] = math.nan
        want = fn(**dict(zip(form.args, args)))
        for w, got in zip(want.values(), form.torch_fn(*args)):
            torch.testing.assert_close(got, w, equal_nan=True, rtol=0, atol=0)
        finite = [a[1::5] for a in args]
        assert_partials_match_jvp(form, finite)
        parts = form.partials_fn(*args)
        jargs = [jnp.asarray(a.numpy()) for a in args]
        for i, name in enumerate(form.args):
            def one(v, i=i):
                kw = dict(zip(form.args, jargs))
                kw[form.args[i]] = v
                return tuple(fn(**kw).values())

            _, jt = jax.jvp(one, (jargs[i],), (jnp.ones_like(jargs[i]),))
            for o in range(form.n_outputs):
                np.testing.assert_allclose(parts[o][i].expand(64).numpy(), np.asarray(jt[o]),
                                           rtol=1e-4, atol=1e-6, err_msg=f"d{o}/d{name}")


def test_ties_follow_torch_and_the_divergences_from_jax_are_pinned():
    """At a tie of maximum both references give half of each tangent; at a
    clamp bound torch passes the tangent where jnp.clip (a maximum and a
    minimum) gives half; at abs(0) torch gives 0 where JAX gives 1. The
    traced partials follow torch, which the gate and the torch epoch use
    (ROADMAP queue C, known divergences)."""
    def partial(fn, x, y=None):
        form = kf.traced_form(fn, ("a", "b"))
        args = [torch.tensor([x]), torch.tensor([x if y is None else y])]
        return [float(form.partials_fn(*args)[0][i].reshape(-1)[0]) for i in range(2)]

    def jax_partial(fn, x, y):
        return [float(jax.jvp(lambda a, b: fn(a, b), (jnp.float32(x), jnp.float32(y)), t)[1])
                for t in ((jnp.float32(1.0), jnp.float32(0.0)), (jnp.float32(0.0), jnp.float32(1.0)))]

    assert partial(lambda *, a, b: {"y": torch.maximum(a, b)}, 1.25) == [0.5, 0.5]
    assert jax_partial(jnp.maximum, 1.25, 1.25) == [0.5, 0.5]
    assert partial(lambda *, a, b: {"y": torch.minimum(a, b)}, 1.25) == [0.5, 0.5]
    assert jax_partial(jnp.minimum, 1.25, 1.25) == [0.5, 0.5]
    clamp = partial(lambda *, a, b: {"y": torch.clamp(a, min=1.0, max=2.0) * b}, 1.0)
    assert clamp[0] == 1.0  # torch: the tangent passes at the bound
    assert jax_partial(lambda a, b: jnp.clip(a, 1.0, 2.0) * b, 1.0, 1.0)[0] == 0.5
    assert partial(lambda *, a, b: {"y": torch.abs(a - b)}, 1.0) == [0.0, 0.0]
    assert jax_partial(lambda a, b: jnp.abs(a - b), 1.0, 1.0) == [1.0, -1.0]
    where = partial(lambda *, a, b: {"y": torch.where(a > b, a, 2.0 * b)}, 1.0)
    assert where == [0.0, 2.0] == jax_partial(lambda a, b: jnp.where(a > b, a, 2.0 * b), 1.0, 1.0)


def test_pow_with_a_base_at_or_below_zero_gives_torch_func_jvp():
    """``a ** b`` with both traced: at a base <= 0 (and integer exponents,
    where the value is finite) the partials are torch.func.jvp's, NaN where
    the other operand's factor is not finite."""
    form = kf.traced_form(OPS["pow"], ("a", "b"))
    a = torch.tensor([0.0, 0.0, 0.0, 0.0, -2.0, -2.0, -1.5, 2.0])
    b = torch.tensor([2.0, 0.5, 0.0, -1.0, 2.0, 3.0, 0.5, 0.0])
    assert_partials_match_jvp(form, [a, b], rtol=0, atol=0)
    sq = kf.traced_form(lambda *, a, b: {"y": a ** 2 * b}, ("a", "b"))
    x = torch.linspace(-3.0, 3.0, 61)
    torch.testing.assert_close(sq.torch_fn(x, x)[0], torch.pow(x, 2) * x, rtol=0, atol=0)
    assert_partials_match_jvp(sq, [x, x])


def test_unused_arguments_are_dropped_and_partials_structurally_zero():
    form = kf.traced_form(lambda *, ta, rb, Q10, extra: {"reco": rb * 2.0, "q": Q10 + ta},
                          ("ta", "rb", "Q10", "extra"))
    assert form.args == ("ta", "rb", "Q10")
    assert "pd[0][0]" not in form.header and "pd[0][2]" not in form.header
    assert "pd[0][1]" in form.header and "pd[1][0]" in form.header


def _branching(*, a, b):
    if a > b:
        return {"y": a}
    return {"y": b}


def _kw_only(**kw):
    return {"y": kw["a"]}


def _nine_args(*, a0, a1, a2, a3, a4, a5, a6, a7, a8):
    return {"y": a0 + a1 + a2 + a3 + a4 + a5 + a6 + a7 + a8}


def _nine_outputs(*, a, b):
    return {f"y{i}": a * float(i) + b for i in range(9)}


REFUSALS = [
    (_branching, ("a", "b"), "control flow on a traced value"),
    (lambda *, a, b: {"y": torch.sin(a) * b}, ("a", "b"), "operation torch.sin is outside"),
    (lambda *, a, b: {"y": math.exp(a) * b}, ("a", "b"), "operation math.exp is outside"),
    (lambda *, a, b: {"y": torch.nn.functional.relu(a) * b}, ("a", "b"),
     "operation torch.nn.functional.relu is outside"),
    (_kw_only, ("a", "b"), "takes only **kwargs"),
    (_nine_args, tuple(f"a{i}" for i in range(9)), "9 arguments exceed the kernels' cap of 8"),
    (_nine_outputs, ("a", "b"), "9 outputs exceed the kernels' cap of 8"),
    (lambda *, a, b: {"y": (a > b) * a}, ("a", "b"), "comparison"),
    (lambda *, a, b: {"y": torch.tensor(2.0) * a + b}, ("a", "b"), "tensor constants"),
    (lambda *, a, b: {"y": a + b}, ("a",), "argument 'b' is neither"),
]


@pytest.mark.parametrize("fn,names,cause", REFUSALS, ids=[c for _, _, c in REFUSALS])
def test_each_refusal_names_its_cause(fn, names, cause):
    reason = kf.traced_form(fn, names)
    assert isinstance(reason, str) and "has no kernel form" in reason and cause in reason, reason


def test_the_header_is_a_pure_function_of_the_graph():
    """Two traces of equal functions give the same text and hash; the
    constants are written as float32 bits, not decimal text."""
    def twin(*, ta, rb, Q10, tref=15.0):
        return {"reco": rb * Q10 ** (0.1 * (ta - tref))}

    names = ("ta", "rb", "Q10")
    first, second = kf.traced_form(rbq10, names), kf.traced_form(twin, names)
    assert first is kf.traced_form(rbq10, names)  # cached per function
    assert first is not second and first.header == second.header
    assert first.header_hash == second.header_hash
    assert kf._trace(rbq10, names).header == first.header
    assert kf.traced_form(expo_model, ("ta", "rb", "k")).header_hash != first.header_hash
    assert "__int_as_float((int)0x3dcccccdu)" in first.header  # 0.1f
    assert "__int_as_float((int)0x41700000u)" in first.header  # 15.0f
    assert not re.search(r"\b(0\.1|15\.0)", first.header)


HOST_STUB = r"""
#include <math.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
#define EH_MAX_ARGS 8
#define EH_MAX_OUT 8
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
#include "form.cuh"
extern "C" void run(const float* av_in, float* out_o, float* pd_o, float* out2_o) {
  float av[EH_MAX_ARGS];
  for (int i = 0; i < EH_MAX_ARGS; ++i) av[i] = av_in[i];
  float out[EH_MAX_OUT] = {0}, out2[EH_MAX_OUT] = {0}, pd[EH_MAX_OUT][EH_MAX_ARGS] = {{0}};
  eh_traced_form(av, out, pd);
  eh_traced_form_out(av, out2);
  for (int o = 0; o < EH_MAX_OUT; ++o) {
    out_o[o] = out[o];
    out2_o[o] = out2[o];
    for (int i = 0; i < EH_MAX_ARGS; ++i) pd_o[o * EH_MAX_ARGS + i] = pd[o][i];
  }
}
"""


@pytest.mark.parametrize("fn,names", [
    (rbq10, ("ta", "rb", "Q10")), (two_outputs, ("ta", "rb", "gpp_max", "Q10")),
    (expo_model, ("ta", "rb", "k")), (OPS["clamp_traced_bounds"], ("a", "b")),
    (OPS["where"], ("a", "b")), (OPS["pow_constant_exponent"], ("a", "b")),
])
def test_the_emitted_code_computes_the_plain_version(tmp_path, fn, names):
    """The header compiled on the host (g++, its CUDA spellings stubbed)
    gives the plain version's outputs and partials, row by row: the emitter
    and the torch evaluation read one program."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to compile the emitted header with")
    form = kf.traced_form(fn, names)
    (tmp_path / "form.cuh").write_text(form.header)
    (tmp_path / "run.cpp").write_text(HOST_STUB)
    lib_path = tmp_path / "librun.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(lib_path),
                    str(tmp_path / "run.cpp"), "-lm"], check=True, cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    a, b = probe(40)
    args = [(a, b, a + b, b * 0.5)[i] for i in range(len(form.args))]
    if fn is rbq10:
        args = [10.0 + 10.0 * a, 2.0 * a, 1.0 + b]
    outs = [o.expand(40) for o in form.torch_fn(*args)]
    parts = form.partials_fn(*args)
    fl = ctypes.c_float * 64
    for r in range(40):
        av = (ctypes.c_float * 8)(*[float(x[r]) for x in args])
        out, pd, out2 = (ctypes.c_float * 8)(), fl(), (ctypes.c_float * 8)()
        lib.run(av, out, pd, out2)
        for o in range(form.n_outputs):
            np.testing.assert_allclose([out[o], out2[o]], float(outs[o][r]), rtol=1e-5, atol=1e-6)
            for i in range(len(form.args)):
                np.testing.assert_allclose(pd[o * 8 + i], float(parts[o][i].expand(40)[r]),
                                           rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the build: a library per source and form, and no fallback
# --------------------------------------------------------------------------

FAKE_NVCC = """#!/bin/sh
# records its arguments and writes the -o file, or fails when told to
echo "$@" >> "{log}"
[ -n "{fail}" ] && {{ echo "nvcc: refused"; exit 3; }}
sleep 0.2
while [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done
"""


def _fake_nvcc(monkeypatch, tmp_path, fail=False):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=tmp_path / "nvcc.log", fail="1" if fail else ""))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    return tmp_path / "nvcc.log"


def test_a_form_builds_each_source_once_against_its_header(monkeypatch, tmp_path):
    """form_build writes the header under _build/forms/ named by its hash,
    compiles each source against it (several at once from threads), keys the
    library on the form, and reuses a build that exists."""
    log = _fake_nvcc(monkeypatch, tmp_path)
    form = kf.traced_form(expo_model, ("ta", "rb", "k"))
    other = kf.traced_form(rbq10, ("ta", "rb", "Q10"))
    sources = ("fused_forward.cu", "fused_epoch.cu", "fused_wide.cu")
    results = {}

    def build(src):
        results[src] = _build.form_build(src, form)

    threads = [threading.Thread(target=build, args=(s,)) for s in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and set(results) == set(sources)
    header = tmp_path / "build" / "forms" / f"eh_form_{form.header_hash}.cuh"
    assert header.read_text() == form.header
    lines = log.read_text().splitlines()
    assert len(lines) == 3
    assert all(f'-DEH_TRACED_FORM_HEADER="{header.name}"' in line for line in lines)
    assert all(f"-I{header.parent}" in line for line in lines)
    assert len({r.path for r in results.values()}) == 3
    again = _build.form_build("fused_epoch.cu", form)
    assert again.path == results["fused_epoch.cu"].path and again.seconds == 0.0
    assert _build.form_build("fused_epoch.cu", other).path != again.path
    assert len(log.read_text().splitlines()) == 4
    assert _build.nvcc_seconds() > 0.0


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """nvcc refuses the form's build: the launcher raises, and neither the
    package's library nor the torch engine is tried."""
    log = _fake_nvcc(monkeypatch, tmp_path, fail=True)
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail("fell back to the library"))
    tm = et.construct_hybrid_model(**EXPO_SPEC, mechanistic_model=expo_model, device="cpu")
    fwd = et.make_fused_forward(tm)
    assert fwd.plan.form.header is not None
    x = torch.zeros((4, 2))
    outputs = {k: torch.empty(4) for k in ("reco", "rb", "k")}
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ff.launch_fused_forward(fwd.plan, x, {"ta": torch.zeros(4)}, outputs)
    for src in ("fused_epoch.cu", "fused_wide.cu", "fused_epoch_lstm.cu", "fused_multisite.cu"):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.kernel_library(src, fwd.plan.form)
    assert len(log.read_text().splitlines()) == 5
    assert not any((tmp_path / "build").glob("*.so"))


# --------------------------------------------------------------------------
# the envelopes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec,fn", [(RBQ10_SPEC, rbq10), (TWO_SPEC, two_outputs),
                                     (EXPO_SPEC, expo_model)],
                         ids=["examples_rbq10", "two_outputs", "expo"])
def test_the_repository_models_are_inside_both_envelopes(spec, fn):
    tm = et.construct_hybrid_model(**spec, mechanistic_model=fn, device="cpu")
    assert ff.fused_forward_unsupported_reason(tm) is None
    assert fe.fused_epoch_unsupported_reason(tm, ("rmsprop", 0.001), LL) is None
    plan = ff.plan_fused_forward(tm)
    assert plan.form.form_id == kf.FORM_TRACED and plan.output_names == tuple(fn(
        **{a: torch.ones(1) for a in plan.form.args}))


def test_control_flow_gives_an_engine_reason_that_says_so():
    def branching(*, ta, rb, Q10, tref=15.0):
        if (ta > 100.0).any():  # control flow on a value: the tracer refuses it
            return {"reco": rb}
        return {"reco": rb * Q10 ** (0.1 * (ta - tref))}

    tm = et.construct_hybrid_model(**RBQ10_SPEC, mechanistic_model=branching, device="cpu")
    r = et.train(tm, et.rbq10_columns(200, seed=1), nepochs=1, batchsize=64, show_progress=False,
                 use_kernel=True)
    assert r.epoch_path == "torch"
    assert "has no kernel form: control flow on a traced value" in r.engine_reason


# --------------------------------------------------------------------------
# the plain version of each kernel with a traced form against the JAX kernel
# --------------------------------------------------------------------------

def _pair(spec, jax_fn, torch_fn, cols, *, seed=0):
    """The same SingleNN model in both packages from the JAX parameters, the
    static norm fitted; the port's prepared data."""
    jm = eh.construct_hybrid_model(**spec, mechanistic_model=jax_fn)
    tm = et.construct_hybrid_model(**spec, mechanistic_model=torch_fn, device="cpu")
    data = et.prepare_data(tm, cols)
    params, state = jm.init(jax.random.PRNGKey(seed))
    state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jm, params, state, tm, data


@pytest.mark.parametrize("case", ["two_outputs", "expo"])
def test_kernel_1_plain_version_matches_the_jax_pallas_forward(case):
    spec, jfn, tfn, cols = {
        "two_outputs": (TWO_SPEC, two_outputs_jnp, two_outputs, two_output_columns(300)),
        "expo": (EXPO_SPEC, expo_model, expo_model, expo_columns(300, seed=3)),
    }[case]
    jm, params, state, tm, data = _pair(spec, jfn, tfn, cols)
    x = np.asarray(data.x)
    forcing = {k: np.asarray(v) for k, v in data.forcing.items()}
    n = x.shape[0]  # rows whose targets are all NaN are dropped
    pad = -(-n // 128) * 128 - n
    jfwd = jax_make_fused_forward(jm, params, state, batch_size=128, interpret=True)
    want = jfwd(jnp.asarray(np.pad(x, ((0, pad), (0, 0)))),
                {k: jnp.asarray(np.pad(v, (0, pad))) for k, v in forcing.items()})
    got = et.make_fused_forward(tm, batch_size=128).table(x, forcing)
    for k in spec["targets"]:
        w = np.asarray(want[k])[:n]
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["two_outputs_nan_mean", "expo_three_epochs", "examples_rbq10"])
def test_kernel_2_plain_version_matches_the_jax_fused_epoch(case):
    """atol 2e-6 after one epoch and 1e-5 after three (tests/test_fused.py's)."""
    spec, jfn, tfn, cols, opt, shuffle, epochs, agg = {
        "two_outputs_nan_mean": (TWO_SPEC, two_outputs_jnp, two_outputs,
                                 two_output_columns(512), ("adam", 0.01), False, 1, "mean"),
        "expo_three_epochs": (EXPO_SPEC, expo_model, expo_model, expo_columns(512, seed=4),
                              ("adam", 0.01), True, 3, "sum"),
        "examples_rbq10": (RBQ10_SPEC, rbq10, rbq10, et.rbq10_columns(512, seed=42),
                           ("rmsprop", 0.01), True, 1, "sum"),
    }[case]
    jm, params, state, tm, data = _pair(spec, jfn, tfn, cols)
    jt = jax.device_put(jax_epoch_tensors(eh.prepare_data(jm, ((data.x, data.forcing), data.y)),
                                          128))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, 128), "cpu")
    key = jax.random.PRNGKey(5)
    jll = eh.LoggingLoss(training_loss="mse", loss_types=("mse",), agg=agg)
    jfn_epoch = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn_epoch(jax.tree.map(jnp.array, params), jax_init_opt(params, opt),
                                   state, jt, key)
    tll = et.LoggingLoss(training_loss="mse", loss_types=("mse",), agg=agg)
    fn = et.make_fused_epoch(tm, opt, tll, shuffle=shuffle, epochs_per_call=epochs)
    assert fn.plan.form.form_id == kf.FORM_TRACED
    nb, batch = tt.weight.shape
    _, os_, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                      perms=jax_perms(shuffle, key, epochs, nb, batch))
    assert_model_matches(tm, jp, js, 2e-6 if epochs == 1 else 1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(jos["t"][0])


def test_kernel_3_plain_version_matches_the_jax_chunked_kernel(monkeypatch):
    """The exponential model on the wide kernel's plain version against the
    JAX kernel with each batch of 256 in two chunks (as
    tests/test_torch_fused_wide.py runs it): atol 1e-5 after two epochs."""
    spec = {**EXPO_SPEC, "hidden_layers": [32, 16], "activation": "tanh"}
    jm, params, state, tm, data = _pair(spec, expo_model, expo_model, expo_columns(768, seed=5))
    jt = jax.device_put(jax_epoch_tensors(eh.prepare_data(jm, ((data.x, data.forcing), data.y)),
                                          256))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, 256), "cpu")
    monkeypatch.setenv("EASYHYBRID_FUSED_MAX_VMEM_MB", "0.45")
    monkeypatch.setenv("EASYHYBRID_FUSED_CHUNKED", "1")
    assert _pick_batch_chunks(jm, [jm.nn], jt, JLL) == 2
    key, opt = jax.random.PRNGKey(5), ("adam", 0.01)
    jfn = jax_fused_epoch(jm, state, opt, JLL, shuffle=True, epochs_per_call=2)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                            key)
    fn = et.make_fused_wide_epoch(tm, opt, LL, shuffle=True, epochs_per_call=2)
    nb, batch = tt.weight.shape
    _, os_, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                      perms=jax_perms(True, key, 2, nb, batch))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert int(os_["t"][0]) == int(np.asarray(jos["t"])[0])


def test_kernel_4_plain_version_matches_the_jax_lstm_kernel():
    """examples/lstm_sequences.py's own rbq10 (untagged) through the LSTM
    kernel's plain version: atol 5e-5, rtol 5e-4 after three epochs (as
    tests/test_torch_fused_lstm.py)."""
    jm, params, state, jt, tm, tt = lstm_setup("static", mechanistic_model=rbq10)
    key, opt = jax.random.PRNGKey(5), ("adam", 0.01)
    jfn = jax_fused_epoch(jm, state, opt, JLL, shuffle=False, epochs_per_call=3)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state, jt,
                            key)
    fn = et.make_fused_lstm_epoch(tm, opt, LL, shuffle=False, epochs_per_call=3)
    assert fn.plan.form.form_id == kf.FORM_TRACED
    _, os_, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt)
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert int(os_["t"][0]) == int(jos["t"][0])


def test_kernel_5_plain_version_matches_the_jax_multisite_kernel():
    """The exponential model with k a per-site global through the multi-site
    kernel's plain version: atol 5e-5 / rtol 5e-4 on the parameters and rtol
    2e-4 on the loss after three epochs (as tests/test_torch_fused_multisite.py)."""
    S, N = 120, 8
    spec = dict(predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
                parameters=EXPO_PARAMS, neural_param_names=["rb"], global_param_names=["k"],
                hidden_layers=[8, 8], activation="swish", scale_nn_outputs=True,
                input_batchnorm=False)
    jm = eh.MultiSiteHybridModel(eh.construct_hybrid_model(mechanistic_model=expo_model, **spec),
                                 n_sites=S, share_nn=True)
    params, state = jm.init(jax.random.PRNGKey(3))
    tm = et.MultiSiteHybridModel(
        et.construct_hybrid_model(mechanistic_model=expo_model, device="cpu", **spec), S,
        device="cpu")
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    data = et.gen_multisite_arrays(S, N, seed=0, nan_frac=0.1)
    data.y["reco"] = (data.y["reco"] * 0.5).astype(np.float32)
    jdata = JaxHybridData(x=data.x, forcing=dict(data.forcing), y=dict(data.y))
    jt = jax.tree.map(jnp.asarray, jax_epoch_tensors(jdata, S))
    tt = tepoch.epoch_tensors_to(et.build_epoch_tensors(data, S), "cpu")
    opt = ("adam", 0.01)
    jfn = jax_fused_multisite(jm, state, opt, JLL, shuffle=False, epochs_per_call=3,
                              interpret=True)
    jp, jos, _, jloss = jfn(jax.tree.map(jnp.copy, params), jax_init_opt(params, opt), state, jt,
                            jax.random.PRNGKey(7))
    fn = et.make_fused_multisite_epoch(tm, opt, LL, shuffle=False, epochs_per_call=3)
    assert fn.plan.form.form_id == kf.FORM_TRACED
    _, os_, loss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt)
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b).reshape(np.shape(a)), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-4)


def test_the_caps_and_form_ids_match_the_cuda_header():
    from pathlib import Path

    header = (Path(kf.__file__).resolve().parent.parent / "csrc" / "eh_device.cuh").read_text()
    defines = dict(re.findall(r"#define (EH_MAX_\w+) (\d+)", header))
    assert int(defines["EH_MAX_ARGS"]) == kf.MAX_ARGS
    assert int(defines["EH_MAX_OUT"]) == kf.MAX_OUTPUTS
    assert "enum { FORM_RBQ10 = 0, FORM_TRACED };" in header
    assert (kf.FORM_RBQ10, kf.FORM_TRACED) == (0, 1)
    assert "#include EH_TRACED_FORM_HEADER" in header and "case FORM_TRACED:" in header
