#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (easyhybrid_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles csrc/*.cu with nvcc for sm_90a (set-up time);
3. kernel: the fused forward kernel against its plain PyTorch version on
   the card, at the serving path's shapes and at the kernel's edges;
4. main path: the quick-start RbQ10 model (MLP [16, 16], swish, static
   input norm) at 131,072 rows through ``predict(..., batch_size=1024)``,
   which must take the kernel (128 launches) and agree with the plain
   module forward;
5. times: kernel against plain version, and end-to-end ``predict`` rows/s
   on both engines, each the median of several runs.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

# max |got - ref| <= TOL * max(1, |ref|) on every output, float32: the kernel
# uses CUDA's expf / powf / tanhf / rsqrtf and sums each layer in its own
# order, against torch's transcendentals and GEMM, a few ulp apart per step
TOL = 1e-5
N_ROWS = 131_072
BATCH = 1024
RBQ10_PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rbq10_untagged(*, ta, rb, Q10, tref=15.0):
    """The quick-start model without a kernel form: runs the plain engine."""
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def build_model(et, *, hidden=(16, 16), activation="swish", norm="static",
                mechanistic=None, seed=0, **overrides):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=mechanistic or et.rbq10, parameters=RBQ10_PARAMS,
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=list(hidden), activation=activation,
        scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(overrides)
    return et.construct_hybrid_model(
        **spec, generator=torch.Generator().manual_seed(seed)
    )


def to_device(et, model, cols):
    """Fit the static norm on the complete rows, move the model to the card
    and return the model's inputs (NaN rows kept) as CUDA tensors."""
    et.fit_input_norm(model, et.prepare_data(model, cols))
    model.to("cuda")
    data = et.prepare_data(model, cols, drop_missing_rows=False)
    x = torch.from_numpy(data.x).cuda()
    forcing = {k: torch.from_numpy(v).cuda() for k, v in data.forcing.items()}
    return x, forcing


def compare(got, ref, what: str) -> float:
    """Check ``got`` against ``ref`` (same keys, same NaN rows, within TOL);
    return the largest absolute difference."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(ref)}")
    worst = 0.0
    for k in ref:
        g, r = got[k].float(), ref[k].float()
        if g.shape != r.shape:
            raise AssertionError(f"{what}: {k} shape {tuple(g.shape)} != {tuple(r.shape)}")
        if not torch.equal(torch.isnan(g), torch.isnan(r)):
            raise AssertionError(f"{what}: {k} NaN rows differ")
        fin = ~torch.isnan(r)
        if not torch.isfinite(r[fin]).all():
            raise AssertionError(f"{what}: {k} has infinite values")
        diff = (g[fin] - r[fin]).abs()
        bound = TOL * r[fin].abs().clamp_min(1.0)
        if diff.numel() and bool((diff > bound).any()):
            i = int(torch.argmax(diff / bound))
            raise AssertionError(
                f"{what}: {k} differs by {float(diff[i]):.3e} at |ref| "
                f"{float(r[fin][i].abs()):.3e} (tolerance {TOL} x max(1, |ref|))"
            )
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: the calls are enqueued behind
    a sleep kernel, so the CUDA events bracket back-to-back device work and
    not the host's enqueue time. The sleep is lengthened until the host has
    enqueued every call before it ends."""
    cycles = 20_000_000
    for _ in range(8):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the sleep was still running
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("could not enqueue the timed calls ahead of the device")


def host_ms(fn, reps: int) -> float:
    """Wall milliseconds per call of ``fn``, enqueue and device work both."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> None:
    # 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
                  f"torch {torch.__version__} CUDA {torch.version.cuda} | "
                  f"count {torch.cuda.device_count()}")

    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops import fused_forward as ff

    # 2. build ----------------------------------------------------------------
    built = _build.build_library()
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS[:2])} -> {built.path.name} "
                 f"in {built.seconds:.2f} s (set-up)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())
    _build.load_library()

    # 3. kernel against the plain version --------------------------------------
    cases = []
    cols = et.rbq10_columns(N_ROWS, seed=42)
    quick = build_model(et)
    x, forcing = to_device(et, quick, cols)
    cases.append(("quick-start [16,16] swish static N=131072 batch 1024", quick, x, forcing, BATCH))

    small = et.rbq10_columns(1000, seed=1)
    m = build_model(et, hidden=(8,), activation="tanh", norm=False, seed=1)
    cases.append(("[8] tanh no norm N=1000", m, *to_device(et, m, small), BATCH))

    odd = et.rbq10_columns(777, seed=2)
    for i, act in enumerate(sorted(et.ACTIVATIONS)):
        m = build_model(et, hidden=(12, 5), activation=act, seed=10 + i)
        cases.append((f"[12,5] {act} static N=777 batch 256", m, *to_device(et, m, odd), 256))
    for hidden in ((24, 32), (64, 48)):
        m = build_model(et, hidden=hidden, activation="selu", seed=3)
        cases.append((f"{list(hidden)} selu static N=777", m, *to_device(et, m, odd), BATCH))

    m = build_model(
        et, hidden=(16, 16), seed=4,
        parameters={**RBQ10_PARAMS, "tref": (15.0, 0.0, 30.0)},
        neural_param_names=["Q10"], global_param_names=["rb"],
    )
    cases.append(("neural Q10, global rb, fixed tref N=777", m, *to_device(et, m, odd), BATCH))

    nan_cols = et.rbq10_columns(4096, seed=5)
    nan_cols["sw_pot"][np.random.default_rng(5).random(4096) < 0.05] = np.nan
    m = build_model(et, seed=5)
    cases.append(("quick-start with 5% NaN predictor rows N=4096", m, *to_device(et, m, nan_cols), BATCH))

    kernel_err = 0.0
    for what, model, cx, cf, batch in cases:
        fn = et.make_fused_forward(model, batch_size=batch)
        got = fn(cx, cf)
        torch.cuda.synchronize()
        err = compare(got, fn.reference(cx, cf), what)
        kernel_err = max(kernel_err, err)
        log("kernel", f"{what}: width {fn.plan.width}, max |diff| {err:.3e} (ok)")

    # 4. main path --------------------------------------------------------------
    fn = et.make_inference_fn(quick, batch_size=BATCH)
    if fn.engine != "cuda_fused_forward":
        raise AssertionError(f"engine {fn.engine!r}: {fn.engine_reason}")
    ff.launch_fused_forward.launches = 0
    out = et.predict(quick, cols, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = ff.launch_fused_forward.launches
    expected = -(-N_ROWS // BATCH)
    if launches != expected:
        raise AssertionError(f"predict launched the kernel {launches} times, not {expected}")
    if set(out) != {"reco", "rb"}:
        raise AssertionError(f"predict returned keys {sorted(out)}")
    for k, v in out.items():
        if v.shape != (N_ROWS,) or not np.isfinite(v).all():
            raise AssertionError(f"predict output {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    quick.eval()
    with torch.no_grad():
        plain = quick(x, forcing)
    main_err = compare(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {"reco": plain["reco"].cpu(), "rb": plain["parameters"]["rb"].cpu()},
        "predict against the plain module forward",
    )
    # the mechanistic relation itself, in float64 on the host
    q10 = et.scale_param(float(quick.globals.Q10.item()), 1.0, 4.0)
    reco64 = out["rb"].astype(np.float64) * q10 ** (0.1 * (cols["ta"].astype(np.float64) - 15.0))
    rel = float(np.max(np.abs(out["reco"] - reco64) / np.maximum(1.0, np.abs(reco64))))
    if rel > TOL:
        raise AssertionError(f"reco != rb * Q10^((ta - 15)/10): {rel:.3e}")
    log("main", f"predict: engine {fn.engine}, {launches} launches, keys {sorted(out)}, "
                f"max |diff| vs plain forward {main_err:.3e}, relation err {rel:.3e} (ok)")

    # 5. times --------------------------------------------------------------------
    one = et.make_fused_forward(quick, batch_size=N_ROWS)
    chunked = et.make_fused_forward(quick, batch_size=BATCH)
    fns = {"plain": lambda: one.reference(x, forcing), "kernel": lambda: one(x, forcing),
           f"kernel x{expected}": lambda: chunked(x, forcing)}
    reps = {"plain": 20, "kernel": 20, f"kernel x{expected}": 2}
    dev = {k: [] for k in fns}
    wall = {k: [] for k in fns}
    for k, f in fns.items():
        host_ms(f, 3)  # warm-up
    for i in range(6):
        for k in (list(fns) if i % 2 == 0 else list(reversed(list(fns)))):
            dev[k].append(device_ms(fns[k], reps[k]))
            wall[k].append(host_ms(fns[k], reps[k]))
    ms = {k: statistics.median(v) for k, v in dev.items()}
    wall_ms = {k: statistics.median(v) for k, v in wall.items()}
    log("times", f"[{card}] {N_ROWS} device-resident rows, median of 6 runs, ms per call: "
                 + ", ".join(f"{k} device {ms[k]:.4f} / wall {wall_ms[k]:.4f}" for k in fns)
                 + f" (kernel x{expected}: {expected} launches of {BATCH} rows)")

    plain_model = build_model(et, mechanistic=rbq10_untagged)
    plain_model.load_state_dict(quick.state_dict())
    plain_model.to("cuda")
    engines = {
        "cuda_fused_forward b1024": et.make_inference_fn(quick, batch_size=BATCH),
        "torch b1024": et.make_inference_fn(plain_model, batch_size=BATCH),
        "cuda_fused_forward b131072": et.make_inference_fn(quick, batch_size=N_ROWS),
    }
    if engines["torch b1024"].engine != "torch":
        raise AssertionError("the untagged model should run the plain engine")
    walls = {k: [] for k in engines}
    for f in engines.values():
        f(cols)  # warm-up
    for i in range(6):
        for k in (list(engines) if i % 2 == 0 else list(reversed(list(engines)))):
            walls[k].append(host_ms(lambda: engines[k](cols), 1))
    rates = {k: N_ROWS / statistics.median(v) * 1e3 for k, v in walls.items()}
    log("times", f"[{card}] end-to-end predict, {N_ROWS} rows from host columns, median of "
                 f"{len(walls['torch b1024'])}: " + ", ".join(f"{k} {r:,.0f} rows/s" for k, r in rates.items()))

    print(json.dumps({"kernels": [{
        "name": "fused_forward",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_forward.cu",
        "replaces": "easyhybrid_tpu/ops/fused_forward.py:140",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
