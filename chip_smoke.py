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
   on both engines, each the median of several runs;
6. kernel 2: the fused epoch kernel against its plain PyTorch version
   (``fused_epoch_reference``) on the card, from identical parameters and
   the same permutations, at the training path's shapes and its edges;
7. main path: ``train()`` on the quick-start RbQ10 model (trainable input
   BatchNorm) at 20,000 rows, 100 epochs of batch 512, which must take the
   kernel after its exactness gate (one launch per epoch) and learn Q10;
8. times: kernel 2 against its plain version per epoch, and ``train()``
   wall seconds on both epoch engines.

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
# kernel 2 after a short run (at most 4 epochs x 32 steps): max |got - ref|
# <= TOL_EPOCH * max(1, |ref|) on parameters, moments, BatchNorm statistics
# and loss. Each step differs by a few ulp (expf / powf / sums in another
# order), and every step starts from the last one's result, so the
# differences compound along the chain; Adam's g / sqrt(v) magnifies the
# rounding of tiny gradients
TOL_EPOCH = 1e-4
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


def compare(got, ref, what: str, tol: float = TOL) -> float:
    """Check ``got`` against ``ref`` (same keys, same NaN rows, within
    ``tol``); return the largest absolute difference."""
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
        bound = tol * r[fin].abs().clamp_min(1.0)
        if diff.numel() and bool((diff > bound).any()):
            i = int(torch.argmax(diff / bound))
            raise AssertionError(
                f"{what}: {k} differs by {float(diff[i]):.3e} at |ref| "
                f"{float(r[fin][i].abs()):.3e} (tolerance {tol} x max(1, |ref|))"
            )
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def device_ms(fn, reps: int, what: str = "") -> float:
    """Device milliseconds per call of ``fn``: the calls are enqueued behind
    a sleep kernel, so the CUDA events bracket back-to-back device work and
    not the host's enqueue time. The sleep is lengthened until the host has
    enqueued every call before it ends."""
    cycles = 20_000_000
    for _ in range(6):
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
    raise RuntimeError(f"could not enqueue the timed calls of {what!r} ahead of the device "
                       "(does a call wait for the device?)")


def profiled_device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: the sum of the durations of
    the device activities ``torch.profiler`` records over ``reps`` calls.
    For calls of thousands of small kernels, which cannot all wait behind a
    sleep kernel (the launch queue holds about a thousand: past that the
    host blocks until the device has run them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def host_ms(fn, reps: int) -> float:
    """Wall milliseconds per call of ``fn``, enqueue and device work both."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


TRAIN_ROWS = 20_000
TRAIN_KW = dict(nepochs=100, batchsize=512, optimizer=("adam", 0.01), show_progress=False)


def epoch_cases(et, quick_cols):
    """Kernel 2's cases: the main path's shapes first, then its edges."""
    odd = et.rbq10_columns(777, seed=2)
    masked = et.rbq10_columns(1024, seed=6)
    masked["reco"][:128] = np.nan  # the whole first (unshuffled) batch
    quick = dict(hidden=(16, 16), act="swish", norm=True, opt=("adam", 0.01))
    return [
        dict(what="quick-start [16,16] swish, trainable BN, 16,000 rows, batch 512, adam, "
                  "shuffled, 4 epochs", cols=quick_cols, split=True, shuffle=True, epochs=4,
             batch=512, seed=0, **quick),
        dict(what="[8] tanh, static norm, sgd, unshuffled, N=1000 batch 128 (ragged)",
             cols=et.rbq10_columns(1000, seed=1), hidden=(8,), act="tanh", norm="static",
             opt=("sgd", 0.05), shuffle=False, epochs=2, batch=128, seed=1),
        *[dict(what=f"[12,5] {act}, static norm, adam, shuffled, N=777 batch 100", cols=odd,
               hidden=(12, 5), act=act, norm="static", opt=("adam", 0.01), shuffle=True,
               epochs=1, batch=100, seed=10 + i)
          for i, act in enumerate(sorted(et.ACTIVATIONS))],
        dict(what="[32,24] tanh, trainable BN, N=2000 batch 256", cols=et.rbq10_columns(2000, seed=3),
             hidden=(32, 24), act="tanh", norm=True, opt=("adam", 0.01), shuffle=True, epochs=1,
             batch=256, seed=3),
        dict(what="[64,48] selu, no norm, shuffle 'batches', N=2000 batch 300",
             cols=et.rbq10_columns(2000, seed=4), hidden=(64, 48), act="selu", norm=False,
             opt=("adam", 0.01), shuffle="batches", epochs=2, batch=300, seed=4),
        dict(what="quick-start, 30% NaN targets, N=4096 batch 256, 2 epochs",
             cols=et.rbq10_columns(4096, seed=5, nan_frac=0.3), keep_nan=True, shuffle=True,
             epochs=2, batch=256, seed=5, **quick),
        dict(what="quick-start, first batch fully masked, adam, unshuffled, N=1024 batch 128",
             cols=masked, keep_nan=True, shuffle=False, epochs=1, batch=128, seed=6, **quick),
    ]


def prepare_epoch_case(et, fe, *, what, cols, hidden, act, norm, opt, shuffle, epochs, batch,
                       seed, split=False, keep_nan=False):
    """The case's fused epoch, its packed parameters on the card, its epoch
    tensors and its permutations."""
    from easyhybrid_tpu_torch.data.prepare import HybridData
    from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

    model = build_model(et, hidden=hidden, activation=act, norm=norm, seed=seed)
    if keep_nan:  # NaN targets reach the batches as masked rows
        data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                          forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    elif split:
        data = et.split_data(cols, model)[0]
    else:
        data = et.prepare_data(model, cols)
    et.fit_input_norm(model, data)
    model.to("cuda")
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), "cuda")
    fn = et.make_fused_epoch(model, opt, et.LoggingLoss(), shuffle=shuffle, epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    return what, fn, fn.plan.pack(model), tensors, perms


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
                 f"in {built.seconds:.2f} s (set-up), one nvcc per source in parallel: "
                 + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(built.source_seconds.items())))
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

    # 6. kernel 2 against the plain version --------------------------------------
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    quick_cols = et.rbq10_columns(TRAIN_ROWS, seed=42)
    epoch_err = 0.0
    for case in epoch_cases(et, quick_cols):
        what, fn, packed, tensors, perms = prepare_epoch_case(et, fe, **case)
        opt0 = fe.init_fused_opt_state(packed)
        got_p, got_o, got_l = fn(packed, opt0, tensors, perms=perms)
        torch.cuda.synchronize()
        ref_p, ref_o, ref_l = fn.reference(packed, fe.init_fused_opt_state(packed), tensors, perms=perms)
        got = {"params": got_p.params, "bn": got_p.bn, "m": got_o["m"], "v": got_o["v"],
               "t": got_o["t"].float(), "loss": got_l.reshape(1)}
        ref = {"params": ref_p.params, "bn": ref_p.bn, "m": ref_o["m"], "v": ref_o["v"],
               "t": ref_o["t"].float(), "loss": ref_l.reshape(1)}
        if not all(bool(torch.isfinite(v).all()) for v in got.values()):
            raise AssertionError(f"{what}: the kernel returned non-finite values")
        err = compare(got, ref, what, TOL_EPOCH)
        epoch_err = max(epoch_err, err)
        log("kernel2", f"{what}: width {fn.plan.width}, tile {fn.plan.tile_rows} rows, "
                       f"{int(got_o['t'][0])} steps, max |diff| {err:.3e} (ok)")

    # 7. main path: train() ------------------------------------------------------
    model = build_model(et, norm=True, seed=0).to("cuda")
    gate_launches = []
    from easyhybrid_tpu_torch.training import train as train_module

    real_gate = train_module.fused_exactness_check

    def gate_then_reset(*args, **kwargs):
        """The gate's own launches are counted apart from the main path's."""
        out = real_gate(*args, **kwargs)
        gate_launches.append(fe.launch_fused_epoch.launches)
        fe.launch_fused_epoch.launches = 0
        return out

    train_module.fused_exactness_check = gate_then_reset
    fe.launch_fused_epoch.launches = 0
    t0 = time.perf_counter()
    result = et.train(model, quick_cols, **TRAIN_KW)
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - t0
    epoch_launches = fe.launch_fused_epoch.launches
    train_module.fused_exactness_check = real_gate
    if result.epoch_path != "cuda_fused_epoch" or "exactness gate passed" not in result.engine_reason:
        raise AssertionError(f"train() took {result.epoch_path!r}: {result.engine_reason}")
    expected_launches = TRAIN_KW["nepochs"] // TRAIN_KW.get("eval_every", 1)
    if epoch_launches != expected_launches:
        raise AssertionError(f"train() launched kernel 2 {epoch_launches} times, not {expected_launches}")
    q10 = float(et.scale_param(result.params["globals.Q10"], 1.0, 4.0))
    pred = result.val_pred_columns["reco_pred"]
    if not (abs(q10 - 2.0) < 0.15 and result.best_loss < 0.05):
        raise AssertionError(f"train() learned Q10 {q10:.4f}, best val mse {result.best_loss:.4f}")
    if pred.shape != (TRAIN_ROWS // 5,) or not np.isfinite(pred).all():
        raise AssertionError(f"val predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    log("main", f"train(): {result.epoch_path}, {result.engine_reason}; {epoch_launches} launches "
                f"after the gate's {gate_launches}; Q10 {q10:.4f}, best val mse "
                f"{result.best_loss:.5f} at epoch {result.best_epoch}; {fused_wall:.2f} s wall (ok)")

    # 8. times ---------------------------------------------------------------------
    what, fn, packed, tensors, perms = prepare_epoch_case(
        et, fe, **{**epoch_cases(et, quick_cols)[0], "epochs": 1})
    opt0 = fe.init_fused_opt_state(packed)
    epoch_fns = {"kernel": lambda: fn(packed, opt0, tensors, perms=perms),
                 "plain": lambda: fn.reference(packed, opt0, tensors, perms=perms)}
    for f in epoch_fns.values():
        host_ms(f, 2)  # warm-up
    # the kernel: behind a sleep kernel; the plain version (~5,000 kernels an
    # epoch) from the profiler's device activities; the kernel both ways
    epoch_dev = {"kernel": [], "kernel (profiler)": [], "plain (profiler)": []}
    epoch_wall = {"kernel": [], "plain": []}
    for i in range(6):
        epoch_dev["kernel"].append(device_ms(epoch_fns["kernel"], 20, "kernel 2"))
        epoch_dev["kernel (profiler)"].append(profiled_device_ms(epoch_fns["kernel"], 5))
        epoch_dev["plain (profiler)"].append(profiled_device_ms(epoch_fns["plain"], 1))
        for k in (list(epoch_wall) if i % 2 == 0 else list(reversed(list(epoch_wall)))):
            epoch_wall[k].append(host_ms(epoch_fns[k], 5 if k == "kernel" else 1))
    epoch_ms = {k: statistics.median(v) for k, v in epoch_dev.items()}
    epoch_ms["plain"] = epoch_ms["plain (profiler)"]
    wall_ms = {k: statistics.median(v) for k, v in epoch_wall.items()}
    steps = tensors.weight.shape[0]
    log("times", f"[{card}] kernel 2, one epoch of {steps} steps (batch {tensors.weight.shape[1]}, "
                 f"{what}), median of 6: device ms per epoch "
                 + ", ".join(f"{k} {v:.4f} ms ({steps / v * 1e3:,.0f} steps/s)"
                             for k, v in epoch_ms.items() if k != "plain")
                 + "; wall ms per epoch " + ", ".join(f"{k} {v:.3f}" for k, v in wall_ms.items()))

    torch_model = build_model(et, norm=True, seed=0).to("cuda")
    t0 = time.perf_counter()
    torch_result = et.train(torch_model, quick_cols, use_kernel=False, **TRAIN_KW)
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    if torch_result.epoch_path != "torch":
        raise AssertionError(f"use_kernel=False took {torch_result.epoch_path!r}")
    torch_q10 = float(et.scale_param(torch_result.params["globals.Q10"], 1.0, 4.0))
    log("times", f"[{card}] train() wall, {TRAIN_KW['nepochs']} epochs x {steps} steps + an "
                 f"evaluation per epoch: cuda_fused_epoch {fused_wall:.2f} s (gate included), "
                 f"torch {torch_wall:.2f} s (Q10 {torch_q10:.4f}, best val mse "
                 f"{torch_result.best_loss:.5f})")

    print(json.dumps({"kernels": [{
        "name": "fused_forward",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_forward.cu",
        "replaces": "easyhybrid_tpu/ops/fused_forward.py:140",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
    }, {
        "name": "fused_epoch",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_epoch.cu",
        "replaces": "easyhybrid_tpu/ops/fused_epoch.py:2662",
        "launches": epoch_launches,
        "max_abs_err": epoch_err,
        "ms": epoch_ms["kernel"],
        "plain_ms": epoch_ms["plain"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
