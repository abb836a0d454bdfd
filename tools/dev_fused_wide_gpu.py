"""Kernel 3 (``easyhybrid_tpu_torch/csrc/fused_wide.cu``) alone on a CUDA GPU:
a quick loop for work on that kernel.

Compiles only ``fused_wide.cu`` (seconds, where the whole library takes
minutes), prints ptxas's registers and spills and the count of tensor-core
instructions in each kernel, holds the kernel against its plain PyTorch
version on the tower [1024, 512, 256, 128, 64] and on small edge cases,
element by element and leaf by leaf, runs the no-norm mae case in float64 as
well (which of the two float32 versions is nearer the truth), and at the
main shape (16 steps of 1,024) and at batch 64 (16 steps of 64):

- every launch of a step by what it computes (each layer's forward, data and
  weight products, and the rest), device time from ``torch.profiler``, and
  each product's TFLOP/s (two flops a multiply-add of the float32 product;
  the tensor cores do three TF32 products of it);
- the same products through ``torch.matmul`` in float32 and in TF32, as a
  yardstick;
- one epoch's device time behind a sleep kernel (CUDA events) against the sum
  of its kernels' times from ``torch.profiler``: the difference is the gaps
  between launches; and the step split by kernel.

``--variants`` builds ``fused_wide.cu`` again with a part of the tensor-core
kernel cut out of a copy of the source (its products, its operand staging,
its finishing epilogue) and times each
step against the whole one, launch by launch: what each part costs in the
real step (the cut builds compute nothing right). It also builds one that
keeps the whole sum in the tensor cores' accumulators, and holds both
products over K = 1,024 against float64.

``--stamps`` builds it with ``clock64()`` stamps of block (0, 0, 0)'s thread
0 put into a copy of the tensor-core kernel (entry, the first slice staged,
the last slice's sums, the finished tile) and runs each tile shape alone on
one multiprocessor over K = 256 (8 slices): the cycles of a slice.

``--drift`` runs the tower's Adam cases of ``chip_smoke.py`` phase 16 (batch
64 for 32 steps under three seeds, the first being the smoke's; the main
shape under the smoke's seed) and holds, against the plain version run in
float64 on the same rows, the kernel, the parent's kernel (with
``--parent``), the plain version in float32 on the card (twice) and on the
host's CPU, and the float64 run started from parameters moved by up to
2^-24 of their size: elements beyond ``TOL * max(1, |ref|)`` and the loss.
For the smoke's seed it follows the plain versions step by step, to show
where they part.

``--parent DIR`` (may be given more than once) runs the epoch timings first
(and again last) on the package of another tree (a copy of the parent
commit, unpacked with ``git archive`` into the ignored ``chip_work/``), in a
process of its own, so that both stand side by side from one card. It
asserts nothing: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernel to its tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_wide_gpu.py [--parent DIR] [--variants] [--stamps] [--drift]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

TOWER = (1024, 512, 256, 128, 64)
TOL = 1e-4
SHAPES = {"main": 1024, "b64": 64}  # batch; 16 steps an epoch at each


# cut builds: (what is cut, [(source text, replacement)]); see --variants
CUTS = {
    "no products": [
        ("      eht_wgmma(acc, eht_desc(a_big + ca, GA * 128), eht_desc(b_small + cb, GB * 128), "
         "ks > 0);\n      eht_wgmma(acc, eht_desc(a_small + ca, GA * 128), eht_desc(b_big + cb, "
         "GB * 128), 1);", ""),
        ("      eht_wgmma(acc, eht_desc(a_big + ca, GA * 128), eht_desc(b_big + cb, GB * 128), 1);",
         "")],
    "no staging": [
        ("      eht_stage<IA, THREADS, GA>(next, next + SA, ra);\n      eht_stage<IB, THREADS, GB>("
         "next + 2 * SA, next + 2 * SA + SB, rb);", ""),
        ("        eht_fetch<IA, THREADS>(ra, p.A, p.lda, m0, p.M, k, k1, vec_a);\n        "
         "eht_fetch<IB, THREADS>(rb, p.B, p.ldb, n0, p.N, k, k1, vec_b);", "")],
    "no finishing": [("  ehw_finish<BM, BN, THREADS>(p, tile, m0, n0);\n", "")],
}
# the whole inner dimension summed in the tensor cores' accumulators
IN_TENSOR_CORES = [
    ("eht_desc(b_small + cb, GB * 128), ks > 0);", "eht_desc(b_small + cb, GB * 128), 1);"),
    ("    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];\n", ""),
    ("      tile[(r0 + 8 * ((i / 2) % 2)) * LDT + c0 + 8 * (i / 4) + i % 2] = sum[i];",
     "      tile[(r0 + 8 * ((i / 2) % 2)) * LDT + c0 + 8 * (i / 4) + i % 2] = acc[i];"),
]


def build_alone(workdir: Path, cuts=()) -> ctypes.CDLL:
    """``fused_wide.cu`` (with ``cuts``: (text, replacement) pairs applied to a
    copy) and the error-string function in a library of their own, put in
    the place of the package's."""
    err = workdir / "err.cu"
    err.write_text('#include <cuda_runtime.h>\nextern "C" const char* eh_cuda_error_string(int c)'
                   "{return cudaGetErrorString((cudaError_t)c);}\n")
    src = Path(fw.__file__).resolve().parent.parent / "csrc" / "fused_wide.cu"
    if cuts:
        text = src.read_text()
        for old, new in cuts:
            if old not in text:
                sys.exit(f"dev_fused_wide_gpu: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        (workdir / "csrc").mkdir(exist_ok=True)
        for header in src.parent.glob("*.cuh"):
            (workdir / "csrc" / header.name).write_text(header.read_text())
        src = workdir / "csrc" / "fused_wide.cu"
        src.write_text(text)
    lib_path = workdir / "libwide.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src), str(err)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True)
    print(f"nvcc exit {done.returncode} in {time.perf_counter() - t0:.1f} s")
    keep = ("registers", "spill", "error", "warning", "Compiling")
    print("\n".join(l for l in (done.stdout + done.stderr).splitlines() if any(k in l for k in keep)))
    if done.returncode:
        sys.exit(1)
    print("tensor-core instructions by kernel:", tensor_core_instructions(lib_path))
    lib = ctypes.CDLL(str(lib_path))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.eh_fused_wide.argtypes = [ptr, ptr]
    lib.eh_fused_wide.restype = num
    lib.eh_fused_wide_args_size.restype = num
    if hasattr(lib, "eh_wide_tc_product"):
        lib.eh_wide_tc_product.argtypes = [ptr, num, ptr, num, ptr, num, num, num, num, num, num,
                                           num, ptr]
        lib.eh_wide_tc_product.restype = num
    lib.eh_cuda_error_string.argtypes = [num]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tensor_core_instructions(lib_path: Path) -> dict:
    """``{kernel: count}`` of the tensor-core instructions (``HGMMA``, or
    ``HMMA`` on TF32) that ``cuobjdump -sass`` finds in each kernel of a
    built library."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            out.setdefault(name, 0)
        elif name and ("HGMMA" in line or ("HMMA" in line and "TF32" in line)):
            out[name] += 1
    return out


def case(what, hidden, *, act="swish", norm="static", opt=("adam", 0.01), loss="mse", shuffle=True,
         n=1000, batch=128, epochs=2, nan_frac=0.0, mask_first=0, agg="sum", seed=0, cols=None):
    model = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
        generator=torch.Generator().manual_seed(seed))
    if cols is None:
        cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    cols["reco"][:mask_first] = np.nan
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    et.fit_input_norm(model, et.prepare_data(model, cols))
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), "cuda")
    logging = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    fn = et.make_fused_wide_epoch(model, opt, logging, shuffle=shuffle, epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    return what, fn, fn.plan.pack(model), tensors, perms


def check(what, fn, p0, tensors, perms):
    """Kernel against plain version: misses beyond ``TOL * max(1, |ref|)``
    per vector and per leaf, and whether a second run gives the same bits."""
    got_p, got_o, got_l = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    torch.cuda.synchronize()
    again_p, again_o, _ = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref_p, ref_o, ref_l = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    same = all(torch.equal(a, b) for a, b in ((got_p.params, again_p.params),
                                              (got_o["m"], again_o["m"]), (got_o["v"], again_o["v"])))
    out = [what, "same bits", same, "t", int(got_o["t"]), int(ref_o["t"]), "loss", float(got_l),
           float(ref_l)]
    for name, g, r in (("p", got_p.params, ref_p.params), ("m", got_o["m"], ref_o["m"]),
                       ("v", got_o["v"], ref_o["v"])):
        d = (g - r).abs()
        miss = d > TOL * r.abs().clamp_min(1.0)
        out += [name, f"max {float(d.max()):.3e}", f"miss {int(miss.sum())}/{d.numel()}"]
        if int(miss.sum()):
            out += ["by leaf", {k: int((v > TOL).sum()) for k, v in fn.plan.leaves(d).items()
                                if int((v > TOL).sum())}]
    print(*out, flush=True)


def check_gradient(what, fn, p0, tensors, perms):
    """The gradient one sgd step implies, kernel against plain version."""
    lr = dict(fn.plan.hyper)["learning_rate"]
    got = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)[0].params
    ref = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)[0].params
    g_got, g_ref = (p0.params - got) / lr, (p0.params - ref) / lr
    d = (g_got - g_ref).abs()
    miss = d > TOL * g_ref.abs().clamp_min(1.0)
    print(what, f"implied gradient: max |g| {float(g_ref.abs().max()):.3e}, max |diff| "
                f"{float(d.max()):.3e}, beyond {TOL} x max(1, |g|): {int(miss.sum())} of "
                f"{d.numel()}", flush=True)


def check_float64(what, fn, p0, tensors, perms):
    """The kernel and the float32 plain version against the plain version
    run in float64 on the same rows."""
    plan = fn.plan
    data = fn._make_data(plan, tensors)
    rows = fn.rows(tensors, perms)
    as64 = lambda cols: tuple(c.double() for c in cols)  # noqa: E731
    data64 = fe.FusedData(data.x.double(), as64(data.forcing), as64(data.y), as64(data.mask),
                          data.n_batches, data.batch)
    o = fe.init_fused_opt_state(p0)
    ref64 = fw.fused_wide_reference(
        plan, fe.FusedParams(p0.params.double(), p0.bn.double()),
        {"m": o["m"].double(), "v": o["v"].double(), "t": o["t"]}, data64, rows)
    got = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    for name, a in (("kernel", got[0].params), ("plain float32", ref[0].params)):
        print(what, name, "against float64: max |diff|",
              f"{float((a.double() - ref64[0].params).abs().max()):.3e}")
    print(what, "kernel against plain float32: max |diff|",
          f"{float((got[0].params - ref[0].params).abs().max()):.3e}", "losses", float(got[2]),
          float(ref[2]), float(ref64[2]), flush=True)


def check_drift(what, fn, p0, tensors, perms):
    """Elements of the parameters and first moments beyond ``TOL * max(1,
    |ref|)``: the kernel against the float32 plain version, and each of the
    two against the plain version run in float64 on the same rows. Where the
    float32 plain version is as far from float64 as the kernel is from it,
    the run amplifies rounding and the criterion measures that."""
    plan = fn.plan
    data = fn._make_data(plan, tensors)
    rows = fn.rows(tensors, perms)
    as64 = lambda cols: tuple(c.double() for c in cols)  # noqa: E731
    data64 = fe.FusedData(data.x.double(), as64(data.forcing), as64(data.y), as64(data.mask),
                          data.n_batches, data.batch)
    o = fe.init_fused_opt_state(p0)
    ref64 = fw.fused_wide_reference(
        plan, fe.FusedParams(p0.params.double(), p0.bn.double()),
        {"m": o["m"].double(), "v": o["v"].double(), "t": o["t"]}, data64, rows)
    got = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    out = [what]
    for name, a, b in (("kernel-plain32", got, ref), ("plain32-plain64", ref, ref64),
                       ("kernel-plain64", got, ref64)):
        for key, x, y in (("p", a[0].params, b[0].params), ("m", a[1]["m"], b[1]["m"])):
            d = (x.double() - y.double()).abs()
            out.append(f"{name} {key}: {int((d > TOL * y.double().abs().clamp_min(1)).sum())} "
                       f"beyond, max {float(d.max()):.2e};")
    print(*out, f"losses {float(got[2]):.6f} {float(ref[2]):.6f} {float(ref64[2]):.6f}", flush=True)


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call, the calls queued behind a sleep kernel
    so that the events bracket device work and not the host's enqueue."""
    cycles = 20_000_000
    for _ in range(6):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("could not enqueue the timed calls ahead of the device")


def kernel_ms(fn, reps: int) -> dict:
    """Device ms per call of each ``eh_wide_*`` kernel (by name, template
    arguments kept) from ``torch.profiler``, and their launches per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "eh_wide" in e.key:
            name = re.sub(r"\(.*", "", e.key)
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.self_device_time_total / 1e3 / reps, n + e.count // reps)
    return out


def time_epochs(tag, main_cols):
    """One epoch of 16 steps at each shape: events against the kernels' sum."""
    first = {k: v[:1024] for k, v in main_cols.items()}
    for key, batch in SHAPES.items():
        cols = dict(main_cols) if key == "main" else dict(first)
        _, fn, p0, tensors, perms = case(f"tower {key}", TOWER, batch=batch, epochs=1, cols=cols)
        opt0 = fe.init_fused_opt_state(p0)
        call = lambda: fn(p0, opt0, tensors, perms=perms)  # noqa: E731
        for _ in range(3):
            call()
        nb = int(tensors.weight.shape[0])
        ev = statistics.median(device_ms(call, 2) for _ in range(7))
        split = kernel_ms(call, 3)
        total = sum(ms for ms, _ in split.values())
        print(f"[{tag}] {key}: epoch of {nb} steps of {batch}: device ms (events, median of 7) "
              f"{ev:.4f}, {ev / nb * 1e3:.2f} us a step; sum of its kernels' durations "
              f"(profiler) {total:.4f}; gaps "
              f"{ev - total:.4f} ms ({(ev - total) / ev:.1%} of the epoch)", flush=True)
        for name, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
            print(f"[{tag}] {key}:   {ms / nb * 1e3:8.2f} us a step  x{n // nb:3d} a step  {name}")


def step_labels(plan):
    """The launches of one step of kernel 3, in the launcher's order."""
    n_layers = len(plan.dims) - 1
    out = ["gather"] + [f"forward {l}" for l in range(n_layers)] + ["head"]
    for l in reversed(range(n_layers)):
        out += [f"weight {l}"] + ([f"data {l}"] if l > 0 or plan.has_norm else [])
    return out + (["norm_grad"] if plan.has_norm else []) + ["update"]


def launch_us(fn, labels):
    """Device microseconds each launch of a step adds to the timeline, by
    label, averaged over one call's steps: its end less the end of the launch
    before it (its duration and the gap before it), from ``torch.profiler``'s
    kernel activities (the call's W^T copy left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and "eh_wide" in e.name),
                     key=lambda e: e.time_range.start)
    ends = [e.time_range.end for e in kernels]
    incr = [ends[0] - kernels[0].time_range.start] + [b - a for a, b in zip(ends, ends[1:])]
    incr = [x for e, x in zip(kernels, incr) if "transpose" not in e.name]
    steps = len(incr) // len(labels)
    out = {}
    for i, x in enumerate(incr[: steps * len(labels)]):
        out[labels[i % len(labels)]] = out.get(labels[i % len(labels)], 0.0) + x / steps
    return out


def time_products():
    """Every product of a step of the tower in its launch, by the profiler,
    with torch.matmul's float32 and TF32 times of the same shapes beside it
    (a yardstick; the port never calls it)."""
    dims = (2,) + TOWER + (1,)
    g = torch.Generator(device="cuda").manual_seed(0)
    main_cols = {k: v[:16384] for k, v in et.rbq10_columns(20480, seed=42).items()}
    first = {k: v[:1024] for k, v in main_cols.items()}
    for key, batch in SHAPES.items():
        cols = dict(main_cols) if key == "main" else dict(first)
        _, fn, p0, tensors, perms = case(f"tower {key}", TOWER, batch=batch, epochs=1, cols=cols)
        opt0 = fe.init_fused_opt_state(p0)
        call = lambda: fn(p0, opt0, tensors, perms=perms)  # noqa: E731
        call()
        runs = [launch_us(call, step_labels(fn.plan)) for _ in range(5)]
        us = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        lay = fw.wide_layout(dims, True, batch)
        totals = {"kernel": 0.0, "float32 matmul": 0.0, "tf32 matmul": 0.0}
        flops_all = 0
        for l, geo in enumerate(lay.geometry):
            din, dout = dims[l], dims[l + 1]
            for what, (m, n, k), prod in (("forward", (batch, dout, din), geo.forward),
                                          ("data", (batch, din, dout), geo.data),
                                          ("weight", (dout, din, batch), geo.weight)):
                if f"{what} {l}" not in us:
                    continue
                a = torch.randn(m, k, device="cuda", generator=g)
                bt = torch.randn(k, n, device="cuda", generator=g)
                ms = {"kernel": max(us[f"{what} {l}"], 1e-3) / 1e3}
                for name, tf32 in (("float32 matmul", False), ("tf32 matmul", True)):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    f = lambda: a @ bt  # noqa: E731
                    f()
                    ms[name] = statistics.median(device_ms(f, 20) for _ in range(5))
                torch.backends.cuda.matmul.allow_tf32 = False
                flops = 2 * m * n * k
                for name in totals:
                    totals[name] += ms[name]
                flops_all += flops
                print(f"[products] {key} layer {l} {what} {m}x{n} over {k}, {prod}: "
                      + ", ".join(f"{name} {v * 1e3:.2f} us ({flops / v / 1e9:.1f} TFLOP/s)"
                                  for name, v in ms.items()), flush=True)
        print(f"[products] {key}: the step's products, {flops_all / 1e9:.3f} GFLOP: "
              + ", ".join(f"{k} {v * 1e3:.2f} us ({flops_all / v / 1e9:.1f} TFLOP/s)"
                          for k, v in totals.items()), flush=True)
        rest = {k: v for k, v in us.items() if k.split()[0] not in ("forward", "data", "weight")}
        print(f"[products] {key}: the step's other launches, us: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rest.items()), flush=True)


STAMPS = [
    ("enum { EHW_RAW = 0, EHW_FORWARD, EHW_DATA, EHW_WEIGHT };",
     "enum { EHW_RAW = 0, EHW_FORWARD, EHW_DATA, EHW_WEIGHT };\n"
     "__device__ long long ehw_stamp_buf[4];\n"
     "#define EHW_STAMP(i) if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
     "threadIdx.x == 0) ehw_stamp_buf[i] = clock64();\n"
     'extern "C" int eh_wide_stamps(long long* out) { return (int)cudaMemcpyFromSymbol('
     "out, ehw_stamp_buf, sizeof(ehw_stamp_buf)); }\n"),
    ("  constexpr int THREADS = 2 * BM;\n  constexpr int GA",
     "  EHW_STAMP(0);\n  constexpr int THREADS = 2 * BM;\n  constexpr int GA"),
    ("  __syncthreads();\n  for (int t = 0; t < slices; ++t) {",
     "  __syncthreads();\n  EHW_STAMP(1);\n  for (int t = 0; t < slices; ++t) {"),
    ("  // the accumulators to the output tile in shared memory, then ehw_finish",
     "  EHW_STAMP(2);\n  // the accumulators to the output tile in shared memory, then ehw_finish"),
    ("  ehw_finish<BM, BN, THREADS>(p, tile, m0, n0);\n",
     "  ehw_finish<BM, BN, THREADS>(p, tile, m0, n0);\n  EHW_STAMP(3);\n"),
]


def time_stamps():
    """Each tile shape alone over K = 256 (8 slices, one block): cycles of
    its stages from the stamped build."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_alone(Path(tmp), STAMPS)
        _build.load_library = lambda: lib
        g = torch.Generator(device="cuda").manual_seed(0)
        for bm, bn in ((64, 64), (128, 64)):
            a = torch.randn(bm, 256, device="cuda", generator=g)
            b = torch.randn(bn, 256, device="cuda", generator=g)
            geo = fw.Product(fw.TENSOR_CORES, bm, bn, 1, 256)
            for _ in range(3):
                fw._wide_product(a, b, geo)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 4)()
            lib.eh_wide_stamps(buf)
            st = list(buf)
            print(f"[stamps] {bm}x{bn} tile over K = 256, one block: first slice staged "
                  f"{st[1] - st[0]} cycles, 8 slices {st[2] - st[1]} ({(st[2] - st[1]) / 8:.0f} a "
                  f"slice), finishing {st[3] - st[2]}", flush=True)


def step_by_launch(key, batch, cols):
    """``(us a step by events, {launch label: us it adds})`` at one shape."""
    _, fn, p0, tensors, perms = case(f"tower {key}", TOWER, batch=batch, epochs=1, cols=cols)
    opt0 = fe.init_fused_opt_state(p0)
    call = lambda: fn(p0, opt0, tensors, perms=perms)  # noqa: E731
    call()
    nb = int(tensors.weight.shape[0])
    ev = statistics.median(device_ms(call, 2) for _ in range(5)) / nb * 1e3
    runs = [launch_us(call, step_labels(fn.plan)) for _ in range(3)]
    return ev, {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def time_variants(main_cols):
    """The whole build and each cut build, step by step and launch by launch;
    then the products over K = 1,024 with the sum in float32 registers after
    every slice (the kernel's) and in the tensor cores throughout."""
    first = {k: v[:1024] for k, v in main_cols.items()}
    builds = {"whole": ()} | CUTS
    for name, cuts in builds.items():
        with tempfile.TemporaryDirectory() as tmp:
            lib = build_alone(Path(tmp), cuts)
            _build.load_library = lambda lib=lib: lib
            for key, batch in SHAPES.items():
                ev, us = step_by_launch(key, batch, dict(main_cols if key == "main" else first))
                tc = sum(v for k, v in us.items()
                         if k.split()[0] in ("forward", "data", "weight")
                         and fw.wide_geometry((2,) + TOWER + (1,), batch)[int(k.split()[1])].route
                         == fw.TENSOR_CORES)
                print(f"[variants] {name}, {key}: {ev:.2f} us a step (events); the tensor-core "
                      f"launches add {tc:.1f}; by launch: "
                      + " ".join(f"{k}={v:.1f}" for k, v in us.items()), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(1024, 1024, device="cuda", generator=g)
    b = torch.randn(512, 1024, device="cuda", generator=g)
    ref = a.double() @ b.double().T
    f32 = float(((a @ b.T).double() - ref).abs().max())
    for name, cuts in (("float32 registers after every slice", ()),
                       ("the tensor cores throughout", IN_TENSOR_CORES)):
        with tempfile.TemporaryDirectory() as tmp:
            lib = build_alone(Path(tmp), cuts)
            _build.load_library = lambda lib=lib: lib
            for geo in (fw.Product(fw.TENSOR_CORES, 128, 64, 1, 1024),
                        fw.Product(fw.TENSOR_CORES, 128, 64, 4, 256)):
                err = float((fw._wide_product(a, b, geo).double() - ref).abs().max())
                print(f"[variants] 1024x512 over 1024, {geo.splits} piece(s), the sum in {name}: "
                      f"max |diff| from float64 {err:.3e} (torch.matmul in float32 {f32:.3e})",
                      flush=True)


DRIFT_SEEDS = (0, 1, 2)  # 0 is chip_smoke.py's


def drift_cases(main_cols):
    """The tower's Adam cases of chip_smoke.py phase 16: ``(label, case)``."""
    first = {k: v[:1024] for k, v in main_cols.items()}
    out = [(f"batch 64 seed {seed}", dict(batch=64, epochs=2, cols=first, seed=seed))
           for seed in DRIFT_SEEDS]
    return out + [("batch 1,024 seed 0", dict(batch=1024, epochs=2, cols=main_cols, seed=0))]


def kernel_runs(main_cols):
    """The kernel's parameters, moments and loss on every drift case."""
    out = {}
    for label, kw in drift_cases(main_cols):
        _, fn, p0, tensors, perms = case(label, TOWER, **{**kw, "cols": dict(kw["cols"])})
        p, o, loss = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
        out[label] = {"params": p.params.cpu(), "m": o["m"].cpu(), "v": o["v"].cpu(),
                      "loss": float(loss)}
    return out


def plain_on(fn, p0, tensors, perms, dtype, device, params=None):
    """The plain version's state after every step (a generator), in ``dtype``
    on ``device``, from ``params`` (by default the packed ones): parameters,
    moments, the step's loss and the mean loss of its epoch so far."""
    plan, data, rows = fn.plan, fn._make_data(fn.plan, tensors), fn.rows(tensors, perms)
    to = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    d = fe.FusedData(to(data.x), tuple(map(to, data.forcing)), tuple(map(to, data.y)),
                     tuple(map(to, data.mask)), 1, data.batch)
    o = fe.init_fused_opt_state(p0)
    p = fe.FusedParams(to(p0.params if params is None else params), to(p0.bn))
    st = {"m": to(o["m"]), "v": to(o["v"]), "t": o["t"].to(device)}
    b = data.batch
    for e in range(rows.shape[0]):
        total = 0.0
        for i in range(data.n_batches):
            p, st, loss = fw.fused_wide_reference(plan, p, st, d,
                                                  rows[e:e + 1, i * b:(i + 1) * b].to(device))
            total += float(loss)
            yield {"params": p.params, "m": st["m"], "v": st["v"], "step_loss": float(loss),
                   "loss": total / (i + 1)}


def last(gen):
    out = None
    for out in gen:
        pass
    return out


def beyond(got, ref):
    d = (got.double().cpu() - ref.double().cpu()).abs()
    return int((d > TOL * ref.double().cpu().abs().clamp_min(1.0)).sum()), float(d.max())


def drift_study(main_cols, parents):
    """``--drift``: see the module's docstring."""
    kernel = kernel_runs(main_cols)
    for label, kw in drift_cases(main_cols):
        _, fn, p0, tensors, perms = case(label, TOWER, **{**kw, "cols": dict(kw["cols"])})
        g = torch.Generator(device="cuda").manual_seed(99)
        moved = p0.params.double() * (1 + (torch.rand(p0.params.shape, generator=g, device="cuda",
                                                       dtype=torch.float64) - 0.5) * 2 ** -23)
        versions = {"f64": plain_on(fn, p0, tensors, perms, torch.float64, "cuda"),
                    "f32 card": plain_on(fn, p0, tensors, perms, torch.float32, "cuda"),
                    "f32 card again": plain_on(fn, p0, tensors, perms, torch.float32, "cuda"),
                    "f32 cpu": plain_on(fn, p0, tensors, perms, torch.float32, "cpu"),
                    "f64 moved 2^-24": plain_on(fn, p0, tensors, perms, torch.float64, "cuda",
                                                moved)}
        steps = int(tensors.weight.shape[0]) * kw["epochs"]
        final = {}
        for step in range(steps):
            now = {k: next(v) for k, v in versions.items()}
            if label == "batch 64 seed 0" or step == steps - 1:
                print(f"[drift] {label} step {step + 1}: params beyond against f64: "
                      + ", ".join(f"{k} {beyond(now[k]['params'], now['f64']['params'])[0]}"
                                  for k in now if k != "f64")
                      + "; batch loss " + ", ".join(f"{k} {v['step_loss']:.6f}"
                                                    for k, v in now.items()),
                      flush=True)
            final = now
        runs = {"kernel": kernel[label], **{k: v for k, v in final.items() if k != "f64"}}
        for tag, res in parents.items():
            runs[f"parent kernel ({tag})"] = res[label]
        for against in ("f64", "f32 card"):
            ref = final[against]
            for name, r in runs.items():
                if name == against:
                    continue
                notes = [f"{key} {'%d (max %.2e)' % beyond(r[key], ref[key])}"
                         for key in ("params", "m", "v")]
                print(f"[drift] {label}: {name} against the plain version {against}: "
                      + ", ".join(notes) + f"; loss {r['loss']:.6f} against {ref['loss']:.6f}",
                      flush=True)
        same = all(torch.equal(final["f32 card"][k], final["f32 card again"][k])
                   for k in ("params", "m", "v"))
        print(f"[drift] {label}: the plain version in float32 on the card twice: same bits "
              f"{same}", flush=True)


def side(tag, args):
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_alone(Path(tmp))
        _build.load_library = lambda: lib
        torch.backends.cuda.matmul.allow_tf32 = False
        main_cols = {k: v[:16384] for k, v in et.rbq10_columns(20480, seed=42).items()}
        if tag != "change" and args.drift_file:
            torch.save(kernel_runs(main_cols), args.drift_file)
        if tag == "change" and args.drift:
            drift_study(main_cols, {Path(d).name: torch.load(f) for d, f in args.drift_files})
        if tag == "change" and not args.skip_cases:
            first = {k: v[:1024] for k, v in main_cols.items()}
            check_gradient(*case("tower sgd 1 step", TOWER, opt=("sgd", 1e-3), shuffle=False,
                                 batch=1024, epochs=1, cols=dict(first)))
            check(*case("tower adam 1 step", TOWER, shuffle=False, batch=1024, epochs=1,
                        cols=dict(first)))
            for epochs in (1, 2):
                check(*case(f"tower adam {epochs}x16", TOWER, batch=1024, epochs=epochs,
                            cols=dict(main_cols)))
            check(*case("tower batch 64, 2x16", TOWER, batch=64, epochs=2, cols=dict(first)))
            check_gradient(*case("tower batch 64 sgd 1 step", TOWER, opt=("sgd", 1e-3),
                                 shuffle=False, batch=64, epochs=1,
                                 cols={k: v[:64] for k, v in first.items()}))
            for epochs in (1, 2):
                check_drift(*case(f"tower batch 64, {epochs}x16", TOWER, batch=64, epochs=epochs,
                                  cols=dict(first)))
            check_drift(*case("tower adam 2x16", TOWER, batch=1024, epochs=2,
                              cols=dict(main_cols)))
            check(*case("(100,37) tanh", (100, 37), act="tanh", n=777, batch=100))
            check(*case("nan ragged", (128, 64), nan_frac=0.3, n=1000, batch=300, agg="mean"))
            check(*case("masked first", (128, 64), shuffle=False, mask_first=128, n=1024,
                        batch=128, epochs=1))
            check(*case("batches", (65,), act="gelu", shuffle="batches", n=2000, batch=300))
            check(*case("(300,200,100) batch 64", (300, 200, 100), n=600, batch=64, epochs=1))
            for lr in (0.05, 1e-3):
                check_float64(*case(f"mae sgd {lr} no norm, 8 steps", (128, 64), norm=False,
                                    opt=("sgd", lr), loss="mae", shuffle=False, batch=256,
                                    epochs=2, cols=et.rbq10_columns(1000, seed=3), seed=1))
        time_epochs(tag, main_cols)
        if tag == "change" and hasattr(fw, "_wide_product"):
            time_products()
    if tag == "change" and args.variants:
        time_variants(main_cols)
    if tag == "change" and args.stamps:
        time_stamps()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", action="append", default=[],
                        help="a copy of another tree to time as well (may be repeated)")
    parser.add_argument("--side", default="change", help=argparse.SUPPRESS)
    parser.add_argument("--skip-cases", action="store_true")
    parser.add_argument("--variants", action="store_true",
                        help="time builds with parts of the tensor-core kernel cut out")
    parser.add_argument("--stamps", action="store_true",
                        help="cycles of a slice of each tile shape, from a stamped build")
    parser.add_argument("--drift", action="store_true",
                        help="the tower's Adam cases against the plain version in float64")
    parser.add_argument("--drift-file", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_wide_gpu: needs a CUDA GPU")
    if args.side == "change":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip(), flush=True)

    def parent_side(parent, drift_file=""):
        parent = Path(parent).resolve()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--side", parent.name,
               "--drift-file", drift_file]
        subprocess.run(cmd, check=True, cwd=parent, env={**os.environ, "PYTHONPATH": str(parent)})

    with tempfile.TemporaryDirectory() as tmp:
        args.drift_files = []
        for parent in args.parent:
            drift_file = str(Path(tmp) / f"{len(args.drift_files)}.pt") if args.drift else ""
            parent_side(parent, drift_file)
            if drift_file:
                args.drift_files.append((parent, drift_file))
        side(args.side, args)
        for parent in args.parent:
            parent_side(parent)


if __name__ == "__main__":
    main()
