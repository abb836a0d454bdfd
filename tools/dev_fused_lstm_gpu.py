"""Kernel 4 (``easyhybrid_tpu_torch/csrc/fused_epoch_lstm.cu``) alone on a CUDA
GPU: a quick loop for work on that kernel.

Compiles only ``fused_epoch_lstm.cu`` (four builds side by side: the plain
one, one with ``-DEHL_STAMPS`` whose thread 0 stamps every stage of a step
with ``clock64()``, one with ``-DEHL_CHAIN_ONLY`` whose arithmetic is stubbed
out, and one with both), prints ptxas's registers and spills and the compile seconds, holds the
kernel against its plain PyTorch version on every case of
``chip_smoke.lstm_cases`` (twice: the second run must give the same bits),
and at the main shape (LSTM(16), 10-step windows, 25 steps of 128) and the
JAX bench's (8 steps of 512, no norm, mse) times one epoch, splits a step by
stage, times the chain with the arithmetic stubbed out and splits it by
stage, and times cuDNN's
LSTM forward and backward over the same windows as a yardstick for the
recurrence alone (it computes no part of kernel 4's function).

``--parent DIR`` runs the same measurements first on the package of another
tree (a copy of the parent commit, with the stamp macros in its kernel), in a
process of its own, so that both stand side by side from one card.
``--cluster 4,8`` repeats the timing with the thread-block cluster forced to
each size (the package's plan only), ``--skip-cases`` leaves the comparisons
out. It asserts nothing: ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernel to its tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_lstm_gpu.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl

TOL = chip_smoke.TOL_EPOCH
VARIANTS = {"plain": (), "stamps": ("-DEHL_STAMPS",), "chain": ("-DEHL_CHAIN_ONLY",),
            "chain stamps": ("-DEHL_CHAIN_ONLY", "-DEHL_STAMPS")}
# the stamped stages of a kernel without its own list (the parent's)
OLD_STAGES = ("loss scales", "input staging", "forward and loss", "backward dz",
              "dh and input cotangents", "gradient sums", "norm and global sums", "update")
SHAPES = {
    "main": dict(what="main: LSTM(16), 10-step windows, static norm, nseLoss, 25 steps of 128",
                 keep=int(chip_smoke.LSTM_ROWS * 0.8), epochs=1),
    "bench": dict(what="bench: LSTM(16), 10-step windows, no norm, mse, 8 steps of 512", n=4_000,
                  norm=False, loss="mse", batch=512, epochs=1, seed=42),
}


class AloneLibrary:
    """One build of ``fused_epoch_lstm.cu`` in the place of the package's
    library, which would take every other kernel's build as well."""

    def __init__(self, lib):
        self.lib = lib
        self.eh_fused_lstm = lib.eh_fused_lstm
        self.eh_fused_lstm_args_size = lib.eh_fused_lstm_args_size

    @staticmethod
    def eh_cuda_error_string(rc):
        return f"CUDA error {rc}".encode()


def load(result):
    lib = ctypes.CDLL(str(result.path))
    lib.eh_fused_lstm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.eh_fused_lstm.restype = ctypes.c_int
    lib.eh_fused_lstm_args_size.restype = ctypes.c_int
    return AloneLibrary(lib)


def build_all(tag):
    # the parent's kernel was measured with its stamps and its chain apart
    variants = {k: v for k, v in VARIANTS.items() if tag != "parent" or k != "chain stamps"}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda d: _build.build_variant("fused_epoch_lstm.cu", d), variants.values())))
    print(f"[{tag}] nvcc " + ", ".join(f"{k} {v.seconds:.1f} s" for k, v in built.items()))
    keep = ("registers", "spill", "warning", "error")
    for line in built["plain"].log.splitlines():
        if any(k in line for k in keep):
            print(f"[{tag}] {line.strip()}")
    return {k: load(v) for k, v in built.items()}


def use(lib):
    _build.load_library = lambda: lib


def geometry_of(fn, tensors):
    nb, batch = (int(v) for v in tensors.weight.shape)
    if hasattr(fn.plan, "geometry"):
        return fn.plan.geometry(batch, int(tensors.x.shape[2]), int(next(iter(
            tensors.y.values())).shape[2]))
    return f"one block, tile {fn.plan.sizes.tile_rows(int(tensors.x.shape[2]), 1)}"


def check(tag, what, fn, p0, tensors, perms):
    """Kernel against plain version: misses beyond ``TOL * max(1, |ref|)``,
    and whether a second run gives the same bits."""
    got_p, got_o, got_l = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    torch.cuda.synchronize()
    again_p, again_o, again_l = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref_p, ref_o, ref_l = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    same = all(torch.equal(a, b) for a, b in (
        (got_p.params, again_p.params), (got_o["m"], again_o["m"]), (got_o["v"], again_o["v"]),
        (got_l, again_l)))
    out = [f"[{tag}] {what} | {geometry_of(fn, tensors)} | same bits {same} | t",
           int(got_o["t"]), int(ref_o["t"]), "loss", float(got_l), float(ref_l)]
    for name, g, r in (("p", got_p.params, ref_p.params), ("m", got_o["m"], ref_o["m"]),
                       ("v", got_o["v"], ref_o["v"])):
        d = (g - r).abs()
        miss = d > TOL * r.abs().clamp_min(1.0)
        out += [name, f"max {float(d.max()):.3e}", f"miss {int(miss.sum())}/{d.numel()}"]
        if name == "p" and int(miss.sum()):
            out += ["by leaf", {k: int((v > TOL).sum()) for k, v in fn.plan.leaves(d).items()
                                if int((v > TOL).sum())}]
    print(*out, flush=True)


def stamped_cycles(libs, call, build="stamps"):
    """One warm launch of a stamped build: cycles per stage of thread 0."""
    use(libs[build])
    call()
    torch.cuda.synchronize()
    names = getattr(fl, "STAGES", OLD_STAGES)
    buf = (ctypes.c_longlong * (len(names) + 1))()
    rc = libs[build].lib.eh_fused_lstm_stamps(buf)
    if rc != 0:
        raise RuntimeError(f"reading the stamps failed: {rc}")
    return dict(zip(names + ("kernel",), list(buf)))


def cudnn_ms(batch, steps, features=2, hidden=16):
    """cuDNN's LSTM forward and backward over ``batch`` windows: device ms a
    call (a yardstick for the recurrence alone)."""
    lstm = torch.nn.LSTM(features, hidden, batch_first=True).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, steps, features, device="cuda", generator=g, requires_grad=True)
    gout = torch.randn(batch, steps, hidden, device="cuda", generator=g)

    def call():
        out, _ = lstm(x)
        out.backward(gout)

    chip_smoke.host_ms(call, 3)
    return statistics.median(chip_smoke.device_ms(call, 20, "cudnn") for _ in range(5))


def time_shape(tag, libs, key, cluster=0):
    what, fn, p0, tensors, perms = chip_smoke.prepare_lstm_case(et, **SHAPES[key])
    if cluster:
        fn.plan = dataclasses.replace(fn.plan, cluster=cluster)
    opt0 = fe.init_fused_opt_state(p0)
    nb, batch = (int(v) for v in tensors.weight.shape)
    call = lambda: fn(p0, opt0, tensors, perms=perms)  # noqa: E731
    use(libs["plain"])
    chip_smoke.host_ms(call, 3)
    ms = statistics.median(chip_smoke.device_ms(call, 10, "kernel 4") for _ in range(5))
    print(f"[{tag}] {what} | {geometry_of(fn, tensors)} | epoch: device ms {ms:.4f}, "
          f"{ms / nb * 1e3:.2f} us a step", flush=True)
    stamped_cycles(libs, call)
    cycles = stamped_cycles(libs, call)
    total = cycles.pop("kernel")
    print(f"[{tag}] {key} per-stage split of thread 0, cycles a step (share of the launch; us a "
          "step at the plain build's time): "
          + ", ".join(f"{k} {v / nb:.0f} ({v / total:.1%}; {v / total * ms / nb * 1e3:.2f})"
                      for k, v in cycles.items()) + f"; the launch {total} cycles", flush=True)
    use(libs["chain"])
    chip_smoke.host_ms(call, 3)
    floor = statistics.median(chip_smoke.device_ms(call, 10, "chain") for _ in range(5))
    print(f"[{tag}] {key} the chain with its arithmetic stubbed out: device ms {floor:.4f} an "
          f"epoch, {floor / nb * 1e3:.2f} us a step", flush=True)
    if "chain stamps" in libs:
        stamped_cycles(libs, call, "chain stamps")
        cycles = stamped_cycles(libs, call, "chain stamps")
        cycles.pop("kernel")
        print(f"[{tag}] {key} the chain's split, cycles a step: "
              + ", ".join(f"{k} {v / nb:.0f}" for k, v in cycles.items()), flush=True)
    use(libs["plain"])
    return ms


def side(tag, args):
    libs = build_all(tag)
    use(libs["plain"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.skip_cases:
        cases = chip_smoke.lstm_cases()
        for case in cases:
            check(tag, *chip_smoke.prepare_lstm_case(et, **case))
    for key in SHAPES:
        time_shape(tag, libs, key)
    if tag == "change":
        for cluster in (int(c) for c in args.cluster.split(",") if int(c)):
            for key in SHAPES:
                try:
                    time_shape(f"{tag}, cluster {cluster}", libs, key, cluster)
                except RuntimeError as err:  # a cluster the card cannot co-schedule
                    print(f"[{tag}, cluster {cluster}] {key}: {err}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default="", help="a copy of another tree to measure first")
    parser.add_argument("--side", default="change", help=argparse.SUPPRESS)
    parser.add_argument("--cluster", default="0", help="sizes to force, e.g. 4,8 (0: the plan's)")
    parser.add_argument("--skip-cases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_lstm_gpu: needs a CUDA GPU")
    if args.side == "change":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip(), flush=True)
    if args.parent:
        parent = Path(args.parent).resolve()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--side", "parent", "--skip-cases"]
        subprocess.run(cmd, check=True, cwd=parent, env={**os.environ, "PYTHONPATH": str(parent)})
    side(args.side, args)
    if args.side == "change":
        for batch in (128, 512):
            print(f"[yardstick] cuDNN LSTM(2 -> 16) forward + backward over {batch} windows x 10 "
                  f"steps (torch.nn.LSTM): device ms {cudnn_ms(batch, 10):.4f} a call", flush=True)


if __name__ == "__main__":
    main()
