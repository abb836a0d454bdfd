"""Kernel 4 (``easyhybrid_tpu_torch/csrc/fused_epoch_lstm.cu``) alone on a CUDA
GPU: a quick loop for work on that kernel.

Compiles only ``fused_epoch_lstm.cu`` (five builds side by side: the plain
one, one with ``-DEHL_STAMPS`` whose thread 0 stamps every stage of a step
with ``clock64()``, one with ``-DEHL_CHAIN_ONLY`` whose arithmetic is stubbed
out, one with both, and one with ``-DEHL_RECOMPUTE_PASSES``), prints ptxas's
registers and spills by kernel and the compile seconds, holds the
kernel against its plain PyTorch version on every case of
``chip_smoke.lstm_cases`` (twice: the second run must give the same bits),
and at the main shape (LSTM(16), 10-step windows, 25 steps of 128) and the
JAX bench's (8 steps of 512, no norm, mse) times one epoch, splits a step by
stage, times the chain with the arithmetic stubbed out and splits it by
stage, and times cuDNN's
LSTM forward and backward over the same windows as a yardstick for the
recurrence alone (it computes no part of kernel 4's function).

``--parent DIR`` builds another tree's ``fused_epoch_lstm.cu`` (a copy of
the parent commit) beside this one, holds this build's results to the
parent's bits on every ``lstm_cases`` case (the parent's launcher reads the
leading fields of this tree's argument struct, which only grew at its end)
and times the main and bench shapes in turns (parent, this, this, parent).
``--loss L,...`` times the main shape's epoch under each loss beside mse in
turns, with the stage split (the moments exchange is a stage of its own);
``--recompute`` times the two-pass losses also in the build that recomputes
the forward for the moments (``-DEHL_RECOMPUTE_PASSES``) in place of keeping
the predictions. ``--members K,...`` times a member launch of 5 epochs at the
main shape for each K (a learning-rate sweep) and holds every member of the
K = 8 launch to its launch alone, bit for bit. ``--two-pass-checks`` runs
``chip_smoke.py``'s phase 35 (the two-pass losses and the member axis
against their plain versions). ``--cluster 4,8`` repeats the timing with the
thread-block cluster forced to each size, ``--skip-cases`` leaves the
comparisons out. Apart from the parent's bits it asserts nothing:
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel to its
tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_lstm_gpu.py [--parent DIR] [--loss rmse,kgeLoss]
        [--members 1,8,16] [--recompute] [--two-pass-checks]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl

TOL = chip_smoke.TOL_EPOCH
VARIANTS = {"plain": (), "stamps": ("-DEHL_STAMPS",), "chain": ("-DEHL_CHAIN_ONLY",),
            "chain stamps": ("-DEHL_CHAIN_ONLY", "-DEHL_STAMPS"),
            "recompute": ("-DEHL_RECOMPUTE_PASSES",)}
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


def parent_build(parent):
    """The parent tree's ``fused_epoch_lstm.cu`` compiled with this tree's
    flags, beside the package's builds."""
    src = Path(parent).resolve() / "easyhybrid_tpu_torch" / "csrc" / "fused_epoch_lstm.cu"
    out = _build._BUILD_DIR / "libparent_fused_epoch_lstm.so"
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's source:\n{proc.stdout}")
    return _build.BuildResult(out, time.perf_counter() - t0, proc.stdout, {})


def build_all(tag, parent=None):
    variants = dict(VARIANTS)
    with concurrent.futures.ThreadPoolExecutor(len(variants) + 1) as pool:
        futures = {k: pool.submit(_build.build_variant, "fused_epoch_lstm.cu", d)
                   for k, d in variants.items()}
        if parent:
            futures["parent"] = pool.submit(parent_build, parent)
        built = {k: f.result() for k, f in futures.items()}
    print(f"[{tag}] nvcc " + ", ".join(f"{k} {v.seconds:.1f} s" for k, v in built.items()))
    keep = ("Compiling entry", "registers", "spill", "warning", "error")
    for name in ("plain", "parent"):
        for line in built[name].log.splitlines() if name in built else ():
            if any(k in line for k in keep):
                print(f"[{tag}] {name}: {line.strip()}")
    return {k: load(v) for k, v in built.items()}


def use(lib):
    _build.load_library = lambda: lib


def geometry_of(fn, tensors):
    nb, batch = (int(v) for v in tensors.weight.shape)
    return fn.plan.geometry(batch, int(tensors.x.shape[2]), int(next(iter(
        tensors.y.values())).shape[2]))


def check(tag, what, fn, p0, tensors, perms):
    """Kernel against plain version: misses beyond ``TOL * max(1, |ref|)``,
    and whether a second run gives the same bits."""
    got_p, got_o, got_l = fn(p0, chip_smoke.fresh_state(fn, p0), tensors, perms=perms)
    torch.cuda.synchronize()
    again_p, again_o, again_l = fn(p0, chip_smoke.fresh_state(fn, p0), tensors, perms=perms)
    ref_p, ref_o, ref_l = fn.reference(p0, chip_smoke.fresh_state(fn, p0), tensors, perms=perms)
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
    names = fl.STAGES
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


def run_with(lib, fn, p0, tensors, perms):
    """One launch of ``lib``'s kernel (the parent's, say) from the fused
    epoch's own arguments: the fields by name, as ``check`` compares them."""
    data, rows = fn._make_data(fn.plan, tensors), fn.rows(tensors, perms)
    packed = fe.FusedParams(p0.params.clone(), p0.bn.clone())
    opt = chip_smoke.fresh_state(fn, p0)
    loss = torch.zeros((1,), dtype=torch.float32, device="cuda")
    a = fl.launch_args(fn.plan, packed, opt, data, rows, loss)
    rc = lib.eh_fused_lstm(ctypes.byref(a), fn.plan.width,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return {"params": packed.params, "bn": packed.bn, **opt, "loss": loss}


def parent_bits(libs):
    """This build against the parent's on every ``lstm_cases`` case: equal
    bits in every field."""
    for case in chip_smoke.lstm_cases():
        what, fn, p0, tensors, perms = chip_smoke.prepare_lstm_case(et, **case)
        mine, theirs = (run_with(libs[k].lib, fn, p0, tensors, perms) for k in ("plain", "parent"))
        same = all(torch.equal(mine[k].view(torch.int32), theirs[k].view(torch.int32))
                   for k in mine)
        print(f"[bits] {what}: the parent's bits {same}", flush=True)
        if not same:
            raise AssertionError(f"{what}: this build differs from the parent's")


def in_turns(calls, rounds=4, reps=10):
    """Median device ms of each call, the calls taken in turns (forward, then
    backward, and so on)."""
    samples = {k: [] for k in calls}
    for i in range(rounds):
        for k in (list(calls) if i % 2 == 0 else list(reversed(list(calls)))):
            samples[k].append(chip_smoke.device_ms(calls[k], reps, k))
    return {k: statistics.median(v) for k, v in samples.items()}


def parent_times(libs):
    """The main and bench shapes' epochs, the parent's build and this one in
    turns (parent, this, this, parent, ...)."""
    for key in SHAPES:
        what, fn, p0, tensors, perms = chip_smoke.prepare_lstm_case(et, **SHAPES[key])
        calls = {name: (lambda lib=libs[name].lib: run_with(lib, fn, p0, tensors, perms))
                 for name in ("parent", "plain")}
        for c in calls.values():
            chip_smoke.host_ms(c, 3)
        ms = in_turns(calls, rounds=6)
        print(f"[times] {what}: parent {ms['parent']:.4f} ms an epoch, this {ms['plain']:.4f} "
              f"({ms['plain'] / ms['parent'] - 1:+.2%})", flush=True)


def loss_times(libs, losses, recompute):
    """The main shape's epoch under mse and each loss, in turns, each with its
    stage split; with ``recompute``, the two-pass losses in the build that
    recomputes the forward for the moments too."""
    calls = {}
    for loss in ["mse", *losses]:
        what, fn, p0, tensors, perms = chip_smoke.prepare_lstm_case(
            et, **{**SHAPES["main"], "loss": loss})
        nb = int(tensors.weight.shape[0])
        opt0 = fe.init_fused_opt_state(p0)
        calls[loss] = (lambda fn=fn, p0=p0, t=tensors, pm=perms, o=opt0: fn(p0, o, t, perms=pm))
        if recompute and fn.plan.two_pass:
            calls[f"{loss} (recompute)"] = (lambda fn=fn, p0=p0, t=tensors, pm=perms:
                                            run_with(libs["recompute"].lib, fn, p0, t, pm))
    use(libs["plain"])
    for c in calls.values():
        chip_smoke.host_ms(c, 3)
    ms = in_turns(calls)
    print("[loss times] main shape, one epoch of 25 steps: " + ", ".join(
        f"{k} {v:.4f} ms ({v / ms['mse']:.2f}x mse, {v / nb * 1e3:.2f} us a step)"
        for k, v in ms.items()), flush=True)
    for loss in ["mse", *losses]:
        cycles = stamped_cycles(libs, calls[loss])
        cycles = stamped_cycles(libs, calls[loss])
        total = cycles.pop("kernel")
        use(libs["plain"])
        print(f"[loss times] {loss}, cycles a step by stage (share): " + ", ".join(
            f"{k} {v / nb:.0f} ({v / total:.1%})" for k, v in cycles.items() if v), flush=True)


def member_times(ks):
    """A member launch of 5 epochs at the main shape (a learning-rate sweep)
    for each K; every member of the K = 8 launch against its launch alone."""
    out = {}
    for k in ks:
        fn, packed, opt0, data = chip_smoke.lstm_member_inputs(et, k, epochs=5)
        specs = [("adam", {"learning_rate": lr}) for lr in (chip_smoke.LSTM_POP_LRS * 8)[:k]]
        rows = fn.member_rows(data, k, per_member_data=False,
                              generator=torch.Generator(device="cuda").manual_seed(0))
        member_opt = fe.member_opt_rows(fn.plan, specs, "cuda")

        def launch(fn=fn, packed=packed, opt0=opt0, data=data, rows=rows, specs=specs,
                   member_opt=member_opt):
            return fn.members(packed, opt0, data, rows, specs=specs, member_opt=member_opt)

        chip_smoke.host_ms(launch, 2)
        out[k] = statistics.median(chip_smoke.device_ms(launch, 5, f"K={k}") for _ in range(5))
        if k == 8:
            got = chip_smoke.member_fields(launch())
            for i in range(k):
                alone = chip_smoke.member_fields(fn.alone(
                    fe.FusedParams(packed.params[i], packed.bn[i]),
                    {n: v[i] for n, v in opt0.items()}, data, rows, specs[i]))
                if not all(torch.equal(got[f][i].reshape(alone[f].shape), alone[f]) for f in alone):
                    print(f"[members] K=8: member {i} differs from its launch alone", flush=True)
    print("[members] a launch of 5 epochs x 25 steps of 128 windows: " + ", ".join(
        f"K={k} {v:.4f} ms ({v / out[min(out)]:.2f}x K={min(out)})" for k, v in out.items()),
        flush=True)


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default="", help="a copy of another tree to hold and time")
    parser.add_argument("--cluster", default="0", help="sizes to force, e.g. 4,8 (0: the plan's)")
    parser.add_argument("--loss", default="", help="losses to time beside mse, e.g. rmse,kgeLoss")
    parser.add_argument("--members", default="", help="member counts to time, e.g. 1,8,16")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--two-pass-checks", action="store_true")
    parser.add_argument("--skip-cases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_lstm_gpu: needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    tag = "change"
    libs = build_all(tag, args.parent)
    use(libs["plain"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.parent:
        parent_bits(libs)
        parent_times(libs)
    if not args.skip_cases:
        for case in chip_smoke.lstm_cases():
            check(tag, *chip_smoke.prepare_lstm_case(et, **case))
    if args.two_pass_checks:
        chip_smoke.lstm_two_pass_checks(et)
    if args.loss:
        loss_times(libs, args.loss.split(","), args.recompute)
    if args.members:
        member_times([int(k) for k in args.members.split(",")])
    for key in SHAPES:
        time_shape(tag, libs, key)
    for cluster in (int(c) for c in args.cluster.split(",") if int(c)):
        for key in SHAPES:
            try:
                time_shape(f"{tag}, cluster {cluster}", libs, key, cluster)
            except RuntimeError as err:  # a cluster the card cannot co-schedule
                print(f"[{tag}, cluster {cluster}] {key}: {err}", flush=True)
    for batch in (128, 512):
        print(f"[yardstick] cuDNN LSTM(2 -> 16) forward + backward over {batch} windows x 10 "
              f"steps (torch.nn.LSTM): device ms {cudnn_ms(batch, 10):.4f} a call", flush=True)


if __name__ == "__main__":
    main()
