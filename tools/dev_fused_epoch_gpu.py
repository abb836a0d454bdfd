"""Kernel 2 (``easyhybrid_tpu_torch/csrc/fused_epoch.cu``) alone on a CUDA GPU:
a quick loop for work on that kernel.

Compiles only ``fused_epoch.cu`` (three builds side by side: the plain one,
one with ``-DEHE_STAMPS`` whose thread 0 stamps every stage of a step with
``clock64()``, one with ``-DEHE_CHAIN_ONLY`` whose arithmetic is stubbed out),
prints ptxas's registers and spills and the compile seconds, holds the kernel
against its plain PyTorch version on every case of ``chip_smoke.epoch_cases``
(twice: the second run must give the same bits), and at the main shape (the
quick-start model, 32 steps of 512) times one epoch, splits a step by stage
and times the chain with the arithmetic stubbed out. ``--cluster 1,2,4``
repeats that with the thread-block cluster forced to each size,
``--skip-cases`` leaves the comparisons out, ``--time-cases`` times every
case's call (to hold a change against its parent: run both trees one after
the other on one card), ``--train-split`` runs the quick-start ``train()`` (100 epochs of 32
steps of 512) with timers around its stages. It asserts nothing: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernel to its tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_epoch_gpu.py
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import statistics
import subprocess
import sys

import torch

import chip_smoke
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe

TOL = chip_smoke.TOL_EPOCH
VARIANTS = {"plain": (), "stamps": ("-DEHE_STAMPS",), "chain": ("-DEHE_CHAIN_ONLY",)}


class AloneLibrary:
    """The plain build of ``fused_epoch.cu`` in the place of the package's
    library, which would take every other kernel's build as well."""

    def __init__(self, lib):
        self.eh_fused_epoch = lib.eh_fused_epoch
        self.eh_fused_epoch_args_size = lib.eh_fused_epoch_args_size

    @staticmethod
    def eh_cuda_error_string(rc):
        return f"CUDA error {rc}".encode()


def build_all():
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda d: _build.build_variant("fused_epoch.cu", d), VARIANTS.values())))
    for name, result in built.items():
        print(f"nvcc {name}: {result.seconds:.1f} s")
    keep = ("registers", "spill", "warning")
    print("\n".join(l.strip() for l in built["plain"].log.splitlines() if any(k in l for k in keep)))


def check(what, fn, p0, tensors, perms):
    """Kernel against plain version: misses beyond ``TOL * max(1, |ref|)``
    per vector, and whether a second run gives the same bits."""
    got_p, got_o, got_l = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    torch.cuda.synchronize()
    again_p, again_o, again_l = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref_p, ref_o, ref_l = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    same = all(torch.equal(a, b) for a, b in (
        (got_p.params, again_p.params), (got_p.bn, again_p.bn), (got_o["m"], again_o["m"]),
        (got_o["v"], again_o["v"]), (got_l, again_l)))
    nb, batch = (int(v) for v in tensors.weight.shape)
    out = [what, "| geometry", fn.plan.geometry(batch), "| same bits", same, "t", int(got_o["t"]),
           int(ref_o["t"]), "loss", float(got_l), float(ref_l)]
    for name, g, r in (("p", got_p.params, ref_p.params), ("bn", got_p.bn, ref_p.bn),
                       ("m", got_o["m"], ref_o["m"]), ("v", got_o["v"], ref_o["v"])):
        if not g.numel():
            continue
        d = (g - r).abs()
        miss = d > TOL * r.abs().clamp_min(1.0)
        out += [name, f"max {float(d.max()):.3e}", f"miss {int(miss.sum())}/{d.numel()}"]
        if name == "p" and int(miss.sum()):
            out += ["by leaf", {k: int((v > TOL).sum()) for k, v in fn.plan.leaves(d).items()
                                if int((v > TOL).sum())}]
    print(*out, flush=True)


def time_case(what, fn, p0, tensors, perms):
    opt0 = fe.init_fused_opt_state(p0)
    call = lambda: fn(p0, opt0, tensors, perms=perms)
    chip_smoke.host_ms(call, 3)
    ms = [chip_smoke.device_ms(call, 10, what) for _ in range(5)]
    nb, batch = (int(v) for v in tensors.weight.shape)
    print(f"time | {what} | {fn.epochs} x {nb} steps of {batch}: device ms a call, median of 5 "
          f"{statistics.median(ms):.4f} (min {min(ms):.4f}, max {max(ms):.4f})", flush=True)


def time_main_shape(case, cluster):
    what, fn, p0, tensors, perms = chip_smoke.prepare_epoch_case(et, fe, **{**case, "epochs": 1})
    if cluster:
        fn.plan = dataclasses.replace(fn.plan, cluster=cluster)
    opt0 = fe.init_fused_opt_state(p0)
    nb, batch = (int(v) for v in tensors.weight.shape)
    print(f"main shape: {nb} steps of {batch}, geometry {fn.plan.geometry(batch)}")
    call = lambda: fn(p0, opt0, tensors, perms=perms)
    chip_smoke.host_ms(call, 3)
    ms = statistics.median(chip_smoke.device_ms(call, 20, "kernel 2") for _ in range(5))
    print(f"epoch: device ms {ms:.4f}, {ms / nb * 1e3:.2f} us a step")
    cycles = fe.stage_cycles(fn, p0, opt0, tensors, perms)
    cycles = fe.stage_cycles(fn, p0, opt0, tensors, perms)  # the second launch: warm
    total = cycles.pop("kernel")
    cycles = {"gather and statistics": sum(list(cycles.values())[:4]), **cycles}
    print("per-stage split of thread 0, cycles a step (share of the launch; us a step at the "
          "plain build's time): "
          + ", ".join(f"{k} {v / nb:.0f} ({v / total:.1%}; {v / total * ms / nb * 1e3:.2f})"
                      for k, v in cycles.items())
          + f"; the launch {total} cycles")
    data = fn._make_data(fn.plan, tensors)
    rows = fn.rows(tensors, perms)
    loss = torch.empty((1,), dtype=torch.float32, device="cuda")
    chain_lib = _build.measuring_library("fused_epoch.cu", "eh_fused_epoch", *VARIANTS["chain"])

    def chain():
        packed = fe.FusedParams(p0.params.clone(), p0.bn.clone())
        fe.launch_fused_epoch(fn.plan, packed, {k: v.clone() for k, v in opt0.items()}, data,
                              rows, loss, lib=chain_lib)

    chip_smoke.host_ms(chain, 3)
    floor = statistics.median(chip_smoke.device_ms(chain, 20, "chain") for _ in range(5))
    print(f"the chain with its arithmetic stubbed out (barriers, exchanges and staging only): "
          f"device ms {floor:.4f} an epoch, {floor / nb * 1e3:.2f} us a step")


def train_split():
    """Wall seconds of one quick-start ``train()`` and of its stages, each
    closed by a device synchronisation: the gate, the kernel calls (launch
    and wait), ``unpack``, the evaluations. ``tools/dev_train_loop_gpu.py``
    splits both loops without synchronising."""
    import time

    from easyhybrid_tpu_torch.training import train as train_module

    spent = {"gate": 0.0, "kernel calls (launch and wait)": 0.0, "unpack": 0.0, "evaluation": 0.0}
    calls = dict.fromkeys(spent, 0)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return wrapper

    real = (train_module.fused_exactness_check, fe.FusedEpoch.__call__, fe.PackedLayout.unpack,
            train_module.make_dual_evaluator)
    gate = timed("gate", real[0])
    in_gate = []

    def gate_apart(*args, **kwargs):  # the gate's own kernel calls count as the gate
        in_gate.append(True)
        try:
            return gate(*args, **kwargs)
        finally:
            in_gate.pop()

    kernel = timed("kernel calls (launch and wait)", real[1])
    train_module.fused_exactness_check = gate_apart
    fe.FusedEpoch.__call__ = lambda self, *a, **k: (real[1] if in_gate else kernel)(self, *a, **k)
    fe.PackedLayout.unpack = timed("unpack", real[2])
    train_module.make_dual_evaluator = lambda *a, **k: timed("evaluation", real[3](*a, **k))
    try:
        for run in ("first", "second"):
            for k in spent:
                spent[k], calls[k] = 0.0, 0
            model = chip_smoke.build_model(et, norm=True, seed=0)
            cols = et.rbq10_columns(chip_smoke.TRAIN_ROWS, seed=42)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = et.train(model, cols, **chip_smoke.TRAIN_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"train() {run} call: {result.epoch_path}, {wall:.3f} s wall (with the timers' "
                  "synchronisations): "
                  + ", ".join(f"{k} {v:.3f} s in {calls[k]} calls ({v / max(calls[k], 1) * 1e3:.2f} ms "
                              "each)" for k, v in spent.items())
                  + f"; the rest {wall - sum(spent.values()):.3f} s")
    finally:
        (train_module.fused_exactness_check, fe.FusedEpoch.__call__, fe.PackedLayout.unpack,
         train_module.make_dual_evaluator) = real


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cluster", default="0", help="sizes to force, e.g. 1,2,4 (0: the plan's)")
    parser.add_argument("--skip-cases", action="store_true")
    parser.add_argument("--time-cases", action="store_true")
    parser.add_argument("--train-split", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_epoch_gpu: needs a CUDA GPU")
    build_all()
    alone = AloneLibrary(_build.measuring_library("fused_epoch.cu", "eh_fused_epoch"))
    _build.load_library = lambda: alone
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cases = chip_smoke.epoch_cases(et, et.rbq10_columns(chip_smoke.TRAIN_ROWS, seed=42))
    if not args.skip_cases:
        for case in cases:
            check(*chip_smoke.prepare_epoch_case(et, fe, **case))
    if args.time_cases:
        for case in cases:
            time_case(*chip_smoke.prepare_epoch_case(et, fe, **case))
    for cluster in args.cluster.split(","):
        time_main_shape(cases[0], int(cluster))
    if args.train_split:
        train_split()


if __name__ == "__main__":
    main()
