"""Kernel 5 (``easyhybrid_tpu_torch/csrc/fused_multisite.cu``) alone on a CUDA
GPU: a quick loop for work on that kernel.

Compiles only ``fused_multisite.cu`` and the primitives it needs beside it
(``multisite_primitives.cu``: the per-site target counts), prints ptxas's
registers and spills and the compile seconds, holds the kernel against its
plain PyTorch version on every case of ``chip_smoke.multisite_cases`` (twice:
the second run must give the same bits), and times one step at the main
shape (8,000 sites x 64 observations) and at the minibatched one (batches of
2,560): the gradient and update kernels by name from ``torch.profiler``, and
the whole call by events. ``--stamps`` adds a build with ``-DEHM_STAMPS``
whose thread 0 of block 0 stamps every stage of a step with ``clock64()``,
and splits a step by stage. ``--epoch-bits`` runs kernel 2 (the other user of
the row code in ``csrc/eh_device.cuh``) on every case of
``chip_smoke.epoch_cases``. ``--parent DIR`` (a copy of another tree, e.g.
unpacked from ``git archive`` into the ignored ``chip_work/``) runs the same
timings first, and again last, on that tree's package, so both stand side by
side from one card; with ``--epoch-bits`` the change's kernel 2 results are
then held bit for bit against the parent's, and with ``--ms-bits`` its kernel
5 results (one model, as ``train()`` launches it) on every case of
``chip_smoke.multisite_cases``. It asserts nothing but those comparisons:
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels to their
tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_multisite_gpu.py [--parent DIR] [--stamps] [--epoch-bits]
        [--ms-bits]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_multisite as fm

SOURCES = ("fused_multisite.cu", "multisite_primitives.cu", "fused_epoch.cu")


class AloneLibrary:
    """The builds of a few sources in the place of the package's library,
    which would take every kernel's build."""

    def __init__(self, libs):
        self._libs = libs

    def __getattr__(self, name):
        for lib in self._libs:
            if hasattr(lib, name):
                return getattr(lib, name)
        raise AttributeError(name)

    @staticmethod
    def eh_cuda_error_string(rc):
        return f"CUDA error {rc}".encode()


def build_alone(tag: str) -> None:
    """Build the sources side by side and put them in the package library's
    place."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(lambda s: _build.build_variant(s, ()), SOURCES)))
    keep = ("registers", "spill", "warning", "Compiling entry")
    for name, result in built.items():
        print(f"[{tag}] nvcc {name}: {result.seconds:.1f} s", flush=True)
        if name == "fused_multisite.cu":
            print("\n".join(f"[{tag}]   {l.strip()}" for l in result.log.splitlines()
                            if any(k in l for k in keep)))
    libs = [ctypes.CDLL(str(r.path)) for r in built.values()]
    ptr, num = ctypes.c_void_p, ctypes.c_int
    for lib in libs:
        for fn in ("eh_fused_multisite", "eh_fused_epoch"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [ptr, num, ptr]
                getattr(lib, fn).restype = num
                getattr(lib, fn + "_args_size").restype = num
        if hasattr(lib, "eh_prim_site_reduce"):
            lib.eh_prim_site_reduce.argtypes = [ptr, ptr, num, num, ptr]
            lib.eh_prim_site_reduce.restype = num
    alone = AloneLibrary(libs)
    _build.load_library = lambda: alone


def check_cases(tag: str) -> None:
    """Every kernel-5 case of ``chip_smoke`` against the plain version, twice."""
    for case in chip_smoke.multisite_cases():
        what, fn, packed, tensors, perms = chip_smoke.prepare_multisite_case(et, **case)
        runs = [fn(packed, chip_smoke.fresh_state(fn, packed), tensors, perms=perms)
                for _ in range(2)]
        note = geometry_note(fn, tensors)
        ref = fn.reference(packed, chip_smoke.fresh_state(fn, packed), tensors, perms=perms)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in (
            (runs[0][0].params, runs[1][0].params), (runs[0][1]["m"], runs[1][1]["m"]),
            (runs[0][1]["v"], runs[1][1]["v"]), (runs[0][2], runs[1][2])))
        worst = max(float(((g - r).abs() / r.abs().clamp_min(1.0)).max()) for g, r in (
            (runs[0][0].params, ref[0].params), (runs[0][1]["m"], ref[1]["m"]),
            (runs[0][1]["v"], ref[1]["v"]), (runs[0][2].reshape(1), ref[2].reshape(1))))
        print(f"[{tag}] {what}: {note}; worst |diff| / max(1, |ref|) "
              f"{worst:.3e}; second run same bits {same}", flush=True)


def geometry_note(fn, tensors) -> str:
    return str(fn.geometry(tensors)) if hasattr(fn, "geometry") else "(no geometry method)"


def time_shapes(tag: str) -> None:
    """One step at the main shape and at the minibatched one: each kernel by
    name (profiler) and the whole call (events behind a sleep kernel)."""
    main = {**chip_smoke.multisite_cases()[0], "epochs": 5}
    mini = dict(what="minibatched: 10,240 sites x 64, batches of 2,560, no norm, 1 epoch",
                S=10_240, N=64, batch=2_560, epochs=1, norm=False, shuffle=True)
    for case in (main, mini):
        what, fn, packed, tensors, perms = chip_smoke.prepare_multisite_case(et, **case)
        opt0 = fe.init_fused_opt_state(packed)
        steps = case["epochs"] * int(tensors.weight.shape[0])

        def call():
            return fn(packed, opt0, tensors, perms=perms)

        chip_smoke.host_ms(call, 3)
        grad, update, whole = [], [], []
        for _ in range(5):
            split = chip_smoke.kernel_split_ms(call, 4, "eh_ms_", ("eh_ms_grad", "eh_ms_update"))
            grad.append(sum(v for k, v in split.items() if k.startswith("grad")) / steps)
            update.append(sum(v for k, v in split.items() if k.startswith("update")) / steps)
            whole.append(chip_smoke.device_ms(call, 10, "kernel 5") / steps)
        g, u = statistics.median(grad), statistics.median(update)
        print(f"[{tag}] time | {what} | {geometry_note(fn, tensors)} | device ms a step, median of "
              f"5: gradient kernel {g:.4f} + update kernel {u:.4f} = {g + u:.4f} (profiler; "
              f"min {min(a + b for a, b in zip(grad, update)):.4f}); the whole call "
              f"{statistics.median(whole):.4f} a step (events)", flush=True)


def time_stamps(tag: str) -> None:
    """A step at the main shape split by stage, from the stamped build."""
    case = {**chip_smoke.multisite_cases()[0], "epochs": 5}
    what, fn, packed, tensors, perms = chip_smoke.prepare_multisite_case(et, **case)
    opt0 = fe.init_fused_opt_state(packed)
    steps = case["epochs"] * int(tensors.weight.shape[0])
    fm.stage_cycles(fn, packed, opt0, tensors, perms)  # warm-up (and the build)
    cycles = fm.stage_cycles(fn, packed, opt0, tensors, perms)
    whole = cycles.pop("kernel")
    print(f"[{tag}] stamps | {what} | block 0's thread 0, cycles a step (share of its time): "
          + ", ".join(f"{k} {v / steps:.0f} ({v / whole:.1%})" for k, v in cycles.items())
          + f"; the block {whole / steps:.0f} cycles a step", flush=True)


def epoch_results(tag: str) -> dict:
    """Kernel 2's results on every ``chip_smoke.epoch_cases`` case."""
    out = {}
    cases = chip_smoke.epoch_cases(et, et.rbq10_columns(chip_smoke.TRAIN_ROWS, seed=42))
    for i, case in enumerate(cases):
        what, fn, packed, tensors, perms = chip_smoke.prepare_epoch_case(et, fe, **case)
        p, o, loss = fn(packed, fe.init_fused_opt_state(packed), tensors, perms=perms)
        torch.cuda.synchronize()
        out[i] = (what, [t.cpu() for t in (p.params, p.bn, o["m"], o["v"], o["t"], loss)])
    print(f"[{tag}] kernel 2: {len(out)} epoch cases run", flush=True)
    return out


def multisite_results(tag: str) -> dict:
    """Kernel 5's results, one model as ``train()`` launches it, on every
    ``chip_smoke.multisite_cases`` case."""
    out = {}
    for i, case in enumerate(chip_smoke.multisite_cases()):
        what, fn, packed, tensors, perms = chip_smoke.prepare_multisite_case(et, **case)
        p, o, loss = fn(packed, chip_smoke.fresh_state(fn, packed), tensors, perms=perms)
        torch.cuda.synchronize()
        out[i] = (what, [t.cpu() for t in (p.params, p.bn, *o.values(), loss)])
    print(f"[{tag}] kernel 5: {len(out)} multisite cases run", flush=True)
    return out


def side(tag: str, args) -> None:
    build_alone(tag)
    torch.backends.cuda.matmul.allow_tf32 = False
    if tag == "change" and not args.skip_cases:
        check_cases(tag)
    time_shapes(tag)
    if tag == "change" and args.stamps:
        time_stamps(tag)
    if args.epoch_bits_file:
        torch.save(epoch_results(tag), args.epoch_bits_file)
    if args.ms_bits_file:
        torch.save(multisite_results(tag), args.ms_bits_file)


def same_bits(mine: dict, theirs: dict) -> list:
    """The cases whose results differ in any bit."""
    return [mine[i][0] for i in mine
            if not all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                   b.view(torch.int32) if b.is_floating_point() else b)
                       for a, b in zip(mine[i][1], theirs[i][1]))]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default="", help="a copy of another tree to time as well")
    parser.add_argument("--side", default="change", help=argparse.SUPPRESS)
    parser.add_argument("--skip-cases", action="store_true")
    parser.add_argument("--stamps", action="store_true", help="split a step by stage")
    parser.add_argument("--epoch-bits", action="store_true",
                        help="kernel 2's results on chip_smoke.epoch_cases (against the parent's)")
    parser.add_argument("--epoch-bits-file", default="", help=argparse.SUPPRESS)
    parser.add_argument("--ms-bits", action="store_true",
                        help="kernel 5's results on chip_smoke.multisite_cases (against the "
                             "parent's)")
    parser.add_argument("--ms-bits-file", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_multisite_gpu: needs a CUDA GPU")
    if args.side != "change":
        side(args.side, args)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        files = {f"{side_}{kind}": str(Path(tmp) / f"{side_}{kind}.pt")
                 for side_ in ("parent", "change") for kind in ("", "_ms")}

        def parent_side(bits: bool) -> None:
            parent = Path(args.parent).resolve()
            cmd = [sys.executable, str(Path(__file__).resolve()), "--side", "parent",
                   "--epoch-bits-file", files["parent"] if bits and args.epoch_bits else "",
                   "--ms-bits-file", files["parent_ms"] if bits and args.ms_bits else ""]
            subprocess.run(cmd, check=True, cwd=parent,
                           env={**os.environ, "PYTHONPATH": str(parent)})

        if args.parent:
            parent_side(True)
        args.epoch_bits_file = files["change"] if args.epoch_bits else ""
        args.ms_bits_file = files["change_ms"] if args.ms_bits else ""
        side("change", args)
        if args.parent:
            parent_side(False)
        failed = False
        for flag, kind, what in ((args.epoch_bits, "", "kernel 2, epoch"),
                                 (args.ms_bits, "_ms", "kernel 5, multisite")):
            if flag and args.parent:
                mine = torch.load(files[f"change{kind}"])
                differ = same_bits(mine, torch.load(files[f"parent{kind}"]))
                print(f"{what.split(',')[0]} against the parent's build, {len(mine)}"
                      f"{what.split(',')[1]} cases: "
                      + ("the same bits in every case" if not differ else f"OTHER BITS in {differ}"),
                      flush=True)
                failed = failed or bool(differ)
        if failed:
            sys.exit(1)


if __name__ == "__main__":
    main()
