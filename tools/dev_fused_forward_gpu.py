"""Kernel 1 (``easyhybrid_tpu_torch/csrc/fused_forward.cu``) and the serving
path around it alone on a CUDA GPU: a quick loop for work on either.

Compiles only ``fused_forward.cu`` (a few seconds of ``nvcc``), then at the
serving cell's shape (the quick-start model, 131,072 rows of
``rbq10_columns(seed=42)``) times the kernel per launch at 1,024 and at
131,072 rows (events behind a sleep kernel), and ``predict`` from host
columns at ``batch_size`` 1,024 and 131,072: wall ms and rows/s a call (median
of ``--calls`` a round), launches and host-device copies a call, the device's
busy share (the device activities' time in a call traced by
``torch.profiler`` over the median untraced call's wall), and this tree's
``predict`` cut into stages (``prepare_data``, copies in, launch, copies out).
Each ``--parent DIR`` (a copy of another tree, e.g. unpacked from ``git
archive`` into the ignored ``chip_work/``) is timed the same way on that
tree's package, one process a tree and round, the trees in turn forward and
backward over ``--rounds`` rounds, so all stand side by side from one card;
the summary gives each tree's median over every round. It asserts nothing:
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel to its
tolerance.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_forward_gpu.py [--parent DIR]... [--rounds R] [--calls C]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_forward as ff


class AloneLibrary:
    """The build of ``fused_forward.cu`` in the place of the package's
    library, which would take every kernel's build."""

    def __init__(self, lib):
        self.eh_fused_forward = lib.eh_fused_forward
        self.eh_fused_forward_args_size = lib.eh_fused_forward_args_size
        self.eh_cuda_error_string = lib.eh_cuda_error_string


def build_alone(tag: str) -> None:
    built = _build.build_variant("fused_forward.cu", ())
    print(f"[{tag}] nvcc fused_forward.cu: {built.seconds:.1f} s", flush=True)
    for line in built.log.splitlines():
        if any(k in line for k in ("registers", "spill")):
            print(f"[{tag}]   {line.strip()}")
    lib = ctypes.CDLL(str(built.path))
    lib.eh_fused_forward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.eh_fused_forward.restype = ctypes.c_int
    lib.eh_fused_forward_args_size.restype = ctypes.c_int
    lib.eh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    alone = AloneLibrary(lib)
    _build.load_library = lambda: alone


def predict_split(model, cols, batch: int) -> str:
    """This tree's fused ``predict`` (``FusedForward.table``) cut into its
    stages, each timed on its own after a synchronize (median of 7):
    ``prepare_data``, the copies in (each input array into its padded
    device buffer), the launch over every chunk and the copies out."""
    from easyhybrid_tpu_torch.data.prepare import prepare_data

    fused = et.make_fused_forward(model, batch_size=batch)
    hd = prepare_data(model, cols, drop_missing_rows=False)
    x, forcing = hd.x, {k: hd.forcing[k] for k in fused.plan.forcing_names}
    n = x.shape[0]
    padded = max(1, -(-n // batch)) * batch

    def rows(a):
        return ff.padded_rows(a, padded, "cuda")

    xd, fd = rows(x), {k: rows(v) for k, v in forcing.items()}
    out = fused(xd, fd)
    stages = {
        "prepare_data": lambda: prepare_data(model, cols, drop_missing_rows=False),
        "copies in": lambda: (rows(x), [rows(v) for v in forcing.values()]),
        "launch": lambda: fused(xd, fd),
        "copies out": lambda: [v[:n].cpu() for v in out.values()],
    }
    ms = {k: statistics.median(chip_smoke.host_ms(f, 1) for _ in range(7)) for k, f in stages.items()}
    return ", ".join(f"{k} {v:.3f}" for k, v in ms.items())


def side(tag: str, calls: int) -> None:
    build_alone(tag)
    n = chip_smoke.N_ROWS
    cols = et.rbq10_columns(n, seed=42)
    model = chip_smoke.build_model(et)
    x, forcing = chip_smoke.to_device(et, model, cols)
    result = {}
    for rows in (1024, n):
        fn = et.make_fused_forward(model, batch_size=rows)
        xs, fs = x[:rows].contiguous(), {k: v[:rows].contiguous() for k, v in forcing.items()}
        call = lambda: fn(xs, fs)  # noqa: E731
        chip_smoke.host_ms(call, 3)
        ms = [chip_smoke.device_ms(call, 50, "kernel 1") for _ in range(7)]
        result[f"kernel {rows}"] = ms
        print(f"[{tag}] kernel 1, one launch over {rows} rows: device ms, median of 7, "
              f"{statistics.median(ms):.5f} (min {min(ms):.5f}, max {max(ms):.5f})", flush=True)
    from torch.profiler import ProfilerActivity, profile

    for batch in (1024, n):
        fn = et.make_inference_fn(model, batch_size=batch)
        fn(cols)  # warm-up
        walls = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(cols)
            walls.append((time.perf_counter() - t0) * 1e3)
        result[f"predict {batch}"] = walls
        before = ff.launch_fused_forward.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(cols)
            torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        copies = sum(e.count for e in events if "Memcpy" in e.key)
        wall = statistics.median(walls)
        print(f"[{tag}] predict, {n} rows at batch_size {batch}: wall ms a call, median of "
              f"{calls}, {wall:.3f} (min {min(walls):.3f}, max {max(walls):.3f}), "
              f"{n / wall * 1e3:,.0f} rows/s; {ff.launch_fused_forward.launches - before} "
              f"launches and {copies} host-device copies a call; device busy {busy:.3f} ms, "
              f"{busy / wall:.1%} of the median call (a traced call took {traced:.3f} ms)",
              flush=True)
        if tag == "change":
            print(f"[{tag}] predict at batch_size {batch}, its stages alone, wall ms, median "
                  f"of 7: {predict_split(model, cols, batch)}", flush=True)
    print("RESULT " + json.dumps(result), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", action="append", default=[],
                        help="a copy of another tree to time as well (repeatable)")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds over the trees, in turn forward and backward")
    parser.add_argument("--calls", type=int, default=21, help="predict calls a round")
    parser.add_argument("--side", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_forward_gpu: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.side:
        side(args.side, args.calls)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    here = Path(__file__).resolve()
    trees = {"change": Path.cwd()}
    trees.update({f"parent {i}" if len(args.parent) > 1 else "parent": Path(p).resolve()
                  for i, p in enumerate(args.parent)})
    samples = {tag: {} for tag in trees}
    for r in range(args.rounds):
        for tag in (list(trees) if r % 2 == 0 else list(reversed(list(trees)))):
            # each tree runs this file's own side, on its own package
            proc = subprocess.run(
                [sys.executable, str(here), "--side", tag, "--calls", str(args.calls)],
                check=True, cwd=trees[tag], capture_output=True, text=True,
                env={**os.environ, "PYTHONPATH": str(trees[tag])})
            for line in proc.stdout.splitlines():
                if line.startswith("RESULT "):
                    for k, v in json.loads(line[7:]).items():
                        samples[tag].setdefault(k, []).extend(v)
                else:
                    print(f"(round {r}) {line}", flush=True)
    n = chip_smoke.N_ROWS
    for k in next(iter(samples.values())):
        print(f"over {args.rounds} rounds, {k}: " + "; ".join(
            f"{tag} median {statistics.median(v[k]):.5f} min {min(v[k]):.5f}"
            + (f" ({n / statistics.median(v[k]) * 1e3:,.0f} rows/s)" if k.startswith("predict")
               else "")
            for tag, v in samples.items() if k in v), flush=True)


if __name__ == "__main__":
    main()
