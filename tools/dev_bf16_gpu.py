"""The bf16 builds of kernels 1-3 (``compute_dtype=torch.bfloat16``) on a CUDA
GPU: a quick loop for work on them.

Builds, all at once, each kernel's bf16 build (``-DEH_BF16``,
``chip_smoke.BF16_BUILDS``) and the ExpoHybrid model's traced form, then runs
``chip_smoke.py``'s phase 45 (each bf16 build against its plain version on
the card, twice; ``--only`` keeps the kernels named, of ``forward``,
``epoch``, ``wide``), ``--main`` its phase 46 (the bf16 paths through
``train()`` and ``predict``) and ``--times`` its phase 47 (each bf16 build
beside its float32 build in one call; this builds the package's library
too). A failed case is printed and the others still run.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_bf16_gpu.py [--only forward,epoch,wide] [--main] [--times]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import subprocess
import sys
import time

import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="forward,epoch,wide",
                        help="phase 45's kernels to hold (comma-separated)")
    parser.add_argument("--main", action="store_true", help="run phase 46")
    parser.add_argument("--times", action="store_true", help="run phase 47")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_bf16_gpu: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops import fused_forward as ff

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    models = cs.traced_models(et)
    forms = cs.traced_forms(et, models)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        builds = cs.start_bf16_builds(pool, forms)
        builds["fused_epoch_multinn.cu against the expo form"] = pool.submit(
            _build.form_build, "fused_epoch_multinn.cu", forms["expo"])
        library = pool.submit(_build.build_library) if args.times or args.main else None
        for key, fut in builds.items():
            result = fut.result()
            print(f"{key}: nvcc {result.seconds:.1f} s", flush=True)
            for line in result.log.splitlines():
                if "registers" in line or "spill" in line:
                    print("  " + line.strip()[:200], flush=True)
        if library is not None:
            print(f"library: {library.result().seconds:.1f} s", flush=True)
    print(f"builds: {time.perf_counter() - t0:.1f} s wall", flush=True)

    def attempt(what, fn, *a):
        try:
            return fn(*a)
        except (AssertionError, RuntimeError) as e:
            print(f"FAILED {what}: {e}", flush=True)

    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    wide_cols = et.rbq10_columns(cs.WIDE_ROWS, seed=42)
    train_cols = {k: v[: cs.WIDE_ROWS * 4 // 5] for k, v in wide_cols.items()}
    tutorial_cols = cs.tutorial_columns(et)
    mn = cs.multinn_models(et, models)
    only = args.only.split(",")
    t0 = time.perf_counter()
    if "forward" in only:
        attempt("kernel 1", cs.bf16_forward_checks, et, ff)
    if "epoch" in only:
        attempt("kernel 2", cs.bf16_epoch_checks, et, quick_cols, mn)
    if "wide" in only:
        for case in cs.bf16_wide_cases(et, train_cols, tutorial_cols):
            attempt(case["what"], cs.wide_kernel_checks, et, None, [case], "kernel3-bf16")
    print(f"phase 45: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.main:
        t0 = time.perf_counter()
        attempt("phase 46", cs.bf16_main_paths, et, ff, card, quick_cols, tutorial_cols, mn)
        print(f"phase 46: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.times:
        t0 = time.perf_counter()
        attempt("phase 47", cs.bf16_times, et, card, quick_cols, train_cols, tutorial_cols, mn)
        print(f"phase 47: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
