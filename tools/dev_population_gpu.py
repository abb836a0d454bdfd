"""Kernel 2's member axis and the population paths on a CUDA GPU: a quick
loop for work on population training.

Builds the package's library and, beside it, ``fused_epoch_multinn.cu``
against the exponential model's traced form (phase 31's ExpoHybrid case),
then runs ``chip_smoke.py``'s phase 31 (the member axis against its plain
version, every member against a launch of it alone) and phase 32 (the JAX
bench's population runs through ``population_train`` /
``population_cross_validate``, their walls and kernel 2's launch at K = 1
and K = 16).

``--parent DIR`` (a copy of another tree, e.g. the parent commit unpacked
with ``git archive`` into the ignored ``chip_work/``) first holds kernel 2's
one-model launch (``train()``'s) against that tree's: each tree, in a
process of its own, runs ``chip_smoke.py``'s kernel-2 cases (phase 6's
``epoch_cases``, every optimizer rule; the quick-start under every loss the
hand-written form trains; the globals-only and ExpoHybrid MultiNN cases of
phase 25) and saves every result, which must agree bit for bit; and times
the quick-start epoch at the main shape (32 steps of 512, adam, trainable
BN) in turns, the parent, this, this, the parent.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_population_gpu.py [--parent DIR] [--skip-phases]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

LOSSES = ("mae", "nseLoss", "rmse", "pearsonLoss", "kgeLoss", "pbkgeLoss")


def epoch_bits(out: str, timing_only: bool) -> None:
    """One tree's kernel-2 results on its chip_smoke cases (saved to
    ``out``) and its quick-start epoch's device ms, median of 5."""
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    main = {**cs.epoch_cases(et, quick_cols)[0], "epochs": 1}
    if not timing_only:
        models = cs.traced_models(et)
        forms = cs.traced_forms(et, models)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            expo = pool.submit(_build.form_build, "fused_epoch_multinn.cu", forms["expo"])
            _build.build_library()
            expo.result()
        _build.load_library()
        results = {}

        def run(what, fn, packed, tensors, perms):
            state = cs.fresh_state(fn, packed)
            p, o, loss = fn(packed, state, tensors, perms=perms)
            results[what] = {"params": p.params.cpu(), "bn": p.bn.cpu(),
                             **{k: v.cpu() for k, v in o.items()}, "loss": loss.reshape(1).cpu()}

        for case in cs.epoch_cases(et, quick_cols):
            run(*cs.prepare_epoch_case(et, fe, **case))
        for loss in LOSSES:
            what, *rest = cs.prepare_epoch_case(et, fe, **{**cs.epoch_cases(et, quick_cols)[0],
                                                           "loss": loss})
            run(f"{what} [{loss}]", *rest)
        mn = cs.multinn_models(et, models)
        quick = et.split_data(quick_cols, mn["globals_only"]())[0]
        expo_data = et.split_data(cs.expo_columns(cs.TRAIN_ROWS, seed=42), mn["expo"]())[0]
        for what, key, data, kw in (
                ("globals only, batch 512", "globals_only", quick,
                 dict(opt=("adam", 0.05), batch=512)),
                ("globals only, batch 1000", "globals_only", quick,
                 dict(opt=("adam", 0.05), batch=1000)),
                ("ExpoHybrid, batch 512, adamw, nseLoss", "expo", expo_data,
                 dict(opt=("adamw", 0.01), batch=512, loss="nseLoss"))):
            fn, packed, tensors, perms = cs.epoch_inputs(et, mn[key](), data,
                                                         make=et.make_fused_epoch, epochs=2,
                                                         shuffle=True, **kw)
            run(f"MultiNN {what}", fn, packed, tensors, perms)
        torch.save(results, out)
    what, fn, packed, tensors, perms = cs.prepare_epoch_case(et, fe, **main)
    opt0 = fe.init_fused_opt_state(packed)
    call = lambda: fn(packed, opt0, tensors, perms=perms)  # noqa: E731
    cs.host_ms(call, 3)
    ms = statistics.median(cs.device_ms(call, 20, "kernel 2") for _ in range(5))
    print(f"quick-start epoch | {os.getcwd()}: {ms:.4f} ms ({what})", flush=True)


def hold_parent(parent: Path) -> None:
    here = Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory() as tmp:
        saved = {}
        for i, tree in enumerate((parent, here, here, parent)):
            out = str(Path(tmp) / f"{i}.pt")
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--epoch-bits", out]
                           + (["--timing-only"] if i >= 2 else []),
                           check=True, cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)})
            if i < 2:
                saved[tree] = torch.load(out)
        a, b = saved[parent], saved[here]
        shared = [k for k in a if k in b]
        differ = [k for k in shared
                  if set(a[k]) != set(b[k]) or not all(torch.equal(a[k][f], b[k][f]) for f in a[k])]
        print(f"kernel 2's one-model launch: {len(shared)} cases in both trees ({len(a)} in the "
              f"parent, {len(b)} here), {len(differ)} differ in their bits", flush=True)
        for k in differ:
            print(f"  differs: {k}", flush=True)
        if differ or not shared:
            sys.exit("dev_population_gpu: kernel 2's launch does not keep the parent's bits")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default="", help="hold kernel 2's launch against this tree")
    parser.add_argument("--skip-phases", action="store_true", help="skip phases 31 and 32")
    parser.add_argument("--epoch-bits", default="", help=argparse.SUPPRESS)
    parser.add_argument("--timing-only", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_population_gpu: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.epoch_bits:
        epoch_bits(args.epoch_bits, args.timing_only)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args.parent:
        hold_parent(Path(args.parent).resolve())
    if args.skip_phases:
        return
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build

    models = cs.traced_models(et)
    forms = cs.traced_forms(et, models)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        expo = pool.submit(_build.form_build, "fused_epoch_multinn.cu", forms["expo"])
        built = _build.build_library()
        print(f"library: {built.seconds:.1f} s; "
              + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(built.source_seconds.items())),
              flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
        print(f"fused_epoch_multinn.cu against the expo form: {expo.result().seconds:.1f} s",
              flush=True)
    _build.load_library()
    mn = cs.multinn_models(et, models)
    print(f"phase 31: worst |kernel - plain| {cs.member_kernel_checks(et, mn):.3e}", flush=True)
    out = cs.population_main_paths(et, card)
    print(f"phase 32: {out}", flush=True)


if __name__ == "__main__":
    main()
