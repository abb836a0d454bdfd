"""The MultiNN family on kernel 2 on a CUDA GPU: a quick loop for work on
kernel 2's branch view (``csrc/fused_epoch.cu``'s networks, ``EhNet``).

Builds the package's library and, all at once beside it, kernel 2's build of
several networks (``fused_epoch_multinn.cu``) against the exponential and
two-output forms (``chip_smoke.TRACED_BUILDS``),
then runs ``chip_smoke.py``'s phase 25 (the MultiNN and globals-only cases
against the plain version, twice), ``--main`` its phase 26 (the ExpoHybrid
``train()``) and ``--times`` its phase 27 (the ExpoHybrid epoch beside the
quick-start's). ``--parent DIR`` (a copy of another tree, e.g. the parent
commit unpacked with ``git archive`` into the ignored ``chip_work/``) first
times kernel 2's quick-start epoch (32 steps of 512, adam, trainable BN) in
both trees, each in a process of its own through that tree's
``tools/dev_fused_losses_gpu.py --mse-epoch``, in turns (the parent, this,
this, the parent): the check that the one-network kernel did not move.
``--trees DIR,DIR,...`` runs, for each tree in a process of its own, in
turns (forward, then backward), kernel 2's epoch (the quick-start's 32 steps
of 512, adam, trainable BN) at other widths and losses (``EPOCH_CASES``: the
builds of other widths and losses than the main path's), and on each tree's
first turn its builds' registers and spills, kernel by kernel
(``fused_epoch.cu``, and ``fused_epoch_multinn.cu`` where the tree has it).

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_fused_multinn_gpu.py [--main] [--times] [--parent DIR]
        [--trees DIR,DIR]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch


# (hidden layers, training loss): kernel 2's builds by width (16, 32, 64) and by loss
EPOCH_CASES = [((16, 16), "mse"), ((16, 16), "nseLoss"), ((32, 24), "rmse"), ((32, 24), "kgeLoss"),
               ((64, 48), "mse"), ((64, 48), "nseLoss"), ((64, 48), "rmse")]
BUILDS = {"0": "mse", "1": "rows", "2": "moments"}  # eh_fused_epoch_kernel<W, LOSSES, MULTI>


def epoch_times(first: bool) -> None:
    """This tree's kernel-2 epoch at each of ``EPOCH_CASES``: device ms,
    median of 5; with ``first``, its build's registers and spills by kernel."""
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    tree = os.getcwd()
    if first:
        entry = ""
        log = "".join(_build.build_variant(src, ("-DEH_PTXAS_PROBE",)).log
                      for src in ("fused_epoch.cu", "fused_epoch_multinn.cu")
                      if (Path(_build.__file__).parent.parent / "csrc" / src).is_file())
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                w = re.search(r"eh_fused_epoch_kernelILi(\d+)ELi(\d+)E(Lb1)?", m.group(1))
                entry = (f"W {w.group(1)}, {BUILDS[w.group(2)]}{', networks' if w.group(3) else ''}"
                         if w else m.group(1))
            elif entry and ("registers" in line or "spill" in line):
                print(f"ptxas | {tree} | {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
    base = cs.epoch_cases(et, et.rbq10_columns(cs.TRAIN_ROWS, seed=42))[0]
    for hidden, loss in EPOCH_CASES:
        _, fn, packed, tensors, perms = cs.prepare_epoch_case(
            et, fe, **{**base, "hidden": hidden, "epochs": 1, "loss": loss})
        opt0 = fe.init_fused_opt_state(packed)

        def call():
            return fn(packed, opt0, tensors, perms=perms)

        cs.host_ms(call, 3)
        ms = statistics.median(cs.device_ms(call, 20, "kernel 2") for _ in range(5))
        print(f"epoch | {tree} | {list(hidden)} {loss}: {ms:.4f} ms", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--main", action="store_true", help="run phase 26")
    parser.add_argument("--times", action="store_true", help="run phase 27")
    parser.add_argument("--parent", default="", help="time kernel 2's quick-start epoch there too")
    parser.add_argument("--trees", default="", help="trees whose EPOCH_CASES to time, in turns")
    parser.add_argument("--epoch-times", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_multinn_gpu: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.epoch_times:
        epoch_times(args.epoch_times == "first")
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args.trees:
        trees = [Path(t).resolve() for t in args.trees.split(",")]
        for i, tree in enumerate(trees + trees[::-1]):
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--epoch-times",
                            "first" if i < len(trees) else "again"], check=True, cwd=tree,
                           env={**os.environ, "PYTHONPATH": str(tree)})
        return
    if args.parent:
        here = Path(__file__).resolve().parent.parent
        parent = Path(args.parent).resolve()
        for tree in (parent, here, here, parent):
            subprocess.run([sys.executable, "tools/dev_fused_losses_gpu.py", "--mse-epoch"],
                           check=True, cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)})
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build

    models = cs.traced_models(et)
    forms = cs.traced_forms(et, models)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = {key: pool.submit(_build.form_build, "fused_epoch_multinn.cu", forms[key])
                  for key in cs.TRACED_BUILDS["fused_epoch_multinn.cu"]}
        built = _build.build_library()
        print(f"library: {built.seconds:.1f} s; "
              + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(built.source_seconds.items())),
              flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
        for key, fut in builds.items():
            result = fut.result()
            print(f"fused_epoch_multinn.cu against the {key} form: {result.seconds:.1f} s",
                  flush=True)
            for line in result.log.splitlines():
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    print("  " + line.strip(), flush=True)
    _build.load_library()
    mn = cs.multinn_models(et, models)
    print(f"phase 25: worst |kernel - plain| {cs.multinn_kernel_checks(et, mn):.3e}", flush=True)
    if args.main:
        cs.multinn_main_path(et, card, mn)
    if args.times:
        cs.multinn_times(et, card, mn)


if __name__ == "__main__":
    main()
