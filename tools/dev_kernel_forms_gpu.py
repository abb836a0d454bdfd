"""Traced kernel forms on a CUDA GPU: what a form costs to build, and the
bits of the hand-written rbq10 form against another tree.

For this tree, and with ``--parent DIR`` for a copy of another (e.g. the
parent commit unpacked with ``git archive`` into the ignored ``chip_work/``),
each in a process of its own with that tree's package and ``chip_smoke.py``,
in turns (the parent, this, this, the parent; ``--rounds``):

* builds the package's library into a fresh directory and prints each
  source's ``nvcc`` seconds (one process per source, all at once, as
  ``train()`` and ``predict`` build it);
* on this tree, builds every source a traced form runs against the forms of
  ``chip_smoke.py``'s traced phases (``TRACED_BUILDS``: one process per
  build, all at once, into the same fresh directory) and prints each one's
  seconds;
* on the first turn of each tree, runs every ``chip_smoke.py`` case of
  kernel 1 (phase 3's serving cases) and of kernels 2-5 (``epoch_cases``,
  ``wide_cases``, ``lstm_cases``, ``multisite_cases``, every optimizer rule)
  on the hand-written ``et.rbq10`` form and keeps the results; the cases both
  trees have are then held bit for bit (outputs; parameters, BatchNorm
  statistics, every optimizer slot, step count, loss). Differing bits exit
  non-zero.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_kernel_forms_gpu.py [--parent DIR] [--rounds 2]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def forward_cases(cs, et):
    """Phase 3's kernel-1 cases: ``(what, model, x, forcing, batch)``."""
    cases = []
    cols = et.rbq10_columns(cs.N_ROWS, seed=42)
    quick = cs.build_model(et)
    cases.append(("quick-start N=131072", quick, *cs.to_device(et, quick, cols), cs.BATCH))
    m = cs.build_model(et, hidden=(8,), activation="tanh", norm=False, seed=1)
    cases.append(("[8] tanh no norm", m, *cs.to_device(et, m, et.rbq10_columns(1000, seed=1)),
                  cs.BATCH))
    odd = et.rbq10_columns(777, seed=2)
    for i, act in enumerate(sorted(et.ACTIVATIONS)):
        m = cs.build_model(et, hidden=(12, 5), activation=act, seed=10 + i)
        cases.append((f"[12,5] {act}", m, *cs.to_device(et, m, odd), 256))
    for hidden in ((24, 32), (64, 48)):
        m = cs.build_model(et, hidden=hidden, activation="selu", seed=3)
        cases.append((f"{list(hidden)} selu", m, *cs.to_device(et, m, odd), cs.BATCH))
    m = cs.build_model(et, hidden=(16, 16), seed=4,
                       parameters={**cs.RBQ10_PARAMS, "tref": (15.0, 0.0, 30.0)},
                       neural_param_names=["Q10"], global_param_names=["rb"])
    cases.append(("neural Q10, global rb, fixed tref", m, *cs.to_device(et, m, odd), cs.BATCH))
    nan_cols = et.rbq10_columns(4096, seed=5)
    nan_cols["sw_pot"][np.random.default_rng(5).random(4096) < 0.05] = np.nan
    m = cs.build_model(et, seed=5)
    cases.append(("5% NaN predictor rows", m, *cs.to_device(et, m, nan_cols), cs.BATCH))
    for hidden in ((16, 16), (24, 32), (64, 48)):
        m = cs.build_model(et, hidden=hidden, seed=6)
        for n in (1, 1023, 1024, 1025, cs.N_ROWS):
            edge = et.rbq10_columns(n, seed=6)
            edge["sw_pot"][5::97] = np.nan
            edge["dsw_pot"][n - 1] = np.nan if n > 1 else edge["dsw_pot"][0]
            cases.append((f"{list(hidden)} N={n}", m, *cs.to_device(et, m, edge), cs.BATCH))
    return cases


def case_results(cs, et) -> dict:
    """Every kernel-1 case's outputs and every kernels 2-5 case's results."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    out = {}
    for what, model, x, forcing, batch in forward_cases(cs, et):
        got = et.make_fused_forward(model, batch_size=batch)(x, forcing)
        out[("kernel 1", what)] = [got[k].cpu() for k in sorted(got)]
    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    wide_cols = et.rbq10_columns(cs.WIDE_ROWS, seed=42)
    wide_train = {k: v[: cs.WIDE_ROWS * 4 // 5] for k, v in wide_cols.items()}
    groups = [
        ("kernel 2", cs.epoch_cases(et, quick_cols), lambda c: cs.prepare_epoch_case(et, fe, **c)),
        ("kernel 3", cs.wide_cases(et, wide_train), lambda c: cs.prepare_wide_case(et, **c)),
        ("kernel 4", cs.lstm_cases(), lambda c: cs.prepare_lstm_case(et, **c)),
        ("kernel 5", cs.multisite_cases(), lambda c: cs.prepare_multisite_case(et, **c)),
    ]
    for name, cases, prepare in groups:
        for case in cases:
            what, fn, packed, tensors, perms = prepare(case)
            p, o, loss = fn(packed, cs.fresh_state(fn, packed), tensors, perms=perms)
            torch.cuda.synchronize()
            out[(name, what)] = [p.params.cpu(), p.bn.cpu(),
                                 *(o[k].cpu() for k in sorted(o)), loss.cpu()]
    return out


def side(args) -> None:
    """One tree's turn, in its own process with its own package."""
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build

    tag = args.side
    with tempfile.TemporaryDirectory() as fresh:
        _build._BUILD_DIR = Path(fresh)
        built = _build.build_library()
        print(f"[{tag}] nvcc, one process per source in parallel, {built.seconds:.1f} s in all: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(built.source_seconds.items())),
              flush=True)
        _build.load_library()
        if hasattr(cs, "TRACED_BUILDS"):
            models = cs.traced_models(et)
            forms = cs.traced_forms(et, models)
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                builds = cs.start_traced_builds(pool, forms)
                for (src, key), fut in builds.items():
                    print(f"[{tag}] nvcc, {src} against the traced form of {key} "
                          f"({forms[key].name}), all {len(builds)} at once: "
                          f"{fut.result().seconds:.1f} s", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.results:
            torch.save(case_results(cs, et), args.results)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default="", help="a copy of another tree to run as well")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--side", default="", help=argparse.SUPPRESS)
    parser.add_argument("--results", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_kernel_forms_gpu: needs a CUDA GPU")
    if args.side:
        side(args)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"this": Path(__file__).resolve().parent.parent}
    if args.parent:
        trees = {"parent": Path(args.parent).resolve(), **trees}
    with tempfile.TemporaryDirectory() as tmp:
        files = {tag: str(Path(tmp) / f"{tag}.pt") for tag in trees}
        order = []
        for r in range(args.rounds):
            order += list(trees) if r % 2 == 0 else list(trees)[::-1]
        seen = set()
        for tag in order:
            keep = tag not in seen and len(trees) > 1
            seen.add(tag)
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", tag,
                            "--results", files[tag] if keep else ""],
                           check=True, cwd=trees[tag], env={**os.environ,
                                                            "PYTHONPATH": str(trees[tag])})
        if len(trees) == 1:
            return
        mine, theirs = torch.load(files["this"]), torch.load(files["parent"])

        def same(a, b):
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            return a.shape == b.shape and torch.equal(a, b)

        shared = [k for k in theirs if k in mine]
        differ = [k for k in shared if len(mine[k]) != len(theirs[k])
                  or not all(same(a, b) for a, b in zip(mine[k], theirs[k]))]
        for name in ("kernel 1", "kernel 2", "kernel 3", "kernel 4", "kernel 5"):
            n = sum(k[0] == name for k in shared)
            bad = [k[1] for k in differ if k[0] == name]
            print(f"bits | {name}: {n} cases of both trees, "
                  + ("the same bits in every one" if not bad else f"OTHER BITS in {bad}"),
                  flush=True)
        missing = [k for k in theirs if k not in mine]
        if missing:
            print(f"bits | cases of the parent this tree lacks: {missing}", flush=True)
        if differ:
            sys.exit(1)


if __name__ == "__main__":
    main()
