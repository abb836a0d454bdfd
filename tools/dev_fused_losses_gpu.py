"""The training losses of kernels 2-5 on a CUDA GPU: a quick loop for work on
the loss layer (``csrc/eh_device.cuh``'s ``ehe_loss_row`` and
``ehe_stat_loss``, kernel 2's moment exchanges).

Builds the package's library and, all at once beside it, every traced
loss's build (``chip_smoke.LOSS_BUILDS``) and the traced forms' builds
(``chip_smoke.TRACED_BUILDS``: the two-output model's cases need one), then
runs ``chip_smoke.py``'s phase 22 (every loss on its kernel against the
plain version, twice; ``--only`` keeps the cases whose entry or description
holds the text), ``--main`` its phase 23 (the losses through ``train()``)
and ``--times`` its phase 24 (kernel 2's epoch under every loss against mse
in one call). ``--parent DIR`` (a copy of another tree, e.g. the parent
commit unpacked with ``git archive`` into the ignored ``chip_work/``) times
kernel 2's mse epoch at the main shape in both trees, each in a process of
its own, in turns (the parent, this, this, the parent): the check that mse
did not move; with ``--parent-bits`` the parent's tree also runs every phase-22
case once and this tree's kernels are held bit for bit against its outputs
(a difference exits non-zero).

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_fused_losses_gpu.py [--only TEXT] [--main] [--times]
        [--parent DIR [--parent-bits]]
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


def mse_epoch_ms() -> None:
    """One tree's kernel-2 mse epoch at the main shape (the quick-start, 32
    steps of 512, adam, trainable BN): device ms, median of 5."""
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    case = {**cs.epoch_cases(et, et.rbq10_columns(cs.TRAIN_ROWS, seed=42))[0], "epochs": 1}
    what, fn, packed, tensors, perms = cs.prepare_epoch_case(et, fe, **case)
    opt0 = fe.init_fused_opt_state(packed)
    call = lambda: fn(packed, opt0, tensors, perms=perms)  # noqa: E731
    cs.host_ms(call, 3)
    ms = statistics.median(cs.device_ms(call, 20, "kernel 2") for _ in range(5))
    print(f"mse epoch | {os.getcwd()}: {ms:.4f} ms ({what})", flush=True)


def drift(cs, et, quick_cols, losses) -> None:
    """At kernel 2's main shape (the quick-start, 4 epochs of 32 steps, adam):
    the kernel, its plain version in float32, the plain version from
    parameters one ulp apart, and the plain version in float64, each pair's
    elements beyond TOL_EPOCH and largest difference."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    main = dict(cols=quick_cols, split=True, hidden=(16, 16), act="swish", seed=0, shuffle=True,
                batch=512, norm=True, opt=("adam", 0.01), epochs=4)
    for loss in losses:
        _, fn, packed, tensors, perms = cs.prepare_epoch_case(et, fe, what="",
                                                              loss=cs.loss_of(et, loss), **main)

        def named(p, o, l):
            return {"params": p.params, **fe.opt_slots(o), "loss": l.reshape(1)}

        runs = {"kernel": named(*fn(packed, cs.fresh_state(fn, packed), tensors, perms=perms)),
                "plain32": named(*fn.reference(packed, cs.fresh_state(fn, packed), tensors,
                                               perms=perms))}
        nudged = fe.FusedParams(torch.nextafter(packed.params, packed.params + 1.0), packed.bn)
        runs["plain32, 1 ulp apart"] = named(*fn.reference(nudged, cs.fresh_state(fn, nudged),
                                                           tensors, perms=perms))
        data = fn._make_data(fn.plan, tensors)
        as64 = lambda cols: tuple(c.double() for c in cols)  # noqa: E731
        data64 = fe.FusedData(data.x.double(), as64(data.forcing), as64(data.y), as64(data.mask),
                              data.n_batches, data.batch)
        o = cs.fresh_state(fn, packed)
        runs["plain64"] = named(*fe.fused_epoch_reference(
            fn.plan, fe.FusedParams(packed.params.double(), packed.bn.double()),
            {k: v if k == "t" else v.double() for k, v in o.items()}, data64,
            fn.rows(tensors, perms)))
        for a, b in (("kernel", "plain32"), ("plain32", "plain64"), ("kernel", "plain64"),
                     ("plain32, 1 ulp apart", "plain32")):
            notes = []
            for key in ("params", "m", "v", "loss"):
                out, total, err = cs.beyond(runs[a][key].double(), runs[b][key].double(),
                                            cs.TOL_EPOCH)
                notes.append(f"{key} {out}/{total} beyond, max |diff| {err:.3e}")
            print(f"[drift] {loss}: {a} against {b}: " + "; ".join(notes), flush=True)


def build_all(cs, et):
    """The library, the traced forms' and the traced losses' builds, all at
    once; returns the traced models."""
    from easyhybrid_tpu_torch.ops import _build

    models = cs.traced_models(et)
    forms = cs.traced_forms(et, models)
    with concurrent.futures.ThreadPoolExecutor(24) as pool:
        builds = {**cs.start_traced_builds(pool, forms), **cs.start_loss_builds(et, pool)}
        built = _build.build_library()
        print(f"library: {built.seconds:.1f} s; "
              + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(built.source_seconds.items())),
              flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
        for key, fut in builds.items():
            result = fut.result()
            print(f"{key}: {result.seconds:.1f} s", flush=True)
            for line in result.log.splitlines():
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    print("  " + line.strip(), flush=True)
    _build.load_library()
    return models


def case_outputs(cs, et, models, quick_cols) -> dict:
    """Every phase-22 case's kernel outputs from one run, on the host."""
    out = {}
    for name, what, prepare in cs.loss_cases(et, quick_cols, models):
        got = prepare()
        fn, packed, tensors, perms = got[1:5]
        p, o, loss = fn(packed, cs.fresh_state(fn, packed), tensors, perms=perms)
        out[f"{name}: {what or got[0]}"] = {"params": p.params.cpu(), "bn": p.bn.cpu(),
                                           "loss": loss.reshape(1).cpu(),
                                           **{k: v.cpu() for k, v in o.items()}}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="run the phase-22 cases holding one of these "
                        "comma-separated texts")
    parser.add_argument("--main", action="store_true", help="run phase 23")
    parser.add_argument("--times", action="store_true", help="run phase 24")
    parser.add_argument("--parent", default="", help="time kernel 2's mse epoch in this tree too")
    parser.add_argument("--drift", default="", help="losses (a,b): kernel, float32 and float64 "
                        "plain versions at the main shape")
    parser.add_argument("--ptxas", default="", help="a tree whose fused_epoch.cu to compile too")
    parser.add_argument("--parent-bits", action="store_true",
                        help="hold every phase-22 case bit for bit against the parent's kernels")
    parser.add_argument("--mse-epoch", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--case-bits", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_fused_losses_gpu: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mse_epoch:
        mse_epoch_ms()
        return
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et

    if args.case_bits:
        models = build_all(cs, et)
        torch.save(case_outputs(cs, et, models, et.rbq10_columns(cs.TRAIN_ROWS, seed=42)),
                   args.case_bits)
        return

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args.parent:
        here = Path(__file__).resolve().parent.parent
        trees = [Path(args.parent).resolve(), here, here, Path(args.parent).resolve()]
        for tree in trees:
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--mse-epoch"],
                           check=True, cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)})
    if args.ptxas:  # kernel 2's registers and spills, each tree's own build
        probe = ("from easyhybrid_tpu_torch.ops import _build; "
                 "print(_build.build_variant('fused_epoch.cu', ('-DEH_PTXAS_PROBE',)).log)")
        for tree in (Path(args.ptxas).resolve(), Path(__file__).resolve().parent.parent):
            out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                                 cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)})
            print(f"ptxas | {tree} (exit {out.returncode}):", flush=True)
            for line in (out.stdout + out.stderr).splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print("  " + line.strip()[:160], flush=True)
    if args.parent and args.parent_bits:
        parent = Path(args.parent).resolve()
        bits_file = str(Path(tempfile.mkdtemp()) / "parent.pt")
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--case-bits", bits_file],
                       check=True, cwd=parent, env={**os.environ, "PYTHONPATH": str(parent)})
    models = build_all(cs, et)
    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    if args.parent and args.parent_bits:
        theirs = torch.load(bits_file)
        mine = case_outputs(cs, et, models, quick_cols)
        same_all = True
        for what, got in mine.items():
            same = what in theirs and all(torch.equal(v.view(torch.int32), theirs[what][k].view(
                torch.int32)) for k, v in got.items())  # NaN rows too
            same_all &= same
            print(f"[bits] parent: {what}: " + ("bit for bit equal" if same else "DIFFERENT"),
                  flush=True)
        if not same_all:
            sys.exit("dev_fused_losses_gpu: a kernel's outputs differ from the parent's")
    if args.drift:
        drift(cs, et, quick_cols, args.drift.split(","))
        return
    for name, what, prepare in cs.loss_cases(et, quick_cols, models):
        if args.only and not any(t in name or t in (what or "") for t in args.only.split(",")):
            continue
        got = prepare()
        fn, packed, tensors, perms = got[1:5]
        try:
            cs.held_twice(what or got[0], fn, packed, tensors, perms,
                          gradient_lr=got[5] if len(got) > 5 else None, tag=name)
        except AssertionError as e:
            print(f"[{name}] FAIL {e}", flush=True)
    wide_cols = et.rbq10_columns(cs.WIDE_ROWS, seed=42)
    if args.main:
        cs.loss_main_paths(et, card, quick_cols, wide_cols)
    if args.times:
        cs.loss_times(et, card, quick_cols,
                      {k: v[: cs.WIDE_ROWS * 4 // 5] for k, v in wide_cols.items()})


if __name__ == "__main__":
    main()
