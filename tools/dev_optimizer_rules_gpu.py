"""The optimizer rules of the four training kernels (kernels 2, 3, 4 and 5)
on a CUDA GPU: their cost, the bits of adam and plain sgd against another
tree, and the exactness gate under every rule.

For this tree, and with ``--parent DIR`` for others as well (a copy of the
parent commit, e.g. unpacked with ``git archive`` into the ignored
``chip_work/``; the option may be given more than once, the first tree is
the one whose bits are held), each in a process of its own with that tree's
package and ``chip_smoke.py``:

* builds the package's library and prints each source's ``nvcc`` seconds;
* runs every adam and plain-sgd case of that tree's ``chip_smoke.py`` for
  kernels 2, 3, 4 and 5 (``epoch_cases``, ``wide_cases``, ``lstm_cases``,
  ``multisite_cases``) once and keeps the results; the cases this tree and
  the first ``--parent`` share are then held bit for bit (parameters,
  BatchNorm statistics, moments, step count, loss); ``--times-only`` leaves
  this out;
* times each kernel at its main shape (``chip_smoke``'s first case of each
  kernel: an epoch of the quick-start, of the wide tower and of the LSTM, a
  step of the multi-site model) under adam, and on this tree also under
  rmsprop, amsgrad and lamb: device ms a step by CUDA events behind a sleep
  kernel, the median of 5; for kernels 3 and 5 also each of their kernels
  by name from ``torch.profiler``.

The trees take turns: the others, this, this, the others in reverse
(``--rounds``). With
``--gates`` this tree also runs the exactness gate (``fused_exactness_check``,
as ``train()`` calls it) for every rule on the quick-start (trainable and
static norm) and on kernels 3, 4 and 5's main models, and prints its verdict
and worst difference. It asserts nothing but the bits: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels to their tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_optimizer_rules_gpu.py [--parent DIR]... [--gates] [--times-only]
        [--kernels 2345]
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

# every rule of the training kernels, at the learning rates of chip_smoke's cases
RULES = [("adam", 0.01), ("sgd", 0.05), ("adamw", 0.01), ("sgd", 0.05, 0.9),
         ("sgd", 0.05, 0.9, 1.0), ("rmsprop", 0.001), ("adagrad", 0.05), ("lion", 0.001),
         ("adamax", 0.01), ("nadam", 0.01), ("adadelta", 1.0), ("radam", 0.01),
         ("amsgrad", 0.01), ("lamb", 0.01)]
TIMED = [("adam", 0.01), ("rmsprop", 0.001), ("amsgrad", 0.01), ("lamb", 0.01)]
KERNELS = os.environ.get("EH_RULES_KERNELS", "2345")  # the kernels timed (--kernels)


def plain_rule(opt) -> bool:
    """adam, or sgd without momentum: the rules both trees run."""
    return opt[0] == "adam" or (opt[0] == "sgd" and len(opt) < 3)


def state_for(fe, packed, opt):
    return fe.init_fused_opt_state(packed, opt) if opt[0] == "amsgrad" else \
        fe.init_fused_opt_state(packed)


def groups(cs, et):
    """``(name, cases, prepare)`` of each training kernel's chip_smoke cases."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    wide_cols = et.rbq10_columns(cs.WIDE_ROWS, seed=42)
    wide_train = {k: v[: cs.WIDE_ROWS * 4 // 5] for k, v in wide_cols.items()}
    return [
        ("kernel 2", cs.epoch_cases(et, quick_cols), lambda c: cs.prepare_epoch_case(et, fe, **c)),
        ("kernel 3", cs.wide_cases(et, wide_train), lambda c: cs.prepare_wide_case(et, **c)),
        ("kernel 4", cs.lstm_cases(), lambda c: cs.prepare_lstm_case(et, **c)),
        ("kernel 5", cs.multisite_cases(), lambda c: cs.prepare_multisite_case(et, **c)),
    ]


def case_results(cs, et) -> dict:
    """Every adam and plain-sgd case's results, by kernel and description."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    out = {}
    for name, cases, prepare in groups(cs, et):
        for case in cases:
            if not plain_rule(case.get("opt", ("adam", 0.01))):
                continue
            what, fn, packed, tensors, perms = prepare(case)
            p, o, loss = fn(packed, fe.init_fused_opt_state(packed), tensors, perms=perms)
            torch.cuda.synchronize()
            out[(name, what)] = [t.cpu() for t in (p.params, p.bn, o["m"], o["v"], o["t"], loss)]
    return out


def main_shapes(cs, et):
    """Each kernel's main-shape case, ``(name, case, prepare, reps)``: its
    first case (for kernel 3 the tower's main path, its second), one epoch (a
    step of kernel 5 five times)."""
    out = []
    for name, cases, prepare in groups(cs, et):
        case = cases[1] if name == "kernel 3" else cases[0]
        out.append((name, {**case, "epochs": 5 if name == "kernel 5" else 1}, prepare,
                    2 if name == "kernel 3" else 10))  # the tower: 22 launches a step
    return out


def time_rules(tag, cs, et, rules) -> None:
    """Device ms a step of each kernel at its main shape under each rule."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    for name, case, prepare, reps in main_shapes(cs, et):
        if name[-1] not in KERNELS:
            continue
        for opt in rules:
            try:
                what, fn, packed, tensors, perms = prepare({**case, "opt": opt})
            except ValueError as e:  # a rule this tree's kernels refuse
                print(f"[{tag}] time | {name} | {opt}: refused ({e})", flush=True)
                continue
            state = state_for(fe, packed, opt)
            steps = case["epochs"] * int(tensors.weight.shape[0])

            def call():
                return fn(packed, state, tensors, perms=perms)

            cs.host_ms(call, 2)  # warm-up
            ms = [cs.device_ms(call, reps, name) / steps for _ in range(5)]
            print(f"[{tag}] time | {name} | {what} | {opt}: {statistics.median(ms) * 1e3:.2f} us a "
                  f"step (median of 5, min {min(ms) * 1e3:.2f}; {steps} steps a call)", flush=True)
            prefix = {"kernel 3": "eh_wide_", "kernel 5": "eh_ms_"}.get(name)
            if prefix:  # the launcher's kernels, each by name
                split = cs.kernel_split_ms(call, 2, prefix)
                print(f"[{tag}] split | {name} | {opt}: " + ", ".join(
                    f"{k} {v / steps * 1e3:.2f}" for k, v in sorted(split.items()))
                    + " us a step (profiler, 2 calls)", flush=True)


def gate_models(cs, et):
    """``(what, model, logging, tensors, epochs_per_call, shuffle)`` of the
    quick-start (trainable and static norm) and of kernels 3, 4 and 5's main
    models, as ``train()`` would gate them."""
    from easyhybrid_tpu_torch.data.prepare import HybridData
    from easyhybrid_tpu_torch.data.sequences import split_into_sequences
    from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to

    def on_card(model, data, batch):
        et.fit_input_norm(model, data)
        return epoch_tensors_to(et.build_epoch_tensors(data, batch), "cuda")

    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    out = []
    for norm in (True, "static"):
        m = cs.build_model(et, norm=norm, seed=0)
        out.append((f"quick-start, norm {norm!r}, batch 512", m, et.LoggingLoss(),
                    on_card(m, et.split_data(quick_cols, m)[0], 512), 1, True))
    wide = cs.build_model(et, hidden=cs.WIDE_HIDDEN)
    wide_cols = et.rbq10_columns(cs.WIDE_ROWS, seed=42)
    out.append(("wide tower, batch 1,024", wide, et.LoggingLoss(),
                on_card(wide, et.split_data(wide_cols, wide)[0], cs.WIDE_BATCH), 1, True))
    lstm = cs.lstm_model(et)
    cols = et.rbq10_columns(cs.LSTM_ROWS, seed=7)
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    seq = split_into_sequences(rows, **cs.LSTM_WINDOW)
    out.append(("LSTM(16), 10-step windows, nseLoss, batch 128", lstm,
                et.LoggingLoss(training_loss="nseLoss", loss_types=("nseLoss",)),
                on_card(lstm, seq, 128), 1, True))
    ms = cs.multisite_model(et, cs.MS_TRAIN_SITES)
    data = et.gen_multisite_arrays(cs.MS_TRAIN_SITES, cs.MS_OBS, seed=0, nan_frac=0.1,
                                   site_idx=True)
    out.append((f"multi-site, {cs.MS_TRAIN_SITES} sites x {cs.MS_OBS}, eval_every 5", ms,
                et.LoggingLoss(), on_card(ms, data, cs.MS_TRAIN_SITES), 5, False))
    return out


def gates(tag, cs, et) -> None:
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    for what, model, logging, tensors, epochs, shuffle in gate_models(cs, et):
        for opt in RULES:
            ok, worst = fe.fused_exactness_check(model, opt, logging, tensors,
                                                 epochs_per_call=epochs, shuffle=shuffle)
            print(f"[{tag}] gate | {what} | {opt}: {'passed' if ok else 'REFUSED (torch engine)'}, "
                  f"worst {worst:.3e}", flush=True)


def side(args) -> None:
    """One tree's turn, in its own process with its own package."""
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build

    tag = args.side
    built = _build.build_library()
    if built.seconds:
        print(f"[{tag}] nvcc, one process per source in parallel, {built.seconds:.1f} s in all: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(built.source_seconds.items())),
              flush=True)
    _build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.results:
        torch.save(case_results(cs, et), args.results)
    time_rules(tag, cs, et, TIMED[:1] if tag == "parent" else TIMED)
    if args.gates:
        gates(tag, cs, et)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", action="append", default=[],
                        help="a copy of another tree to run as well")
    parser.add_argument("--gates", action="store_true", help="the gate under every rule")
    parser.add_argument("--times-only", action="store_true", help="no bits against the parent")
    parser.add_argument("--kernels", default="2345", help="the kernels to time, e.g. 25")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--side", default="", help=argparse.SUPPRESS)
    parser.add_argument("--results", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_optimizer_rules_gpu: needs a CUDA GPU")
    if args.side:
        side(args)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    here = Path(__file__).resolve().parent.parent
    others = {("parent" if i == 0 else Path(d).name): Path(d).resolve()
              for i, d in enumerate(args.parent)}
    trees = {**others, "this": here}
    with tempfile.TemporaryDirectory() as tmp:
        files = {tag: str(Path(tmp) / f"{tag}.pt") for tag in trees}
        order = []
        for r in range(args.rounds):
            turn = [*others, "this"]
            order += turn if r % 2 == 0 else turn[::-1]
        seen = set()
        for tag in order:
            first = tag not in seen
            seen.add(tag)
            keep = first and not args.times_only and tag in ("this", "parent") and "parent" in trees
            cmd = [sys.executable, str(Path(__file__).resolve()), "--side", tag,
                   "--results", files[tag] if keep else ""]
            if first and tag == "this" and args.gates:
                cmd.append("--gates")
            subprocess.run(cmd, check=True, cwd=trees[tag],
                           env={**os.environ, "PYTHONPATH": str(trees[tag]),
                                "EH_RULES_KERNELS": args.kernels})
        if "parent" in trees and not args.times_only:
            mine, theirs = torch.load(files["this"]), torch.load(files["parent"])

            def same(a, b):
                if a.is_floating_point():
                    a, b = a.view(torch.int32), b.view(torch.int32)
                return a.shape == b.shape and torch.equal(a, b)

            shared = [k for k in theirs if k in mine]
            differ = [k for k in shared if not all(same(a, b) for a, b in zip(mine[k], theirs[k]))]
            for name in ("kernel 2", "kernel 3", "kernel 4", "kernel 5"):
                n = sum(k[0] == name for k in shared)
                bad = [k[1] for k in differ if k[0] == name]
                print(f"bits | {name}: {n} adam and plain-sgd cases of both trees, "
                      + ("the same bits in every one" if not bad else f"OTHER BITS in {bad}"),
                      flush=True)
            missing = [k for k in theirs if k not in mine]
            if missing:
                print(f"bits | cases of the parent this tree lacks: {missing}", flush=True)
            if differ:
                sys.exit(1)


if __name__ == "__main__":
    main()
