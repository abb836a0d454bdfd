"""``train()``'s two loops on a CUDA GPU: where the host's time goes,
deferred against eager, on ``chip_smoke.py``'s ``train()`` cells.

For each cell (``--cells``, by the start of its name in
``chip_smoke.loop_cells``; the quick-start of phase 7 by default):

* the wall of ``train()`` in each loop, ``--calls`` calls each after a warm
  one, the loops in turns;
* the host seconds of a call by stage, timed without synchronising (a
  timer that waited would take the overlap away from the deferred loop):
  the gate, each block's dispatch (the kernel call and the write-back into
  the model), the snapshot row (the evaluation and the row), the device
  stopper, the poll, the eager loop's host stopper and its reads of the row
  (where it waits for the device), the final fetch, and the rest;
* with ``--profile``, ``cProfile``'s 20 functions of most own time in one
  call of each loop;
* with ``--parent DIR`` (another tree, e.g. the parent commit unpacked with
  ``git archive`` into the ignored ``chip_work/``), that tree's ``train()``
  wall on the quick-start cell in a process of its own, in turns with this
  tree's (parent, this, this, parent).

It asserts nothing: ``chip_smoke.py`` phases 29-30 hold the loops to each
other. Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python3 tools/dev_train_loop_gpu.py [--cells quick,wide] [--profile] [--parent DIR]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import torch

# one train() of the quick-start cell in a fresh process of some tree: its wall, after a warm call
_TREE_SCRIPT = """
import json, sys, time, torch
import chip_smoke as cs, easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
_build.build_library()
cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
walls = []
for i in range(1 + int(sys.argv[1])):
    model = cs.build_model(et, norm=True, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = et.train(model, cols, **cs.TRAIN_KW)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
print(json.dumps({"walls": walls[1:], "loop": getattr(r, "loop_mode", None)}))
"""


def tree_walls(tree: str, calls: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-c", _TREE_SCRIPT, str(calls)], cwd=tree, env=env,
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


class StageTimers:
    """Host seconds by stage, from wrappers around the loops' functions."""

    def __init__(self):
        from easyhybrid_tpu_torch.training import deferred, early_stopping
        from easyhybrid_tpu_torch.training import train as train_module

        self.spent, self.calls, self.undo = {}, {}, []
        self.active = []  # the stages running now: an inner one's time is not its outer one's
        targets = [
            (train_module, "fused_exactness_check", "gate"),
            (train_module._FusedRun, "block", "block dispatch (kernel call, write-back)"),
            (train_module._TorchRun, "block", "block dispatch (torch epoch)"),
            (deferred.SnapshotRow, "take", "snapshot row (evaluation, row)"),
            (early_stopping.DeviceStopper, "update", "device stopper"),
            (deferred._DonePoll, "start", "poll (copy, event)"),
            (deferred, "poll_done", "poll (query, read)"),
            (early_stopping.EarlyStopping, "update", "host stopper"),
            (deferred.SnapshotRow, "unpack", "row to dicts"),
            (torch.Tensor, "cpu", "reads to the host (.cpu(): the eager wait, the final fetch)"),
        ]
        for owner, name, stage in targets:
            self._wrap(owner, name, stage)

    def _wrap(self, owner, name, stage):
        real, own = getattr(owner, name), name in vars(owner)
        self.spent[stage], self.calls[stage] = 0.0, 0

        def timed(*args, **kwargs):
            if self.active:  # counted in the stage that called it
                return real(*args, **kwargs)
            self.active.append(stage)
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.spent[stage] += time.perf_counter() - t0
                self.calls[stage] += 1
                self.active.pop()

        setattr(owner, name, timed)
        self.undo.append((owner, name, real if own else None))

    def reset(self):
        for k in self.spent:
            self.spent[k], self.calls[k] = 0.0, 0

    def restore(self):
        for owner, name, real in reversed(self.undo):
            if real is None:  # inherited: uncover the base class's again
                delattr(owner, name)
            else:
                setattr(owner, name, real)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", default="quick-start (phase 7)")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--parent", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dev_train_loop_gpu: needs a CUDA GPU")
    import chip_smoke as cs
    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    built = _build.build_library()
    print(f"library built in {built.seconds:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.parent:
        runs = []
        for tree in (args.parent, ".", ".", args.parent):
            got = tree_walls(tree, args.calls)
            runs.append((tree, got))
            print(f"tree {tree}: quick-start train() ({got['loop']} loop), walls "
                  + ", ".join(f"{w:.4f}" for w in got["walls"]) + " s", flush=True)
        for tree in (args.parent, "."):
            walls = [w for t, g in runs if t == tree for w in g["walls"]]
            print(f"tree {tree}: median {statistics.median(walls):.4f} s over {len(walls)} calls")

    quick_cols = et.rbq10_columns(cs.TRAIN_ROWS, seed=42)
    wide_cols = et.rbq10_columns(cs.WIDE_ROWS, seed=42)
    wanted = [w.strip() for w in args.cells.split(",")]
    needs = " ".join(wanted)
    ms_data = lstm_cols = mn = None
    if "multi" in needs:
        table, _ = cs.multisite_table(et)
        ms_data = et.prepare_multisite_data(cs.multisite_model(et, cs.MS_SITES).base, table, "site")
    if "sequence" in needs:
        lstm_cols = et.rbq10_columns(cs.LSTM_ROWS, seed=7)
    if "Expo" in needs:
        mn = cs.multinn_models(et, cs.traced_models(et))
    cells = cs.loop_cells(et, quick_cols, wide_cols, ms_data, lstm_cols, mn or {"expo": None})
    cells = {k: v for k, v in cells.items() if any(k.startswith(w) for w in wanted)}

    timers = StageTimers()
    try:
        for name, (make, data, kw) in cells.items():
            for loop in ("deferred", "eager"):  # warm calls
                et.train(make(), data, **dict(kw, show_progress=loop == "eager"))
            walls = {"deferred": [], "eager": []}
            split = {"deferred": {}, "eager": {}}
            for i in range(args.calls):
                for loop in (("deferred", "eager") if i % 2 == 0 else ("eager", "deferred")):
                    model = make()
                    torch.cuda.synchronize()
                    timers.reset()
                    t0 = time.perf_counter()
                    et.train(model, data, **dict(kw, show_progress=loop == "eager"))
                    torch.cuda.synchronize()
                    walls[loop].append(time.perf_counter() - t0)
                    for k, v in timers.spent.items():
                        split[loop].setdefault(k, []).append((v, timers.calls[k]))
            for loop in ("deferred", "eager"):
                wall = statistics.median(walls[loop])
                parts = {k: statistics.median(v for v, _ in runs) for k, runs in split[loop].items()}
                calls = {k: runs[0][1] for k, runs in split[loop].items()}
                print(f"[{card}] {name}, {loop} loop: train() wall, median of {args.calls}: "
                      f"{wall:.4f} s ({', '.join(f'{w:.4f}' for w in walls[loop])}); host seconds "
                      "by stage (medians): "
                      + ", ".join(f"{k} {v:.4f} in {calls[k]} calls ({v / calls[k] * 1e3:.3f} ms "
                                  "each)" for k, v in parts.items() if calls[k])
                      + f"; the rest {wall - sum(parts.values()):.4f}", flush=True)
            if args.profile:
                timers.restore()
                for loop in ("deferred", "eager"):
                    model = make()
                    prof = cProfile.Profile()
                    prof.runcall(et.train, model, data, **dict(kw, show_progress=loop == "eager"))
                    torch.cuda.synchronize()
                    text = io.StringIO()
                    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(20)
                    print(f"--- {name}, {loop} loop, cProfile by own time:\n{text.getvalue()}",
                          flush=True)
                timers = StageTimers()
    finally:
        timers.restore()


if __name__ == "__main__":
    main()
