"""Kernel 4's cluster-split form (``easyhybrid_tpu_torch/csrc/fused_lstm_split.cu``)
alone on a CUDA GPU: a quick loop for work on that kernel.

Compiles only ``fused_lstm_split.cu`` (its plain build and its build against
the traced pinball loss, side by side, and with ``--one-block`` the one-block
form's ``fused_epoch_lstm.cu``), prints ptxas's registers and spills by
kernel and the compile seconds, then runs what is asked:

* ``--cases``: ``chip_smoke.py``'s phase 39, every split-form case against
  its plain version, twice (the second run must give the same bits);
* ``--one-block``: phase 38, the one-block form at 32-step windows;
* ``--main``: phase 40, the 32-step LSTM(256) ``train()`` on the split form
  and the LSTM(64) one on the one-block form;
* ``--times``: phase 41, the split form's epoch at LSTM(256) and LSTM(128)
  beside cuDNN's LSTM, its plain version and its bound;
* ``--torch``: the main path's ``train()`` on the torch engine (autograd
  through the recurrence), its best val nseLoss, Q10 and wall;
* ``--cluster 4,8``: the LSTM(256) epoch with the cluster forced to each
  size, beside the plan's;
* ``--stamps``: the main shape's epoch split by stage (a build with
  ``-DEHS_STAMPS``: thread 0 of block 0's ``clock64()`` cycles a stage);
* ``--drift``: at batch 1,000 (LSTM(72) with 64 and 2 features) and the
  main shape, two adam steps of the kernel and of the plain version in
  float32, each against the plain version in float64 on the card, leaf by
  leaf: the rounding the comparisons' tolerance has to hold.

``--torch-cpu`` runs only the torch engine's ``train()`` of the main path
on the CPU (no GPU needed): the reference figure ``chip_smoke.py`` quotes.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_lstm_split_gpu.py --cases --one-block --main --times
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import ctypes
import dataclasses
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
from easyhybrid_tpu_torch.ops import fused_lstm_split as fs
from easyhybrid_tpu_torch.ops import kernel_forms as kf
from easyhybrid_tpu_torch.ops.fused_forward import KERNEL_FORMS


def torch_reference(device: str, hidden: int) -> None:
    """The main path's ``train()`` on the torch engine on ``device``."""
    model = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters=chip_smoke.RBQ10_PARAMS,
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm="static", device=device,
        generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    r = et.train(model, et.rbq10_columns(chip_smoke.LSTM_ROWS, seed=7), use_kernel=False,
                 **chip_smoke.SPLIT_TRAIN_KW)
    if device == "cuda":
        torch.cuda.synchronize()
    q10 = float(et.scale_param(r.params["globals.Q10"], 1.0, 4.0))
    print(f"[torch {device}] LSTM({hidden}), 32-step windows: {r.epoch_path}, best val nseLoss "
          f"{r.best_loss:.6f} at epoch {r.best_epoch}, val mse "
          f"{r.val_history[r.best_epoch]['mse']['reco']:.6f}, Q10 {q10:.4f}, "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)


def build(one_block: bool):
    """The split form's builds (plain, against the traced pinball) and, if
    asked, the one-block form's, all at once; the logs' register lines."""
    pinball = kf.traced_loss(chip_smoke.LOSS_SPECS["pinball"](et))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {"split": pool.submit(_build.build_variant, "fused_lstm_split.cu", ()),
                   "split pinball": pool.submit(_build.form_build, "fused_lstm_split.cu",
                                                KERNEL_FORMS["rbq10"], loss=pinball)}
        if one_block:
            futures["one block"] = pool.submit(_build.build_variant, "fused_epoch_lstm.cu", ())
        built = {k: f.result() for k, f in futures.items()}
    print("[build] nvcc " + ", ".join(f"{k} {v.seconds:.1f} s" for k, v in built.items()),
          flush=True)
    keep = ("Compiling entry", "registers", "spill", "warning", "error")
    for name, result in built.items():
        for line in result.log.splitlines():
            if any(k in line for k in keep):
                print(f"[build] {name}: {line.strip()}", flush=True)
    return built


class AloneLibrary:
    """The builds of the split form (and the one-block form) in the place of
    the package's library, which would take every other kernel's build as
    well."""

    def __init__(self, built):
        split = _build._declare(ctypes.CDLL(str(built["split"].path)), "eh_fused_lstm_split")
        self.eh_fused_lstm_split = split.eh_fused_lstm_split
        self.eh_fused_lstm_split_args_size = split.eh_fused_lstm_split_args_size
        self.eh_cuda_error_string = split.eh_cuda_error_string
        if "one block" in built:
            one = _build._declare(ctypes.CDLL(str(built["one block"].path)), "eh_fused_lstm")
            self.eh_fused_lstm = one.eh_fused_lstm
            self.eh_fused_lstm_args_size = one.eh_fused_lstm_args_size


def cluster_times(card, clusters) -> None:
    """The LSTM(256) epoch at the main shape with the cluster forced to each
    size, beside the plan's, in turns."""
    case = chip_smoke.prepare_lstm_form_case(
        et, what="", hidden=chip_smoke.SPLIT_HIDDEN, n=int(chip_smoke.LSTM_ROWS * 0.8))
    _, _, fn, packed, tensors, perms = case
    opt0 = fe.init_fused_opt_state(packed)
    calls = {}
    nb, batch = (int(v) for v in tensors.weight.shape)
    for c in (0, *clusters):
        f = copy.copy(fn)
        f.plan = dataclasses.replace(fn.plan, cluster=c)
        try:
            f.plan.geometry(batch)
        except ValueError as err:  # a cluster whose blocks cannot hold their share
            print(f"[times] cluster {c}: {err}", flush=True)
            continue
        calls[c] = lambda f=f: f(packed, opt0, tensors, perms=perms)
        chip_smoke.host_ms(calls[c], 1)
    samples = {c: [] for c in calls}
    for i in range(4):
        for c in (list(calls) if i % 2 == 0 else list(reversed(list(calls)))):
            samples[c].append(chip_smoke.device_ms(calls[c], 2, f"cluster {c}"))
    print(f"[times] [{card}] split LSTM(256) epoch ({nb} steps of {batch}) by cluster size: "
          + ", ".join(f"{c or 'plan'} {statistics.median(v):.3f} ms "
                      f"({dataclasses.replace(fn.plan, cluster=c).geometry(batch)})"
                      for c, v in samples.items()), flush=True)


def drift() -> None:
    """Each leaf's largest ``|p - p64| / max(1, |p64|)`` after two adam steps,
    the kernel's and the float32 plain version's, against the plain version
    run in float64 on the same rows."""
    for hidden, features, batch in ((72, 64, 1000), (72, 2, 1000), (128, 2, 128), (256, 2, 128)):
        opt = ("adam", 0.01)
        _, _, fn, packed, tensors, perms = chip_smoke.prepare_lstm_form_case(
            et, what="", hidden=hidden, features=features, batch=batch, opt=opt)
        data, rows = fn._make_data(fn.plan, tensors), fn.rows(tensors, perms)
        st = fe.init_fused_opt_state(packed, opt)
        kernel, _, _ = fn(packed, st, tensors, perms=perms)
        plain, _, _ = fl.fused_lstm_reference(fn.plan, packed, st, data, rows)
        d64 = type(data)(x=data.x.double(), forcing=tuple(c.double() for c in data.forcing),
                         y=tuple(c.double() for c in data.y),
                         mask=tuple(c.double() for c in data.mask), n_batches=data.n_batches,
                         batch=data.batch)
        p64, _, _ = fl.fused_lstm_reference(
            dataclasses.replace(fn.plan, consts=fn.plan.consts.double()),
            fe.FusedParams(packed.params.double(), packed.bn.double()),
            {k: (v.double() if v.is_floating_point() else v) for k, v in st.items()}, d64, rows)
        ref = fn.plan.leaves(p64.params)
        parts = []
        for name, want in ref.items():
            scale = want.abs().clamp_min(1)
            k = float(((fn.plan.leaves(kernel.params)[name].double() - want).abs() / scale).max())
            p = float(((fn.plan.leaves(plain.params)[name].double() - want).abs() / scale).max())
            parts.append(f"{name} kernel {k:.2e} plain32 {p:.2e}")
        print(f"[drift] LSTM({hidden}), {features} features, batch {batch}, "
              f"{data.n_batches} adam steps, against float64: " + "; ".join(parts), flush=True)


def stamps(card) -> None:
    """The main shape's epoch (and LSTM(128)'s) by stage, from the stamped
    build: each stage's share of the kernel's cycles and its cycles a step."""
    for hidden in (chip_smoke.SPLIT_HIDDEN, 128):
        _, _, fn, packed, tensors, perms = chip_smoke.prepare_lstm_form_case(
            et, what="", hidden=hidden, n=int(chip_smoke.LSTM_ROWS * 0.8))
        got = fs.stage_cycles(fn, packed, fe.init_fused_opt_state(packed), tensors, perms)
        nb = int(tensors.weight.shape[0])
        total = got.pop("kernel")
        print(f"[stamps] [{card}] split LSTM({hidden}), an epoch of {nb} steps, "
              f"{fn.plan.geometry(int(tensors.weight.shape[1]))}: {total} cycles; "
              + ", ".join(f"{k} {100 * v / total:.1f}% ({v / nb:.0f} a step)"
                          for k, v in got.items() if v), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for flag in ("cases", "one-block", "main", "times", "torch", "torch-cpu", "drift", "stamps"):
        parser.add_argument(f"--{flag}", action="store_true")
    parser.add_argument("--cluster", default="", help="cluster sizes to time, e.g. 4,8")
    args = parser.parse_args()
    if args.torch_cpu:
        for hidden in (chip_smoke.SPLIT_HIDDEN, 64):
            torch_reference("cpu", hidden)
        return
    if not torch.cuda.is_available():
        sys.exit("dev_fused_lstm_split_gpu: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = build(args.one_block or args.main)
    lib = AloneLibrary(built)
    _build.load_library = lambda: lib
    t0 = time.perf_counter()
    if args.drift:
        drift()
    if args.stamps:
        stamps(card)
    if args.times:
        chip_smoke.split_times(et, card)
    if args.cluster:
        cluster_times(card, [int(c) for c in args.cluster.split(",")])
    if args.main:
        chip_smoke.split_main_path(et, card)
    if args.torch:
        torch_reference("cuda", chip_smoke.SPLIT_HIDDEN)
    if args.one_block:
        print(f"[one-block] max |diff| {chip_smoke.one_block_32_checks(et):.3e}", flush=True)
    if args.cases:
        print(f"[cases] max |diff| {chip_smoke.split_kernel_checks(et):.3e}", flush=True)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the builds", flush=True)


if __name__ == "__main__":
    main()
