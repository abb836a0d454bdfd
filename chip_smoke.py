#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (easyhybrid_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles csrc/*.cu with nvcc for sm_90a (set-up time);
3. kernel: the fused forward kernel against its plain PyTorch version on
   the card, at the serving path's shapes and at the kernel's edges (1,
   1,023, 1,024, 1,025 and 131,072 rows at widths 16, 32 and 64, with NaN
   predictor rows), and one launch over every chunk against a launch per
   chunk of 1,024 rows, which must give the same bits;
4. main path: the quick-start RbQ10 model (MLP [16, 16], swish, static
   input norm) at 131,072 rows through ``predict(..., batch_size=1024)``,
   which must take the kernel (one copy in per input array, one launch, one
   copy out per output) and agree with the plain module forward; at batch sizes 1, 1,024
   and 131,072 the keys and shapes of the torch engine and the bits of a
   launch per chunk;
5. times: the kernel per launch at 1,024 and 131,072 rows against the plain
   version, and end-to-end ``predict`` rows/s on both engines, each the
   median of several runs, with launches, copies and the device's busy
   share of a call;
6. kernel 2: the fused epoch kernel against its plain PyTorch version
   (``fused_epoch_reference``) on the card, from identical parameters and
   the same permutations, at the training path's shapes and its edges (the
   edges of its geometry too: batches of 31, 33, 513 and 1,000 rows, a
   batch no cluster holds at once, an epoch boundary under the prefetch, a
   ragged last batch in a cluster), under every optimizer rule besides adam
   and plain sgd (``RULES``: small models, amsgrad and lamb also with the
   slots in device memory) and at the quick-start's full width under
   rmsprop, amsgrad and lamb, each with a second run that must give the
   same bits;
7. main path: ``train()`` on the quick-start RbQ10 model (trainable input
   BatchNorm) at 20,000 rows, 100 epochs of batch 512, which must take the
   kernel after its exactness gate (one launch per epoch) and learn Q10;
   then the reference quick-start (``examples/rbq10.py``: static norm,
   rmsprop at 1e-3, patience 30) the same way, and its wall time on the
   torch engine;
8. times: kernel 2 against its plain version per epoch, with the geometry
   its plan chose (threads, tile, stages, cluster) and a step split by stage
   (a second build of ``fused_epoch.cu`` with ``-DEHE_STAMPS``, made beside
   the library's), and ``train()`` wall seconds on both epoch engines (the
   torch engine for 20 epochs);
9. primitives: the multi-site kernel's building blocks, each a tiny kernel
   held against a torch expression, PASS or FAIL, the two row sums also at
   1, 3, 63, 64, 65 and 1,000 observations a site; ``site_reduce`` timed
   beside ``torch.sum(x, 1)``;
10. kernel 5: the fused multi-site epoch against its plain PyTorch version
    (``fused_multisite_reference``) from identical parameters and the same
    site indices, at the main path's widths and at its edges (those of its
    geometry too: 1, 3, 63, 65 and 1,000 observations a site, sites longer
    than a tile, a ragged last block, more than 528 blocks), under every
    optimizer rule (minibatched sites) and at the main path's width under
    amsgrad and lamb, each with the geometry ``multisite_geometry`` chose
    and a second run that must give the same bits;
11. main path: multi-site ``train()`` at the JAX bench's shape, 10,000 sites
    x 64 observations with a true Q10 per site, from a long table through
    ``prepare_multisite_data`` and ``MultiSiteHybridModel``: it must take
    the kernel after its gate (one launcher call per eval block), return
    finite validation predictions and recover the training sites' Q10; then
    a short run of the minibatched, shuffled shape (10,240 sites, batches of
    2,560);
12. times: kernel 5 against its plain version per step (its gradient and
    update kernels by name), a step split by stage (a second build of
    ``fused_multisite.cu`` with ``-DEHM_STAMPS``, made beside the
    library's), ``train()`` wall on both engines, and the host's share
    (``prepare_multisite_data``);
13. kernel 4: the fused LSTM epoch against its plain PyTorch version
    (``fused_lstm_reference``) from identical parameters and the same
    permutations, at the sequence-training path's shape and at its edges
    (another hidden size and window, mae with sgd and no norm, NaN targets
    with a ragged last batch, the JAX bench's batch of 512, a batch of 1,000
    that no cluster holds at once, every optimizer rule, the main path's
    shape under rmsprop), with a second run that must give the
    same bits, each with the geometry its plan chose (blocks in the cluster,
    windows a block, tiles, lanes a window); then windows of 10, 32, 64, 128
    and 256 steps at hidden size 16, each taken or refused with the
    envelope's reason;
14. main path: sequence training as ``examples/lstm_sequences.py`` runs it,
    4,000 rows cut into 10-step windows, LSTM(16) with static input norm,
    30 epochs of batch 128 on nseLoss through ``train(sequence_kwargs=...)``:
    it must take the kernel after its gate (one launch per epoch), return
    finite validation predictions in the long format and reach a best
    validation nseLoss below ``LSTM_VAL_LIMIT``;
15. times: kernel 4 against its plain version per epoch at the main path's
    shape and at the JAX bench's (batch 512, no norm, mse), with the geometry
    its plan chose and the chain's floor (a second build of
    ``fused_epoch_lstm.cu`` with ``-DEHL_CHAIN_ONLY``, made beside the
    library's), and ``train()`` wall on both engines;
16. kernel 3: the wide fused epoch against its plain PyTorch version
    (``fused_wide_reference``) from identical parameters and the same
    permutations: the tower [1024, 512, 256, 128, 64] at full width (the
    gradient itself through one sgd step, then 2 epochs x 16 Adam steps of
    1,024 rows, and batch 64), and at its edges on smaller models (widths that
    are no multiple of the tile, mae with sgd and no norm, NaN targets with a
    ragged last batch, a fully masked first batch, ``shuffle="batches"``, every
    optimizer rule; the tower under adamw and lamb), with a second run that
    must give the same bits; the tower's Adam-like runs are held
    against the plain version in float32 and in float64 (the float32 one is no
    reference where it misses the criterion against its own float64 run);
    each case prints the route, tile and pieces the plan chose for every
    layer's products;
17. main path: ``train()`` on the wide model, hidden layers [1024, 512, 256,
    128, 64], swish, static input norm, 20,480 rows split 80/20 into 16 batches
    of 1,024, 20 epochs of Adam at 0.01 on mse: it must take kernel 3 after its
    gate (one launcher call per epoch), return finite validation predictions,
    and end with a best validation mse below ``WIDE_VAL_LIMIT`` and Q10 near 2;
18. times: kernel 3 per epoch and per step at the main shape and at batch 64,
    each of its kernels by name, the gaps between its launches, its plain
    version, the step's layer products through ``torch.matmul`` in float32 and
    TF32 (a yardstick), the tensor-core instructions ``cuobjdump -sass`` finds
    in each of its kernels, ``train()`` wall on both engines and the device's
    busy share of the fused ``train()``.

Models are built without a ``device=`` argument and must land on the card.
The last three lines are: a JSON object ``{"kernels": [...]}`` with one
entry per kernel, the card's name and power limit as ``nvidia-smi`` gives
them, and ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

# max |got - ref| <= TOL * max(1, |ref|) on every output, float32: the kernel
# uses CUDA's expf / powf / tanhf / rsqrtf and sums each layer in its own
# order, against torch's transcendentals and GEMM, a few ulp apart per step
TOL = 1e-5
# kernel 2 after a short run (at most 4 epochs x 32 steps): max |got - ref|
# <= TOL_EPOCH * max(1, |ref|) on parameters, moments, BatchNorm statistics
# and loss. Each step differs by a few ulp (expf / powf / sums in another
# order), and every step starts from the last one's result, so the
# differences compound along the chain; Adam's g / sqrt(v) magnifies the
# rounding of tiny gradients
TOL_EPOCH = 1e-4
N_ROWS = 131_072
BATCH = 1024
RBQ10_PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}
# a multi-site model with two per-site globals: the network gives the form's tref
TWO_GLOBALS = dict(parameters={**RBQ10_PARAMS, "tref": (15.0, 10.0, 20.0)},
                   neural_param_names=["tref"], global_param_names=["rb", "Q10"])


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rbq10_untagged(*, ta, rb, Q10, tref=15.0):
    """The quick-start model without a kernel form: runs the plain engine."""
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def build_model(et, *, hidden=(16, 16), activation="swish", norm="static",
                mechanistic=None, seed=0, **overrides):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=mechanistic or et.rbq10, parameters=RBQ10_PARAMS,
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=hidden if isinstance(hidden, dict) else list(hidden),
        activation=activation,
        scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(overrides)
    model = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed))
    if model.device.type != "cuda":
        raise AssertionError(f"a model built without device= is on {model.device}, not the card")
    return model


def to_device(et, model, cols):
    """Fit the static norm on the complete rows and return the model's
    inputs (NaN rows kept) as CUDA tensors."""
    et.fit_input_norm(model, et.prepare_data(model, cols))
    data = et.prepare_data(model, cols, drop_missing_rows=False)
    x = torch.from_numpy(data.x).cuda()
    forcing = {k: torch.from_numpy(v).cuda() for k, v in data.forcing.items()}
    return x, forcing


def compare(got, ref, what: str, tol: float = TOL) -> float:
    """Check ``got`` against ``ref`` (same keys, same NaN rows, within
    ``tol``); return the largest absolute difference."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(ref)}")
    worst = 0.0
    for k in ref:
        g, r = got[k].float(), ref[k].float()
        if g.shape != r.shape:
            raise AssertionError(f"{what}: {k} shape {tuple(g.shape)} != {tuple(r.shape)}")
        if not torch.equal(torch.isnan(g), torch.isnan(r)):
            raise AssertionError(f"{what}: {k} NaN rows differ")
        fin = ~torch.isnan(r)
        if not torch.isfinite(r[fin]).all():
            raise AssertionError(f"{what}: {k} has infinite values")
        diff = (g[fin] - r[fin]).abs()
        bound = tol * r[fin].abs().clamp_min(1.0)
        if diff.numel() and bool((diff > bound).any()):
            i = int(torch.argmax(diff / bound))
            raise AssertionError(
                f"{what}: {k} differs by {float(diff[i]):.3e} at |ref| "
                f"{float(r[fin][i].abs()):.3e} (tolerance {tol} x max(1, |ref|))"
            )
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def device_ms(fn, reps: int, what: str = "") -> float:
    """Device milliseconds per call of ``fn``: the calls are enqueued behind
    a sleep kernel, so the CUDA events bracket back-to-back device work and
    not the host's enqueue time. The sleep is lengthened until the host has
    enqueued every call before it ends."""
    cycles = 20_000_000
    for _ in range(6):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the sleep was still running
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError(f"could not enqueue the timed calls of {what!r} ahead of the device "
                       "(does a call wait for the device?)")


def profiled_averages(fn, reps: int, name: str = "", parts=("",)) -> list:
    """``torch.profiler``'s device averages over ``reps`` calls of ``fn``,
    of the activities whose name contains ``name``. A trace now and then
    comes back without the records of kernels that were launched (the launch
    counters show that they ran), so a trace that holds no such activity
    whose name contains each of ``parts`` is taken again, at most three
    times in all, before it is an error."""
    from torch.profiler import ProfilerActivity, profile

    what = f"activity named *{name}*" + "".join(f", *{p}*" for p in parts if p)
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if name in e.key and e.self_device_time_total > 0]
        if all(any(p in e.key for e in events) for p in parts):
            return events
        log("times", f"the profiler's trace {attempt + 1} of 3 held no device {what}")
    raise AssertionError(f"the profiler saw no device {what}")


def profiled_device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: the sum of the durations of
    the device activities ``torch.profiler`` records over ``reps`` calls.
    For calls of thousands of small kernels, which cannot all wait behind a
    sleep kernel (the launch queue holds about a thousand: past that the
    host blocks until the device has run them)."""
    events = profiled_averages(fn, reps)
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def host_ms(fn, reps: int) -> float:
    """Wall milliseconds per call of ``fn``, enqueue and device work both."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


@contextlib.contextmanager
def gate_counted_apart(launcher):
    """Within the block, ``train()``'s exactness gate sets ``launcher``'s
    count back to 0 when it is done, so that the count read after the block
    is the main path's alone; yields the list of the counts the gate left."""
    from easyhybrid_tpu_torch.training import train as train_module

    gate_launches = []
    real_gate = train_module.fused_exactness_check

    def gate_then_reset(*args, **kwargs):
        out = real_gate(*args, **kwargs)
        gate_launches.append(launcher.launches)
        launcher.launches = 0
        return out

    train_module.fused_exactness_check = gate_then_reset
    launcher.launches = 0
    try:
        yield gate_launches
    finally:
        train_module.fused_exactness_check = real_gate


TRAIN_ROWS = 20_000
TRAIN_KW = dict(nepochs=100, batchsize=512, optimizer=("adam", 0.01), show_progress=False)
# the reference quick-start (examples/rbq10.py): static norm, rmsprop at 1e-3,
# patience 30, the r2 metric beside mse
REFERENCE_KW = dict(nepochs=100, batchsize=512, optimizer=("rmsprop", 0.001), patience=30,
                    tracked_params=["Q10"], loss_types=["mse", "r2"], show_progress=False)
# every optimizer rule of the training kernels besides adam and plain sgd, at a
# learning rate that moves the parameters in a few steps
RULES = [("adamw", 0.01), ("sgd", 0.05, 0.9), ("sgd", 0.05, 0.9, 1.0), ("rmsprop", 0.01),
         ("adagrad", 0.05), ("lion", 0.001), ("adamax", 0.01), ("nadam", 0.01),
         ("adadelta", 1.0), ("radam", 0.01), ("amsgrad", 0.01), ("lamb", 0.01)]


def fresh_state(fn, packed):
    """Zero opt state for the rule of ``fn``'s plan (with amsgrad's u)."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    return fe.init_fused_opt_state(packed, (fn.plan.opt_name, dict(fn.plan.hyper)))


def slots(opt_state) -> dict:
    """The slots of a fused opt state (m, v and amsgrad's u) and its step count."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    return {**fe.opt_slots(opt_state), "t": opt_state["t"].float()}


def epoch_cases(et, quick_cols):
    """Kernel 2's cases: the main path's shapes first, then its edges."""
    odd = et.rbq10_columns(777, seed=2)
    masked = et.rbq10_columns(1024, seed=6)
    masked["reco"][:128] = np.nan  # the whole first (unshuffled) batch
    quick = dict(hidden=(16, 16), act="swish", norm=True, opt=("adam", 0.01))
    return [
        dict(what="quick-start [16,16] swish, trainable BN, 16,000 rows, batch 512, adam, "
                  "shuffled, 4 epochs", cols=quick_cols, split=True, shuffle=True, epochs=4,
             batch=512, seed=0, **quick),
        dict(what="[8] tanh, static norm, sgd, unshuffled, N=1000 batch 128 (ragged)",
             cols=et.rbq10_columns(1000, seed=1), hidden=(8,), act="tanh", norm="static",
             opt=("sgd", 0.05), shuffle=False, epochs=2, batch=128, seed=1),
        *[dict(what=f"[12,5] {act}, static norm, adam, shuffled, N=777 batch 100", cols=odd,
               hidden=(12, 5), act=act, norm="static", opt=("adam", 0.01), shuffle=True,
               epochs=1, batch=100, seed=10 + i)
          for i, act in enumerate(sorted(et.ACTIVATIONS))],
        dict(what="[32,24] tanh, trainable BN, N=2000 batch 256", cols=et.rbq10_columns(2000, seed=3),
             hidden=(32, 24), act="tanh", norm=True, opt=("adam", 0.01), shuffle=True, epochs=1,
             batch=256, seed=3),
        dict(what="[64,48] selu, no norm, shuffle 'batches', N=2000 batch 300",
             cols=et.rbq10_columns(2000, seed=4), hidden=(64, 48), act="selu", norm=False,
             opt=("adam", 0.01), shuffle="batches", epochs=2, batch=300, seed=4),
        dict(what="quick-start, 30% NaN targets, N=4096 batch 256, 2 epochs",
             cols=et.rbq10_columns(4096, seed=5, nan_frac=0.3), keep_nan=True, shuffle=True,
             epochs=2, batch=256, seed=5, **quick),
        dict(what="quick-start, first batch fully masked, adam, unshuffled, N=1024 batch 128",
             cols=masked, keep_nan=True, shuffle=False, epochs=1, batch=128, seed=6, **quick),
        # the geometry's edges: a batch below and above a warp, above one block, in two blocks
        *[dict(what=f"quick-start, N=2100 batch {batch}", cols=et.rbq10_columns(2100, seed=7),
               shuffle=True, epochs=1, batch=batch, seed=7, **quick) for batch in (31, 33, 513, 1000)],
        dict(what="[64,48] selu, static norm, N=9000 batch 3000 (more than a cluster holds at once)",
             cols=et.rbq10_columns(9000, seed=8), hidden=(64, 48), act="selu", norm="static",
             opt=("adam", 0.01), shuffle=True, epochs=1, batch=3000, seed=8),
        dict(what="[61,61,44,61,13] tanh, trainable BN, N=512 batch 128 (moments in device memory)",
             cols=et.rbq10_columns(512, seed=11), hidden=(61, 61, 44, 61, 13), act="tanh", norm=True,
             opt=("adam", 0.01), shuffle=True, epochs=2, batch=128, seed=11),
        dict(what="quick-start, N=1536 batch 512, 3 epochs in a launch (prefetch across epochs)",
             cols=et.rbq10_columns(1536, seed=9), shuffle=True, epochs=3, batch=512, seed=9, **quick),
        dict(what="quick-start, 30% NaN targets, N=2500 batch 1000 (ragged last batch in a cluster)",
             cols=et.rbq10_columns(2500, seed=10, nan_frac=0.3), keep_nan=True, shuffle=True,
             epochs=2, batch=1000, seed=10, **quick),
        # every optimizer rule: two blocks of a cluster, each updating its replica, 8 steps
        *[dict(what=f"{opt}: [12,5] swish, trainable BN, N=2000 batch 512, 2 epochs",
               cols=et.rbq10_columns(2000, seed=20 + i), hidden=(12, 5), act="swish", norm=True,
               opt=opt, shuffle=True, epochs=2, batch=512, seed=20 + i)
          for i, opt in enumerate(RULES)],
        *[dict(what=f"{opt}: [61,61,44,61,13] tanh, N=512 batch 128 (the slots in device memory)",
               cols=et.rbq10_columns(512, seed=11), hidden=(61, 61, 44, 61, 13), act="tanh",
               norm=True, opt=opt, shuffle=True, epochs=2, batch=128, seed=11)
          for opt in (("amsgrad", 0.01), ("lamb", 0.01))],
        # the quick-start at full width under the reference's rule and the two with state
        # of their own (amsgrad's third slot, lamb's per-leaf norms)
        *[dict(what=f"quick-start under {opt}: 16,000 rows, batch 512, shuffled, 4 epochs",
               cols=quick_cols, split=True, shuffle=True, epochs=4, batch=512, seed=0,
               **{**quick, "opt": opt})
          for opt in (("rmsprop", 0.001), ("amsgrad", 0.01), ("lamb", 0.01))],
    ]


def reference_main_path(et, fe, card, cols) -> dict:
    """Phase 7b: the reference quick-start (``examples/rbq10.py``: static
    norm, rmsprop at 1e-3, patience 30) through ``train()`` on a model built
    without ``device=``; it must take kernel 2 after its gate, one launch an
    epoch, and learn Q10. Then the same run on the torch engine for a fifth
    of the epochs, for its wall time."""
    model = build_model(et, norm="static", seed=0)
    with gate_counted_apart(fe.launch_fused_epoch) as gate_launches:
        t0 = time.perf_counter()
        result = et.train(model, cols, **REFERENCE_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fe.launch_fused_epoch.launches
    if (result.epoch_path != "cuda_fused_epoch"
            or "exactness gate passed" not in result.engine_reason):
        raise AssertionError(f"the reference train() took {result.epoch_path!r}: "
                             f"{result.engine_reason}")
    epochs = len(result.train_history) - 1  # the history holds epoch 0 as well
    if launches != epochs or launches < 1:
        raise AssertionError(f"the reference train() ran {epochs} epochs in {launches} launches")
    q10 = float(et.scale_param(result.params["globals.Q10"], 1.0, 4.0))
    pred = result.val_pred_columns["reco_pred"]
    if not (abs(q10 - 2.0) < 0.15 and result.best_loss < 0.05):
        raise AssertionError(f"the reference train() learned Q10 {q10:.4f}, best val mse "
                             f"{result.best_loss:.4f}")
    if pred.shape != (len(cols["reco"]) // 5,) or not np.isfinite(pred).all():
        raise AssertionError(f"val predictions: shape {pred.shape}, "
                             f"finite {np.isfinite(pred).all()}")
    log("main", f"reference quick-start train() ({REFERENCE_KW['optimizer']}, static norm, "
                f"patience {REFERENCE_KW['patience']}): {result.epoch_path}, "
                f"{result.engine_reason}; {launches} launches for {epochs} epochs after the "
                f"gate's {gate_launches}; Q10 {q10:.4f}, best val mse {result.best_loss:.5f} at "
                f"epoch {result.best_epoch}; {wall:.2f} s wall (ok)")
    torch_epochs = 20
    t0 = time.perf_counter()
    plain = et.train(build_model(et, norm="static", seed=0), cols, use_kernel=False,
                     **{**REFERENCE_KW, "nepochs": torch_epochs})
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    if plain.epoch_path != "torch":
        raise AssertionError(f"use_kernel=False took {plain.epoch_path!r}")
    log("times", f"[{card}] reference quick-start train() wall: cuda_fused_epoch {wall:.2f} s for "
                 f"{epochs} epochs (gate included), torch {torch_wall:.2f} s for {torch_epochs} "
                 f"epochs ({torch_wall / torch_epochs * epochs:.2f} s per {epochs})")
    return {"launches": launches, "wall": wall, "torch_wall_per_epoch": torch_wall / torch_epochs}


def prepare_epoch_case(et, fe, *, what, cols, hidden, act, norm, opt, shuffle, epochs, batch,
                       seed, split=False, keep_nan=False, make=None, loss="mse", agg="sum"):
    """The case's fused epoch (kernel 2's, or the one ``make`` builds), its
    packed parameters on the card, its epoch tensors and its permutations."""
    from easyhybrid_tpu_torch.data.prepare import HybridData
    from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

    model = build_model(et, hidden=hidden, activation=act, norm=norm, seed=seed)
    if keep_nan:  # NaN targets reach the batches as masked rows
        data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                          forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    elif split:
        data = et.split_data(cols, model)[0]
    else:
        data = et.prepare_data(model, cols)
    et.fit_input_norm(model, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), "cuda")
    logging = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    fn = (make or et.make_fused_epoch)(model, opt, logging, shuffle=shuffle,
                                       epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    return what, fn, fn.plan.pack(model), tensors, perms


# the card's published peaks (H100 SXM): device memory rate, float32 outside
# the tensor cores, TF32 on the tensor cores (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12


def forward_flops(dims) -> int:
    """Multiply-adds of one row's MLP forward, two flops each. A training
    step is counted as three of them: the forward, the input cotangents and
    the weight gradients."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def bound(*, bytes_moved: int, flops: int) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its float32 peak."""
    by_bytes, by_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kernel_split_ms(fn, reps: int, name: str, parts=("",)) -> dict:
    """Device milliseconds per call of ``fn`` in each kernel whose name
    contains ``name``, keyed by what follows it in the kernel's name, from
    ``torch.profiler`` (a trace that misses one of ``parts`` is taken
    again); ``"all"`` is their sum."""
    out = {}
    for e in profiled_averages(fn, reps, name, parts):
        rest = re.split(r"[(<]", e.key.split(name, 1)[1])[0]
        out[rest] = out.get(rest, 0.0) + e.self_device_time_total / 1e3 / reps
    out["all"] = sum(out.values())
    return out


def kernel_device_ms(fn, reps: int, name: str) -> float:
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    name contains ``name``."""
    return kernel_split_ms(fn, reps, name)["all"]


# kernel 5 after at most 4 epochs of site batches: max |got - ref| <=
# TOL_EPOCH * max(1, |ref|) on parameters, moments and loss. The kernel sums a
# site's time steps, a tile's rows and the blocks' partial rows one after the
# other where torch reduces pairwise, so each step differs by a few ulp, and
# every step starts from the last one's result
MS_SITES, MS_OBS, MS_TRAIN_SITES = 10_000, 64, 8_000
MS_TRAIN_KW = dict(nepochs=60, batchsize=MS_SITES, eval_every=5, optimizer=("adam", 0.01),
                   split_data_at=0.8, shuffle_each_epoch=False, show_progress=False)


def multisite_model(et, n_sites, seed=0, **overrides):
    model = et.MultiSiteHybridModel(build_model(et, seed=seed, **overrides), n_sites=n_sites)
    if model.device.type != "cuda":
        raise AssertionError(f"a multi-site model built without device= is on {model.device}")
    return model


def primitive_checks(card):
    """Phase 9: each primitive kernel against a torch expression on the card."""
    from easyhybrid_tpu_torch.ops import multisite_primitives as mp

    g = torch.Generator(device="cuda").manual_seed(0)
    n_sites, n_obs = MS_SITES, MS_OBS
    vals = torch.rand(n_sites, device="cuda", generator=g)
    index = torch.randperm(n_sites, device="cuda", generator=g)[:MS_TRAIN_SITES].int()
    index[::97] = -1  # padding slots
    live = index >= 0
    rows = index.clamp_min(0).long()
    x = torch.rand(MS_TRAIN_SITES, n_obs, device="cuda", generator=g)
    fresh = torch.rand(MS_TRAIN_SITES, device="cuda", generator=g)
    results = {}

    want = torch.where(live, vals[rows], vals.new_zeros(()))[:, None].expand(-1, n_obs)
    results["site_gather (exact)"] = (mp.site_gather(vals, index, n_obs) - want).abs().max(), 0.0

    results["site_reduce"] = (mp.site_reduce(x) - x.sum(1)).abs().max(), 1e-5 * n_obs

    got, ref = vals.clone(), vals.clone()
    mp.site_update(got, index, fresh)
    ref[rows[live]] = fresh[live]
    same_bits = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    results["site_update (exact, other sites untouched)"] = (
        (got - ref).abs().max() if same_bits else torch.tensor(float("inf")), 0.0)

    acc, ref = torch.ones(n_sites, device="cuda"), torch.ones(n_sites, device="cuda")
    mp.site_chain(vals, index, x, acc)
    ref[rows[live]] += (vals[rows[live]][:, None] * x[live]).sum(1)
    results["site_chain"] = (acc - ref).abs().max(), 1e-5 * n_obs

    parts = torch.randn(500, 338, device="cuda", generator=g)
    first, second = mp.block_sum(parts), mp.block_sum(parts)
    repeat = torch.equal(first.view(torch.int32), second.view(torch.int32))
    results["block_sum (same bits on a second run)"] = (
        (first - parts.sum(0)).abs().max() if repeat else torch.tensor(float("inf")), 1e-4)

    # the two row sums at widths around a group of lanes and beyond a warp's reach
    for n in (1, 3, 63, 64, 65, 1000):
        xn = torch.rand(301, n, device="cuda", generator=g)
        idx = torch.randperm(400, device="cuda", generator=g)[:301].int()
        idx[::7] = -1
        on = idx >= 0
        sites = idx[on].long()
        results[f"site_reduce, {n} observations a site"] = (
            (mp.site_reduce(xn) - xn.sum(1)).abs().max(), 1e-5 * n)
        acc, ref = torch.ones(400, device="cuda"), torch.ones(400, device="cuda")
        mp.site_chain(vals[:400].contiguous(), idx, xn, acc)
        ref[sites] += (vals[sites][:, None] * xn[on]).sum(1)
        results[f"site_chain, {n} observations a site"] = (acc - ref).abs().max(), 1e-5 * n

    worst = 0.0
    failed = []
    for what, (err, tol) in results.items():
        err = float(err)
        ok = err <= tol
        log("primitives", f"{what}: max |diff| {err:.3e} (tolerance {tol:.1e}) "
                          f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)
        elif tol > 0:
            worst = max(worst, err)
    if failed:
        raise AssertionError(f"primitives failed: {failed}")
    fns = {"kernel": lambda: mp.site_reduce(x), "plain": lambda: x.sum(1)}
    runs = {k: [] for k in fns}
    for i in range(5):  # in turns: kernel, plain, plain, kernel, ...
        for k in (list(fns) if i % 2 == 0 else list(reversed(list(fns)))):
            runs[k].append(device_ms(fns[k], 50, k))
    times = {k: statistics.median(v) for k, v in runs.items()}
    log("times", f"[{card}] site_reduce over {MS_TRAIN_SITES} x {n_obs}, median of 5, device ms: "
                 + ", ".join(f"{k} {v:.5f}" for k, v in times.items())
                 + " (plain: torch.sum(x, 1), the library call)")
    if times["kernel"] > times["plain"]:
        raise AssertionError(f"site_reduce takes {times['kernel']:.5f} ms, torch.sum(x, 1) "
                             f"{times['plain']:.5f}: the kernel must not lose to the library call")
    return worst, times


def multisite_cases():
    """Kernel 5's cases: the main path's shape first, then its edges."""
    mini = dict(S=300, N=8, batch=128, epochs=3)
    return [
        dict(what=f"main path: {MS_TRAIN_SITES} sites x {MS_OBS}, [16,16] swish, static norm, "
                  "adam, one site batch, 4 epochs", S=MS_TRAIN_SITES, N=MS_OBS, epochs=4),
        dict(what="S=150 N=7 (sites do not fill a tile)", S=150, N=7),
        dict(what="10% NaN targets, N=200 (a site longer than a tile)", S=64, N=200, nan_frac=0.1),
        dict(what="a site batch without a valid target (batch 128 of 300)", mask_batch=1, **mini),
        *[dict(what=f"minibatched S=300 batch 128, shuffle {sh!r} (ragged last batch)",
               shuffle=sh, **mini) for sh in (True, False, "batches")],
        dict(what="sgd, mae, agg mean", S=300, N=8, opt=("sgd", 0.05), loss="mae", agg="mean"),
        dict(what="nseLoss, minibatched and shuffled", loss="nseLoss", shuffle=True, **mini),
        dict(what="no input norm", S=300, N=8, norm=False),
        dict(what="[64,48] selu", S=300, N=9, hidden=(64, 48), activation="selu"),
        dict(what="neural Q10, per-site rb", S=300, N=8,
             neural_param_names=["Q10"], global_param_names=["rb"]),
        # the edges of the gradient kernel's geometry
        dict(what="N=1000 (a site over four tiles)", S=30, N=1000),
        dict(what="N=1 (256 sites a tile)", S=700, N=1),
        # two per-site globals (rb, Q10; the network gives tref): more of a tile's
        # sites' globals than it has threads
        dict(what="two per-site globals, N=1: 512 globals for a tile of 256 rows", S=700, N=1,
             **TWO_GLOBALS),
        dict(what="two per-site globals, N=1, 20 sites: 40 globals for a tile of 32 rows", S=20,
             N=1, **TWO_GLOBALS),
        dict(what="N=3, minibatched and shuffled", S=500, N=3, batch=128, shuffle=True),
        dict(what="N=63", S=300, N=63),
        dict(what="N=65, batches of 100 by 'batches' (a ragged last block)", S=301, N=65,
             batch=100, shuffle="batches"),
        dict(what="3,000 sites x 64, 750 blocks (eight a multiprocessor aimed at, beyond the "
                  "first kernel's cap of 528)", S=3000, N=64, epochs=1, target_blocks=8 * 132),
        # every optimizer rule, minibatched (9 steps; lamb's per-site leaves over every block)
        *[dict(what=f"{opt}: minibatched S=300 batch 128, shuffled", opt=opt, shuffle=True,
               **mini) for opt in RULES],
        # the main path's width under the rules with state of their own
        *[dict(what=f"main path's width under {opt}: {MS_TRAIN_SITES} sites x {MS_OBS}, one site "
                    "batch, 4 epochs", S=MS_TRAIN_SITES, N=MS_OBS, epochs=4, opt=opt)
          for opt in (("amsgrad", 0.01), ("lamb", 0.01))],
    ]


def prepare_multisite_case(et, *, what, S, N, batch=None, epochs=2, opt=("adam", 0.01),
                           loss="mse", agg="sum", shuffle=False, nan_frac=0.1, mask_batch=None,
                           seed=0, target_blocks=None, **model_kw):
    from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

    model = multisite_model(et, S, seed=seed, **model_kw)
    data = et.gen_multisite_arrays(S, N, seed=seed, nan_frac=nan_frac, site_idx=True)
    if mask_batch is not None:
        data.y["reco"][mask_batch * batch:(mask_batch + 1) * batch] = np.nan
    et.fit_input_norm(model, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch or S), "cuda")
    logging = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    aim = {} if target_blocks is None else dict(target_blocks=target_blocks)
    fn = et.make_fused_multisite_epoch(model, opt, logging, shuffle=shuffle, epochs_per_call=epochs,
                                       **aim)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    return what, fn, fn.plan.pack(model), tensors, perms


def multisite_kernel_checks(et) -> float:
    """Phase 10: kernel 5 against its plain version, and against itself."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    def named(packed, opt_state, loss, n_shared):
        return {"shared": packed.params[:n_shared], "per-site": packed.params[n_shared:],
                **slots(opt_state), "loss": loss.reshape(1)}

    worst = 0.0
    for case in multisite_cases():
        what, fn, packed, tensors, perms = prepare_multisite_case(et, **case)
        n_shared = fn.plan.offsets()["p_g"]
        got = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms), n_shared)
        torch.cuda.synchronize()
        again = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms), n_shared)
        geo = fn.geometry(tensors)
        ref = named(*fn.reference(packed, fresh_state(fn, packed), tensors, perms=perms),
                    n_shared)
        if not all(bool(torch.isfinite(v).all()) for v in got.values()):
            raise AssertionError(f"{what}: the kernel returned non-finite values")
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise AssertionError(f"{what}: a second run from the same inputs gave other bits")
        err = compare(got, ref, what, TOL_EPOCH)
        worst = max(worst, err)
        log("kernel5", f"{what}: width {fn.plan.width}, {geo}, {int(got['t'][0])} steps, max "
                       f"|diff| {err:.3e}, second run bitwise equal (ok)")
    return worst


def multisite_table(et):
    """The long table of the main path: every site's rows from
    ``rbq10_columns`` with the site's own true Q10, drawn from [1.4, 2.8]."""
    rng = np.random.default_rng(7)
    q10_true = rng.uniform(1.4, 2.8, MS_SITES)
    names = ("sw_pot", "dsw_pot", "ta", "reco")
    parts = {k: [] for k in names}
    for s in range(MS_SITES):
        cols = et.rbq10_columns(MS_OBS, seed=7 + s, true_q10=float(q10_true[s]))
        for k in names:
            parts[k].append(cols[k])
    table = {k: np.concatenate(v) for k, v in parts.items()}
    table["site"] = np.repeat(np.arange(MS_SITES, dtype=np.int32), MS_OBS)
    return table, q10_true


def multisite_main_path(et, card) -> dict:
    """Phase 11: multi-site ``train()`` through the normal entry points."""
    from easyhybrid_tpu_torch.ops import fused_multisite as fm
    from easyhybrid_tpu_torch.ops import multisite_primitives as mp
    from easyhybrid_tpu_torch.training import train as train_module

    t0 = time.perf_counter()
    table, q10_true = multisite_table(et)
    table_s = time.perf_counter() - t0
    model = multisite_model(et, MS_SITES)
    t0 = time.perf_counter()
    data = et.prepare_multisite_data(model.base, table, "site")
    prepare_s = time.perf_counter() - t0
    if data.x.shape != (MS_SITES, MS_OBS, 2):
        raise AssertionError(f"prepare_multisite_data gave x of shape {data.x.shape}")

    gate_launches, gate_s = [], []
    real_gate = train_module.fused_exactness_check

    def gate_then_reset(*args, **kwargs):
        """The gate's own launches are counted apart from the main path's."""
        t_gate = time.perf_counter()
        out = real_gate(*args, **kwargs)
        torch.cuda.synchronize()
        gate_s.append(time.perf_counter() - t_gate)
        gate_launches.append((fm.launch_fused_multisite.launches, mp.launch_primitive.launches))
        fm.launch_fused_multisite.launches = mp.launch_primitive.launches = 0
        return out

    train_module.fused_exactness_check = gate_then_reset
    fm.launch_fused_multisite.launches = mp.launch_primitive.launches = 0
    try:
        t0 = time.perf_counter()
        result = et.train(model, data, **MS_TRAIN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, prim_launches = fm.launch_fused_multisite.launches, mp.launch_primitive.launches
    finally:
        train_module.fused_exactness_check = real_gate
    if (result.epoch_path != "cuda_fused_multisite"
            or "exactness gate passed" not in result.engine_reason):
        raise AssertionError(f"train() took {result.epoch_path!r}: {result.engine_reason}")
    expected = MS_TRAIN_KW["nepochs"] // MS_TRAIN_KW["eval_every"]
    if launches != expected or prim_launches < expected:
        raise AssertionError(f"train() called kernel 5's launcher {launches} times (expected "
                             f"{expected}) and the primitives {prim_launches} times")
    pred = result.val_pred_columns["reco_pred"]
    n_val = (MS_SITES - MS_TRAIN_SITES) * MS_OBS
    if pred.shape != (n_val,) or not np.isfinite(pred).all():
        raise AssertionError(f"val predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    q10 = et.scale_param(result.params["globals.Q10"], 1.0, 4.0).numpy().ravel()
    if q10.shape != (MS_SITES,) or not np.isfinite(q10).all():
        raise AssertionError(f"per-site Q10: shape {q10.shape}")
    corr = float(np.corrcoef(q10[:MS_TRAIN_SITES], q10_true[:MS_TRAIN_SITES])[0, 1])
    err = float(np.abs(q10[:MS_TRAIN_SITES] - q10_true[:MS_TRAIN_SITES]).mean())
    untouched = float(np.abs(q10[MS_TRAIN_SITES:] - 2.0).max())  # validation sites see no gradient
    if not (corr > 0.8 and untouched < 1e-6 and np.isfinite(result.best_loss)):
        raise AssertionError(f"per-site Q10 of the training sites: correlation {corr:.3f} with the "
                             f"truth (need > 0.8), validation sites moved by {untouched:.2e}")
    log("main", f"multi-site train(): {MS_SITES} sites x {MS_OBS} observations, "
                f"{result.epoch_path}, {result.engine_reason}; {launches} launcher calls and "
                f"{prim_launches} primitive launches after the gate's {gate_launches}; per-site "
                f"Q10 of the {MS_TRAIN_SITES} training sites: correlation {corr:.4f} with the "
                f"truth, mean |err| {err:.4f}; best val mse {result.best_loss:.5f} at epoch "
                f"{result.best_epoch}; {wall:.2f} s wall, {gate_s[0]:.2f} s of it the gate (ok)")

    # the minibatched, shuffled shape of the JAX bench's second multi-site row
    mini_model = multisite_model(et, 10_240, norm=False)
    mini_data = et.gen_multisite_arrays(10_240, MS_OBS, seed=0)
    before = fm.launch_fused_multisite.launches
    t0 = time.perf_counter()
    mini = et.train(mini_model, mini_data, nepochs=4, eval_every=2, batchsize=2_560,
                    optimizer=("adam", 0.01), shuffle_each_epoch=True, show_progress=False)
    torch.cuda.synchronize()
    mini_wall = time.perf_counter() - t0
    if mini.epoch_path != "cuda_fused_multisite" or not np.isfinite(mini.best_loss):
        raise AssertionError(f"minibatched train() took {mini.epoch_path!r}: {mini.engine_reason}")
    steps = int(mini.opt_state["t"][0])
    if steps != 4 * 4:  # 8,192 training sites in 4 batches of 2,560, 4 epochs
        raise AssertionError(f"minibatched train() took {steps} optimizer steps, not 16")
    log("main", f"minibatched multi-site train(): 10,240 sites, batches of 2,560, shuffled: "
                f"{mini.epoch_path}, {mini.engine_reason}; "
                f"{fm.launch_fused_multisite.launches - before} launcher calls (gate included), "
                f"{steps} steps, best val mse {mini.best_loss:.5f}; {mini_wall:.2f} s wall (ok)")
    return dict(launches=launches, primitive_launches=prim_launches, wall=wall, data=data,
                table_s=table_s, prepare_s=prepare_s)


def multisite_times(et, card, main, stamped) -> dict:
    """Phase 12: kernel 5 against its plain version per step, a step split
    by stage (``stamped``: the build with ``-DEHM_STAMPS``); ``train()`` wall
    on both engines; the host's share."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe
    from easyhybrid_tpu_torch.ops import fused_multisite as fm

    case = {**multisite_cases()[0], "epochs": 5}
    what, fn, packed, tensors, perms = prepare_multisite_case(et, **case)
    opt0 = fe.init_fused_opt_state(packed)
    one = prepare_multisite_case(et, **{**case, "epochs": 1})[1]
    calls = {"kernel": lambda: fn(packed, opt0, tensors),
             "plain": lambda: one.reference(packed, opt0, tensors)}
    for f in calls.values():
        host_ms(f, 2)  # warm-up
    dev = {"kernels": [], "grad": [], "update": [], "call": [], "plain": []}
    wall = {"kernel": [], "plain": []}
    for i in range(5):
        # one trace for the two kernels and their sum
        split = kernel_split_ms(calls["kernel"], 4, "eh_ms_", ("eh_ms_grad", "eh_ms_update"))
        dev["kernels"].append(split["all"] / 5)
        for part in ("grad", "update"):
            dev[part].append(sum(v for k, v in split.items() if k.startswith(part)) / 5)
        dev["call"].append(device_ms(calls["kernel"], 10, "kernel 5") / 5)
        dev["plain"].append(profiled_device_ms(calls["plain"], 2))
        for k in (list(wall) if i % 2 == 0 else list(reversed(list(wall)))):
            wall[k].append(host_ms(calls[k], 4) / (5 if k == "kernel" else 1))
    med = {k: statistics.median(v) for k, v in dev.items()}
    wall_ms = {k: statistics.median(v) for k, v in wall.items()}
    samples = MS_TRAIN_SITES * MS_OBS
    log("times", f"[{card}] kernel 5, one step over {MS_TRAIN_SITES} sites x {MS_OBS} = {samples} "
                 f"samples ({what}), median of 5, device ms per step: the two kernels "
                 f"{med['kernels']:.4f} (profiler; gradient kernel {med['grad']:.4f}, update "
                 f"kernel {med['update']:.4f}), the whole wrapper call {med['call']:.4f} "
                 f"(5-epoch calls behind a sleep kernel), plain version {med['plain']:.4f} "
                 f"(profiler); wall ms per step: kernel {wall_ms['kernel']:.4f}, plain "
                 f"{wall_ms['plain']:.4f}")
    fm.stage_cycles(fn, packed, opt0, tensors)  # warm-up
    cycles = fm.stage_cycles(fn, packed, opt0, tensors)
    whole = cycles.pop("kernel")
    if whole <= 0 or any(v < 0 for v in cycles.values()):
        raise AssertionError(f"the stamped build of kernel 5 returned {cycles}, {whole}")
    log("times", f"[{card}] kernel 5, a step split by stage (thread 0 of block 0, clock64() in a "
                 f"build with -DEHM_STAMPS, nvcc {stamped.seconds:.1f} s): cycles a step and share "
                 "of the block's time: "
                 + ", ".join(f"{k} {v / 5:.0f} ({v / whole:.1%})" for k, v in cycles.items())
                 + f"; the block {whole / 5:.0f} cycles a step")

    torch_model = multisite_model(et, MS_SITES)
    t0 = time.perf_counter()
    torch_result = et.train(torch_model, main["data"], use_kernel=False, **MS_TRAIN_KW)
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    if torch_result.epoch_path != "torch":
        raise AssertionError(f"use_kernel=False took {torch_result.epoch_path!r}")
    # the first fused call also paid what a process pays once (the first autograd
    # step, the first matrix product); a second one, after the torch run, does not
    t0 = time.perf_counter()
    again = et.train(multisite_model(et, MS_SITES), main["data"], **MS_TRAIN_KW)
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    if again.epoch_path != "cuda_fused_multisite":
        raise AssertionError(f"the second fused train() took {again.epoch_path!r}")
    log("times", f"[{card}] multi-site train() wall, {MS_TRAIN_KW['nepochs']} epochs of one step "
                 f"over {samples} samples + an evaluation every {MS_TRAIN_KW['eval_every']}: "
                 f"cuda_fused_multisite {main['wall']:.2f} s in the first call and "
                 f"{again_wall:.2f} s in a second one (gate included), torch "
                 f"{torch_wall:.2f} s (best val mse {torch_result.best_loss:.5f}); the host "
                 f"before train(): building the {MS_SITES * MS_OBS}-row table "
                 f"{main['table_s']:.2f} s, prepare_multisite_data over {MS_SITES} site ids "
                 f"{main['prepare_s']:.2f} s")
    return dict(kernel_ms=med["kernels"], plain_ms=med["plain"], samples=samples)


# kernel 4 after at most 4 epochs: max |got - ref| <= TOL_EPOCH * max(1, |ref|)
# on parameters, moments, step count and loss. Each step is a chain of T cells
# forward and T backward on CUDA's expf / tanhf against torch's, and each step
# starts from the last one's result, as kernel 2's
LSTM_ROWS, LSTM_WINDOW = 4_000, dict(input_window=10, output_window=1, lead_time=0)
LSTM_TRAIN_KW = dict(nepochs=30, batchsize=128, optimizer=("adam", 0.01), training_loss="nseLoss",
                     loss_types=["nseLoss", "mse"], show_progress=False,
                     sequence_kwargs=LSTM_WINDOW)
# the same run on the torch engine on a CPU (float32, torch 2.x) ends with a
# best validation nseLoss of 0.002574 (validation mse 0.010915 on a noise
# floor of 0.01, Q10 2.0016); the limit leaves a factor of four
LSTM_VAL_LIMIT = 0.01


def lstm_model(et, hidden=16, norm="static", seed=0):
    return build_model(et, hidden={"lstm": hidden}, norm=norm, seed=seed)


def lstm_cases():
    """Kernel 4's cases: the main path's shape first, then its edges."""
    return [
        dict(what="main path's training rows: LSTM(16), 10-step windows, output window 1, static "
                  "norm, adam, nseLoss, batch 128, shuffled, 4 epochs", epochs=4,
             keep=int(LSTM_ROWS * 0.8)),
        dict(what="LSTM(8), 6-step windows, output window 2, no norm, sgd, mae, unshuffled",
             hidden=8, steps=6, out_steps=2, norm=False, opt=("sgd", 0.05), loss="mae",
             shuffle=False, n=600, epochs=3),
        dict(what="30% NaN targets, batch 100 (ragged last batch), mse, agg mean",
             nan_frac=0.3, batch=100, loss="mse", agg="mean", n=1500),
        dict(what="first two batches without a valid target, unshuffled", shuffle=False,
             mask_first=2 * 128 + 9, n=1033),
        dict(what="every step has a target (output window 10), shuffle 'batches'",
             out_steps=10, shuffle="batches", loss="mse", n=1500),
        dict(what="LSTM(32), 12-step windows", hidden=32, steps=12, n=1000, epochs=1),
        dict(what="LSTM(64), 10-step windows", hidden=64, n=400, epochs=1),
        dict(what="the JAX bench's shape: batch 512, no norm, mse", batch=512, norm=False,
             loss="mse", n=LSTM_ROWS, epochs=1, seed=42),
        dict(what="batch 1,000: more windows than a cluster holds at once", batch=1000, loss="mse",
             n=3000, epochs=1),
        # every optimizer rule: 8 batches of 128 over a cluster, lamb's leaves straddling the
        # blocks' slices
        *[dict(what=f"{opt}: LSTM(16), mse, N=1000 batch 128, 1 epoch", opt=opt, loss="mse",
               n=1000, epochs=1, seed=i) for i, opt in enumerate(RULES)],
        dict(what="main path's training rows under rmsprop (the reference's rule), 4 epochs",
             epochs=4, keep=int(LSTM_ROWS * 0.8), opt=("rmsprop", 0.001)),
    ]


def prepare_lstm_case(et, *, what, hidden=16, steps=10, out_steps=1, batch=128, norm="static",
                      opt=("adam", 0.01), loss="nseLoss", agg="sum", shuffle=True, epochs=2,
                      n=LSTM_ROWS, keep=None, nan_frac=0.0, mask_first=0, seed=0, cols=None):
    """The case's fused epoch, its packed parameters on the card, its epoch
    tensors (windows with their NaN targets kept) and its permutations. Of
    ``n`` generated rows the first ``keep`` are cut into windows (all by
    default)."""
    from easyhybrid_tpu_torch.data.prepare import HybridData
    from easyhybrid_tpu_torch.data.sequences import split_into_sequences
    from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

    model = lstm_model(et, hidden, norm, seed)
    if cols is None:
        cols = et.rbq10_columns(n, seed=7 + seed, nan_frac=nan_frac)
        cols["reco"][:mask_first] = np.nan
        cols = {k: v[:keep] for k, v in cols.items()}
    rows = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    data = split_into_sequences(rows, input_window=steps, output_window=out_steps,
                                lead_time=0)
    et.fit_input_norm(model, data)
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), "cuda")
    logging = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    fn = et.make_fused_lstm_epoch(model, opt, logging, shuffle=shuffle, epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    return what, fn, fn.plan.pack(model), tensors, perms


def lstm_kernel_checks(et) -> float:
    """Phase 13: kernel 4 against its plain version and against itself, and
    which windows it takes."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe
    from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl

    def named(packed, opt_state, loss):
        return {"params": packed.params, "bn": packed.bn, **slots(opt_state),
                "loss": loss.reshape(1)}

    def run(case):
        what, fn, packed, tensors, perms = prepare_lstm_case(et, **case)
        got = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms))
        torch.cuda.synchronize()
        again = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms))
        ref = named(*fn.reference(packed, fresh_state(fn, packed), tensors, perms=perms))
        if not all(bool(torch.isfinite(v).all()) for v in got.values()):
            raise AssertionError(f"{what}: the kernel returned non-finite values")
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise AssertionError(f"{what}: a second run from the same inputs gave other bits")
        steps, out_steps = tensors.x.shape[2], tensors.y["reco"].shape[2]
        g = fn.plan.geometry(int(tensors.weight.shape[1]), int(steps), int(out_steps))
        return (compare(got, ref, what, TOL_EPOCH),
                f"{g.cluster} block(s) of {g.windows} windows x {g.tiles} tile(s), {g.lanes} lanes "
                f"a window, {g.threads} threads", int(got["t"][0]))

    worst = 0.0
    for case in lstm_cases():
        err, geometry, steps = run(case)
        worst = max(worst, err)
        log("kernel4", f"{case['what']}: {geometry}, {steps} steps, max |diff| {err:.3e}, "
                       f"second run bitwise equal (ok)")
        # 1,024 windows in 8 batches, two of them masked, 2 epochs
        if "mask_first" in case and steps != 2 * (8 - 2):
            raise AssertionError(f"{case['what']}: {steps} steps counted, not 12")

    model = lstm_model(et)
    logging = et.LoggingLoss(training_loss="nseLoss", loss_types=("nseLoss",))
    taken = {}
    for window in (10, 32, 64, 128, 256):
        tile = fl.lstm_tile_rows(model, window)
        taken[window] = tile
        if tile is None:
            cols = et.rbq10_columns(600, seed=7)
            tensors = prepare_lstm_case(et, what="", steps=window, cols=cols, epochs=1)[3]
            reason = fl.fused_epoch_lstm_unsupported_reason(model, ("adam", 0.01), logging, tensors)
            if reason is None:
                raise AssertionError(f"a {window}-step window has no tile and no refusal")
            log("kernel4", f"LSTM(16), {window}-step windows: refused ({reason})")
            continue
        err, used, steps = run(dict(what=f"LSTM(16), {window}-step windows", steps=window,
                                    n=900, epochs=1))
        worst = max(worst, err)
        log("kernel4", f"LSTM(16), {window}-step windows: taken, {used}, {steps} "
                       f"steps, max |diff| {err:.3e}, second run bitwise equal (ok)")
    if not all(taken[w] for w in (10, 32, 64)):
        raise AssertionError(f"the kernel refused a window of 10, 32 or 64 steps: {taken}")
    return worst


def lstm_main_path(et, card) -> dict:
    """Phase 14: sequence training through the normal entry points."""
    from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl

    cols = et.rbq10_columns(LSTM_ROWS, seed=7)
    model = lstm_model(et)
    with gate_counted_apart(fl.launch_fused_lstm) as gate_launches:
        t0 = time.perf_counter()
        result = et.train(model, cols, **LSTM_TRAIN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fl.launch_fused_lstm.launches
    if result.epoch_path != "cuda_fused_lstm" or "exactness gate passed" not in result.engine_reason:
        raise AssertionError(f"train() took {result.epoch_path!r}: {result.engine_reason}")
    if launches != LSTM_TRAIN_KW["nepochs"]:
        raise AssertionError(f"train() launched kernel 4 {launches} times, not "
                             f"{LSTM_TRAIN_KW['nepochs']} (one per eval block)")
    pred, obs = result.val_pred_columns, result.val_obs_columns
    n_val = len(obs["reco"])
    if (set(pred) != {"sample", "step", "reco_pred"} or pred["reco_pred"].shape != (n_val,)
            or not np.isfinite(pred["reco_pred"]).all() or set(pred["step"]) != {0}
            or n_val < LSTM_ROWS // 5 - 20):
        raise AssertionError(f"val predictions: columns {sorted(pred)}, {n_val} rows")
    q10 = float(et.scale_param(result.params["globals.Q10"], 1.0, 4.0))
    val_mse = result.val_history[result.best_epoch]["mse"]["reco"]
    if not (result.best_loss < LSTM_VAL_LIMIT and abs(q10 - 2.0) < 0.15):
        raise AssertionError(f"train() ended with best val nseLoss {result.best_loss:.5f} (limit "
                             f"{LSTM_VAL_LIMIT}) and Q10 {q10:.4f}")
    steps = int(result.opt_state["t"][0])
    log("main", f"sequence train(): {LSTM_ROWS} rows in 10-step windows, LSTM(16), "
                f"{result.epoch_path}, {result.engine_reason}; {launches} launches after the "
                f"gate's {gate_launches}, {steps} optimizer steps; best val nseLoss "
                f"{result.best_loss:.6f} at epoch {result.best_epoch} (limit {LSTM_VAL_LIMIT}; the "
                f"torch engine on a CPU: 0.002574), val mse {val_mse:.5f}, Q10 {q10:.4f}; "
                f"{n_val} validation predictions in the long format; {wall:.2f} s wall (ok)")
    return dict(launches=launches, wall=wall, cols=cols, steps=steps)


def lstm_step_bound(batch, steps, out_steps=1, hidden=16, features=2, outputs=1,
                    norm=True) -> dict:
    """The bound of one optimizer step over ``batch`` windows. Operations,
    each product 2 flops a weight: every cell's gate products forward and,
    backward, the weight gradients (``4H (F + H)`` weights each), the
    cotangent of the previous hidden state (``4H H``) and, only where an input
    norm's scale and bias are trained, that of the input (``4H F``): with a
    norm ``6 T 4H (F + H)`` a window; plus the head's three products at the
    trailing steps. Recomputing the gates in the backward pass is the
    kernel's choice and no part of the bound. Bytes: each window's
    predictors, the forcing, target and mask of its trailing steps and its
    index, once."""
    cell = 4 * hidden * (4 * (features + hidden) + 2 * hidden + (2 * features if norm else 0))
    flops = batch * (steps * cell + 6 * out_steps * outputs * hidden)
    return dict(bytes_moved=batch * 4 * (steps * features + 3 * out_steps + 1), flops=flops)


def lstm_times(et, card, main, chain_build) -> dict:
    """Phase 15: kernel 4 against its plain version per epoch at the main
    path's shape and at the JAX bench's, with the chain's floor (a build with
    its products stubbed out, when that build took under a minute);
    ``train()`` wall on both engines."""
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops import fused_epoch as fe
    from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl

    train_cols = {k: v[: int(LSTM_ROWS * 0.8)] for k, v in main["cols"].items()}
    shapes = {
        "main": dict(what="LSTM(16), 10-step windows, static norm, nseLoss, batch 128",
                     cols=train_cols, epochs=1),
        "bench": dict(what="LSTM(16), 10-step windows, no norm, mse, batch 512 (the JAX bench's "
                           "row)", cols=et.rbq10_columns(LSTM_ROWS, seed=42), norm=False,
                      loss="mse", batch=512, epochs=1),
    }
    out = {}
    for key, case in shapes.items():
        what, fn, packed, tensors, perms = prepare_lstm_case(et, **case)
        opt0 = fe.init_fused_opt_state(packed)
        calls = {"kernel": lambda: fn(packed, opt0, tensors, perms=perms),
                 "plain": lambda: fn.reference(packed, opt0, tensors, perms=perms)}
        for f in calls.values():
            host_ms(f, 2)  # warm-up
        dev = {"kernel": [], "kernel (profiler)": [], "plain (profiler)": []}
        wall = {"kernel": [], "plain": []}
        for i in range(5):
            dev["kernel"].append(device_ms(calls["kernel"], 5, "kernel 4"))
            dev["kernel (profiler)"].append(kernel_device_ms(calls["kernel"], 3, "eh_fused_lstm"))
            dev["plain (profiler)"].append(profiled_device_ms(calls["plain"], 1))
            for k in (list(wall) if i % 2 == 0 else list(reversed(list(wall)))):
                wall[k].append(host_ms(calls[k], 3 if k == "kernel" else 1))
        med = {k: statistics.median(v) for k, v in dev.items()}
        wall_ms = {k: statistics.median(v) for k, v in wall.items()}
        nb, batch = tensors.weight.shape
        b = bound(**lstm_step_bound(batch, 10, norm=case.get("norm", "static") is not False))
        floor = "not measured (its build took a minute or more)"
        if chain_build.seconds < 60:
            chain_lib = _build.measuring_library("fused_epoch_lstm.cu", "eh_fused_lstm",
                                                 "-DEHL_CHAIN_ONLY")
            data, rows = fn._make_data(fn.plan, tensors), fn.rows(tensors, perms)
            out_loss = torch.empty((1,), dtype=torch.float32, device="cuda")

            def chain():
                fl.launch_fused_lstm(fn.plan, fe.FusedParams(packed.params.clone(), packed.bn),
                                     {k: v.clone() for k, v in opt0.items()}, data, rows, out_loss,
                                     lib=chain_lib)

            host_ms(chain, 2)
            floor_ms = statistics.median(device_ms(chain, 5, "chain") for _ in range(3))
            floor = f"{floor_ms:.4f} ms ({floor_ms / nb * 1e3:.2f} us a step)"
        log("times", f"[{card}] kernel 4, one epoch of {nb} steps (batch {batch}, {what}), "
                     f"geometry {fn.plan.geometry(int(batch), 10, 1)}, median of 5: device ms per "
                     "epoch "
                     + ", ".join(f"{k} {v:.4f} ({v / nb:.4f} a step)" for k, v in med.items())
                     + "; wall ms per epoch "
                     + ", ".join(f"{k} {v:.3f}" for k, v in wall_ms.items())
                     + f"; bound {b['bound_ms'] * nb:.6f} ms per epoch ({b['bound_by']}); the "
                     f"chain with its products stubbed out (-DEHL_CHAIN_ONLY, nvcc "
                     f"{chain_build.seconds:.1f} s): {floor}")
        out[key] = dict(kernel_ms=med["kernel"], plain_ms=med["plain (profiler)"], steps=int(nb),
                        batch=int(batch))

    t0 = time.perf_counter()
    torch_result = et.train(lstm_model(et), main["cols"], use_kernel=False, **LSTM_TRAIN_KW)
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    if torch_result.epoch_path != "torch":
        raise AssertionError(f"use_kernel=False took {torch_result.epoch_path!r}")
    t0 = time.perf_counter()
    again = et.train(lstm_model(et), main["cols"], **LSTM_TRAIN_KW)
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    if again.epoch_path != "cuda_fused_lstm":
        raise AssertionError(f"the second fused train() took {again.epoch_path!r}")
    log("times", f"[{card}] sequence train() wall, {LSTM_TRAIN_KW['nepochs']} epochs of "
                 f"{out['main']['steps']} steps + an evaluation per epoch: cuda_fused_lstm "
                 f"{main['wall']:.2f} s in the first call and {again_wall:.2f} s in a second one "
                 f"(gate included; best val nseLoss {again.best_loss:.6f}), torch "
                 f"{torch_wall:.2f} s (best val nseLoss {torch_result.best_loss:.6f})")
    return out


# kernel 3, the wide tower. The small models of its cases are held like kernel
# 2's: max |got - ref| <= TOL_EPOCH * max(1, |ref|) on every parameter, moment
# and the loss. The tower is held in two parts. Its gradient, as one sgd step
# at lr 1e-3 implies it ((p0 - p) / lr), within TOL_EPOCH * max(1, |g|) on
# every one of its 700,422 elements: the kernels' tiled sums and cuBLAS's agree
# to rounding. Its Adam runs by a criterion of their own, because at Adam's
# first steps g / (sqrt(v) + eps) is +-1 whatever |g|, so an element whose
# gradient is at rounding level moves by a visible fraction of lr between two
# summation orders, and every later step starts from there: on an NVIDIA H100
# 80GB HBM3 one Adam step left 1 element of 700,422 beyond TOL_EPOCH (by
# 1.07e-4), 32 steps of 1,024 rows 457 parameters (worst 1.2e-3) and 431 first
# moments, 32 steps of 64 rows 2,084 first moments (worst 1.1e-2). The
# criterion: at most WIDE_ADAM_SHARE of the elements of the parameters and of
# each moment beyond TOL_EPOCH * max(1, |ref|), no parameter apart by more than
# 2 lr (one step's full swing), the loss within WIDE_LOSS_TOL * max(1, |ref|).
# The Adam runs are held to it against the plain version in float32 and
# against the plain version run in float64 on the same rows, except that the
# float32 plain version is no reference where it misses the criterion against
# its own float64 run. Such a run amplifies rounding: at batch 64, from its
# 25th step on, the float32 plain version on an H100 ends 292,642 parameters
# beyond TOL_EPOCH from float64, the same on a CPU 76,678, the float64 run
# started 2^-24 away 1,964 (tools/dev_fused_wide_gpu.py --drift).
WIDE_HIDDEN = (1024, 512, 256, 128, 64)
WIDE_ROWS, WIDE_BATCH = 20_480, 1024
WIDE_TRAIN_KW = dict(nepochs=20, batchsize=WIDE_BATCH, optimizer=("adam", 0.01),
                     show_progress=False)
WIDE_ADAM_SHARE = 0.01
WIDE_LOSS_TOL = 1e-3
# the same run on the torch engine on a CPU (float32) ends with a best
# validation mse of 0.010624 at epoch 20 (noise floor 0.01) and Q10 1.9923;
# the limit leaves a factor of three
WIDE_VAL_LIMIT = 0.03


def wide_cases(et, train_cols):
    """Kernel 3's cases: the main path's shape first, then its edges."""
    first = {k: v[:WIDE_BATCH] for k, v in train_cols.items()}
    masked = et.rbq10_columns(1024, seed=6)
    masked["reco"][:128] = np.nan  # the whole first (unshuffled) batch
    tower = dict(hidden=WIDE_HIDDEN, act="swish", norm="static", cols=train_cols,
                 batch=WIDE_BATCH, seed=0)
    small = dict(hidden=(128, 64), act="swish", norm="static", opt=("adam", 0.01), seed=1)
    return [
        dict(what="tower [1024,512,256,128,64], the gradient: one sgd step at lr 1e-3 over the "
                  "first 1,024 rows", opt=("sgd", 1e-3), shuffle=False, epochs=1, held="gradient",
             **{**tower, "cols": first}),
        dict(what="tower, main path: 16,384 rows, batch 1,024, adam, static norm, shuffled, "
                  "2 epochs", opt=("adam", 0.01), shuffle=True, epochs=2, held="adam", **tower),
        dict(what="tower, batch 64 (1,024 rows), adam, shuffled, 2 epochs", opt=("adam", 0.01),
             shuffle=True, epochs=2, held="adam", **{**tower, "cols": first, "batch": 64}),
        dict(what="[100,37] tanh (no multiple of the tile), N=777 batch 100 (ragged), 2 epochs",
             cols=et.rbq10_columns(777, seed=2), hidden=(100, 37), act="tanh", norm="static",
             opt=("adam", 0.01), shuffle=True, epochs=2, batch=100, seed=2),
        # lr 1e-3: on raw predictors (hundreds) sgd at 0.05 diverges (the loss rises) and
        # amplifies rounding until float32 itself is the limit: after 8 such steps the plain
        # version was 1.2e-4 from its own float64 run and the kernel 2.4e-5 (H100)
        dict(what="[128,64] mae, sgd at 1e-3, no norm, unshuffled, N=1000 batch 256",
             cols=et.rbq10_columns(1000, seed=3), shuffle=False, epochs=2, batch=256, loss="mae",
             **{**small, "norm": False, "opt": ("sgd", 1e-3)}),
        dict(what="[128,64] 30% NaN targets, agg mean, N=1000 batch 300 (ragged last batch)",
             cols=et.rbq10_columns(1000, seed=4, nan_frac=0.3), keep_nan=True, shuffle=True,
             epochs=2, batch=300, agg="mean", **small),
        dict(what="[128,64] first batch fully masked, unshuffled, N=1024 batch 128", cols=masked,
             keep_nan=True, shuffle=False, epochs=1, batch=128, **small),
        dict(what="[65] gelu, shuffle 'batches', N=2000 batch 300",
             cols=et.rbq10_columns(2000, seed=5), hidden=(65,), act="gelu", norm="static",
             opt=("adam", 0.01), shuffle="batches", epochs=2, batch=300, seed=5),
        # every optimizer rule: tensor-core and FMA layers, lamb's leaves over many update
        # blocks; 8 steps
        *[dict(what=f"{opt}: [128,64] swish, N=1000 batch 256, 2 epochs",
               cols=et.rbq10_columns(1000, seed=30 + i), shuffle=True, epochs=2, batch=256,
               **{**small, "opt": opt, "seed": 30 + i}) for i, opt in enumerate(RULES)],
        # the tower under adamw and lamb, held to the Adam runs' criterion
        *[dict(what=f"tower, main path: 16,384 rows, batch 1,024, {opt}, static norm, shuffled, "
                    "2 epochs", opt=opt, shuffle=True, epochs=2, held="adam", **tower)
          for opt in (("adamw", 0.01), ("lamb", 0.01))],
    ]


def prepare_wide_case(et, *, held="strict", **case):
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    return prepare_epoch_case(et, fe, make=et.make_fused_wide_epoch, **case)


def beyond(got, ref, tol):
    """``(elements beyond tol * max(1, |ref|), all elements, largest |diff|)``."""
    diff = (got.float() - ref.float()).abs()
    out = diff > tol * ref.float().abs().clamp_min(1.0)
    return int(out.sum()), diff.numel(), float(diff.max()) if diff.numel() else 0.0


def adam_misses(got, ref, lr):
    """``(notes, misses, largest |diff|)``: ``got`` against ``ref`` under the
    Adam runs' criterion, elements beyond TOL_EPOCH per vector and the loss."""
    notes, misses, worst = [], [], 0.0
    for key in ("params", "m", "v"):
        out, total, err = beyond(got[key].double(), ref[key].double(), TOL_EPOCH)
        worst = max(worst, err)
        notes.append(f"{key} {out} beyond (max |diff| {err:.3e})")
        if out > WIDE_ADAM_SHARE * total:
            misses.append(f"{key}: {out} of {total} beyond, more than {WIDE_ADAM_SHARE:.0%}")
        if key == "params" and err > 2 * lr:
            misses.append(f"a parameter {err:.3e} apart, more than 2 lr")
    g, r = float(got["loss"].reshape(())), float(ref["loss"].reshape(()))
    notes.append(f"loss {g:.6f} against {r:.6f}")
    if not abs(g - r) <= WIDE_LOSS_TOL * max(1.0, abs(r)):
        misses.append(f"the loss {g:.6f} against {r:.6f}, beyond {WIDE_LOSS_TOL} x max(1, |ref|)")
    return ", ".join(notes), misses, worst


def wide_reference64(fn, packed, tensors, perms) -> dict:
    """Kernel 3's plain version run in float64 on the case's rows."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe
    from easyhybrid_tpu_torch.ops import fused_wide as fw

    data = fn._make_data(fn.plan, tensors)
    as64 = lambda cols: tuple(c.double() for c in cols)  # noqa: E731
    data64 = fe.FusedData(data.x.double(), as64(data.forcing), as64(data.y), as64(data.mask),
                          data.n_batches, data.batch)
    o = fresh_state(fn, packed)
    p, o, loss = fw.fused_wide_reference(
        fn.plan, fe.FusedParams(packed.params.double(), packed.bn.double()),
        {k: v if k == "t" else v.double() for k, v in o.items()}, data64,
        fn.rows(tensors, perms))
    return {"params": p.params, **fe.opt_slots(o), "loss": loss.reshape(1)}


def wide_geometry_note(fn, batch) -> str:
    """The plan's route, tile and pieces for each layer's products."""
    from easyhybrid_tpu_torch.ops import fused_wide as fw

    notes = []
    for l, geo in enumerate(fw.wide_geometry(fn.plan.dims, batch)):
        prods = ", ".join(f"{what} {prod.bm}x{prod.bn}/{prod.splits}" for what, prod in
                          (("fwd", geo.forward), ("data", geo.data), ("wgt", geo.weight)))
        notes.append(f"L{l} {'TC' if geo.route == fw.TENSOR_CORES else 'FMA'} ({prods})")
    return "; ".join(notes)


def wide_kernel_checks(et, train_cols) -> float:
    """Phase 16: kernel 3 against its plain version, and against itself."""
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    def named(packed, opt_state, loss):
        return {"params": packed.params, "bn": packed.bn, **slots(opt_state),
                "loss": loss.reshape(1)}

    worst = 0.0
    for case in wide_cases(et, train_cols):
        held = case.get("held", "strict")
        what, fn, packed, tensors, perms = prepare_wide_case(et, **case)
        got = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms))
        torch.cuda.synchronize()
        again = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms))
        ref = named(*fn.reference(packed, fresh_state(fn, packed), tensors, perms=perms))
        if not all(bool(torch.isfinite(v).all()) for v in got.values()):
            raise AssertionError(f"{what}: the kernel returned non-finite values")
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise AssertionError(f"{what}: a second run from the same inputs gave other bits")
        steps = int(got["t"][0])
        if steps != int(ref["t"][0]):
            raise AssertionError(f"{what}: {steps} steps counted, the plain version "
                                 f"{int(ref['t'][0])}")
        if held == "gradient":
            lr = dict(fn.plan.hyper)["learning_rate"]
            g_got, g_ref = (packed.params - got["params"]) / lr, (packed.params - ref["params"]) / lr
            err = compare({"gradient": g_got, "loss": got["loss"]},
                          {"gradient": g_ref, "loss": ref["loss"]}, what, TOL_EPOCH)
            worst = max(worst, err)
            log("kernel3", f"{what}: implied gradient of {g_ref.numel()} elements, largest "
                           f"|g| {float(g_ref.abs().max()):.3e}, max |diff| {err:.3e} within "
                           f"{TOL_EPOCH} x max(1, |g|) on every element, second run bitwise "
                           f"equal (ok)")
        elif held == "adam":
            lr = dict(fn.plan.hyper)["learning_rate"]
            ref64 = wide_reference64(fn, packed, tensors, perms)
            plain_note, plain_misses, _ = adam_misses(ref, ref64, lr)
            against = {"float64": ref64} if plain_misses else {"float32": ref, "float64": ref64}
            notes = []
            for name, r in against.items():
                note, misses, err = adam_misses(got, r, lr)
                notes.append(f"the kernel against the plain version in {name}: {note}")
                if misses:
                    raise AssertionError(f"{what}: {notes[-1]}: " + "; ".join(misses))
                worst = max(worst, err)
            if plain_misses:
                note = adam_misses(got, ref, lr)[0]
                notes.append(f"the kernel against the plain version in float32 (no reference "
                             f"here): {note}")
            log("kernel3", f"{what}: {steps} steps; " + "; ".join(notes) + "; the plain version "
                           f"in float32 against float64: {plain_note}"
                           + (f" (misses the criterion: {'; '.join(plain_misses)})"
                              if plain_misses else "") + f"; criterion: at most "
                           f"{WIDE_ADAM_SHARE:.0%} of the elements beyond {TOL_EPOCH} x max(1, "
                           f"|ref|), no parameter more than 2 lr apart, the loss within "
                           f"{WIDE_LOSS_TOL} x max(1, |ref|); second run bitwise equal (ok)")
        else:
            err = compare(got, ref, what, TOL_EPOCH)
            worst = max(worst, err)
            log("kernel3", f"{what}: {steps} steps, max |diff| {err:.3e}, second run bitwise "
                           "equal (ok)")
        log("kernel3", f"{what}: products {wide_geometry_note(fn, int(tensors.weight.shape[1]))}")
        if "fully masked" in what and steps != 7:
            raise AssertionError(f"{what}: {steps} steps counted, not 7")
    return worst


def wide_model(et):
    return build_model(et, hidden=WIDE_HIDDEN)


def wide_main_path(et, card, cols) -> dict:
    """Phase 17: wide-MLP training through the normal entry points."""
    from easyhybrid_tpu_torch.ops import fused_wide as fw

    model = wide_model(et)
    with gate_counted_apart(fw.launch_fused_wide) as gate_launches:
        t0 = time.perf_counter()
        result = et.train(model, cols, **WIDE_TRAIN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fw.launch_fused_wide.launches
    if result.epoch_path != "cuda_fused_wide" or "exactness gate passed" not in result.engine_reason:
        raise AssertionError(f"train() took {result.epoch_path!r}: {result.engine_reason}")
    if launches != WIDE_TRAIN_KW["nepochs"]:
        raise AssertionError(f"train() called kernel 3's launcher {launches} times, not "
                             f"{WIDE_TRAIN_KW['nepochs']} (one per eval block)")
    pred = result.val_pred_columns["reco_pred"]
    if pred.shape != (WIDE_ROWS // 5,) or not np.isfinite(pred).all():
        raise AssertionError(f"val predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    q10 = float(et.scale_param(result.params["globals.Q10"], 1.0, 4.0))
    steps = int(result.opt_state["t"][0])
    n_batches = WIDE_ROWS * 4 // 5 // WIDE_BATCH
    if steps != WIDE_TRAIN_KW["nepochs"] * n_batches:
        raise AssertionError(f"train() took {steps} optimizer steps, not "
                             f"{WIDE_TRAIN_KW['nepochs'] * n_batches}")
    if not (result.best_loss < WIDE_VAL_LIMIT and abs(q10 - 2.0) < 0.15):
        raise AssertionError(f"train() ended with best val mse {result.best_loss:.5f} (limit "
                             f"{WIDE_VAL_LIMIT}) and Q10 {q10:.4f}")
    log("main", f"wide train(): hidden {list(WIDE_HIDDEN)}, {WIDE_ROWS} rows in {n_batches} "
                f"batches of {WIDE_BATCH}, {result.epoch_path}, {result.engine_reason}; {launches} "
                f"launcher calls after the gate's {gate_launches}, {steps} optimizer steps; best "
                f"val mse {result.best_loss:.6f} at epoch {result.best_epoch} (limit "
                f"{WIDE_VAL_LIMIT}; the torch engine on a CPU: 0.010624), Q10 {q10:.4f}; "
                f"{len(pred)} finite validation predictions; {wall:.2f} s wall (ok)")
    return dict(launches=launches, wall=wall, steps=steps)


def wide_products(dims, batch):
    """``(what, m, n, k)`` of every layer product of a step of kernel 3."""
    out = []
    for l, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"layer {l} forward", batch, dout, din), (f"layer {l} data", batch, din, dout),
                (f"layer {l} weight", dout, din, batch)]
    return out


def wide_matmul_yardstick(dims, batch) -> dict:
    """Device ms of a step's layer products through torch.matmul, in float32
    and in TF32: a yardstick (the port never calls it)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"float32": 0.0, "tf32": 0.0}
    for _, m, n, k in wide_products(dims, batch):
        a = torch.randn(m, k, device="cuda", generator=g)
        b = torch.randn(k, n, device="cuda", generator=g)
        for name, tf32 in (("float32", False), ("tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            f = lambda: a @ b  # noqa: E731
            f()
            out[name] += statistics.median(device_ms(f, 20, "torch.matmul") for _ in range(3))
    torch.backends.cuda.matmul.allow_tf32 = False
    return out


def tensor_core_instructions(lib_path) -> dict:
    """``{kernel: count}`` of tensor-core instructions (``HGMMA``, or ``HMMA``
    on TF32) that ``cuobjdump -sass`` finds in each of kernel 3's kernels."""
    from easyhybrid_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if "eh_wide" in found.group(1) else None
            if name:
                out.setdefault(name, 0)
        elif name and ("HGMMA" in line or ("HMMA" in line and "TF32" in line)):
            out[name] += 1
    return out


def wide_times(et, card, main, cols, train_cols) -> dict:
    """Phase 18: kernel 3 against its plain version per epoch and step at the
    main shape and at batch 64; ``train()`` wall on both engines and the
    device's busy share of the fused one."""
    from torch.profiler import ProfilerActivity, profile

    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    tower = dict(hidden=WIDE_HIDDEN, act="swish", norm="static", opt=("adam", 0.01), shuffle=True,
                 epochs=1, seed=0, cols=train_cols)
    shapes = {"main": dict(what="batch 1,024", batch=WIDE_BATCH, **tower),
              "b64": dict(what="batch 64", batch=64, **tower)}
    out = {}
    for key, case in shapes.items():
        what, fn, packed, tensors, perms = prepare_wide_case(et, **case)
        opt0 = fe.init_fused_opt_state(packed)
        calls = {"kernel": lambda: fn(packed, opt0, tensors, perms=perms),
                 "plain": lambda: fn.reference(packed, opt0, tensors, perms=perms)}
        for f in calls.values():
            host_ms(f, 1)  # warm-up
        nb, batch = (int(v) for v in tensors.weight.shape)
        dev = {"kernel": [], "plain (profiler)": []}
        if key == "main":  # 353 launches a call: one call can wait behind a sleep kernel
            dev["kernel (events)"] = []
        wall = {"kernel": [], "plain": []}
        split = {}
        for i in range(5):
            split = kernel_split_ms(calls["kernel"], 2, "eh_wide_")
            dev["kernel"].append(split["all"])
            if key == "main":
                dev["kernel (events)"].append(device_ms(calls["kernel"], 1, "kernel 3"))
            dev["plain (profiler)"].append(profiled_device_ms(calls["plain"], 1))
            for k in (list(wall) if i % 2 == 0 else list(reversed(list(wall)))):
                wall[k].append(host_ms(calls[k], 2 if k == "kernel" else 1))
        med = {k: statistics.median(v) for k, v in dev.items()}
        wall_ms = {k: statistics.median(v) for k, v in wall.items()}
        dims = fn.plan.dims
        flops = nb * batch * 3 * forward_flops(dims)
        bytes_moved = nb * (batch * 4 * 6 + fn.plan.n_params * 4 * 6)
        b32 = bound(bytes_moved=bytes_moved, flops=flops)
        # the products on the tensor cores in 3xTF32: three TF32 products each
        by_bytes, by_tc = bytes_moved / PEAK_BYTES_PER_S * 1e3, 3 * flops / PEAK_TF32_FLOPS * 1e3
        b = {"bound_ms": max(by_bytes, by_tc),
             "bound_by": "bytes" if by_bytes >= by_tc else "operations"}
        yard = wide_matmul_yardstick(dims, batch)
        log("times", f"[{card}] kernel 3, one epoch of {nb} steps ({what}, tower "
                     f"{list(WIDE_HIDDEN)}), median of 5: device ms per epoch "
                     + ", ".join(f"{k} {v:.4f} ({v / nb:.4f} a step)" for k, v in med.items())
                     + "; its kernels in the last run: "
                     + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()) if k != "all")
                     + "; wall ms per epoch "
                     + ", ".join(f"{k} {v:.3f}" for k, v in wall_ms.items())
                     + f"; bound {b['bound_ms']:.4f} ms per epoch (3xTF32 on the tensor cores, "
                     f"{b['bound_by']}; float32 FMA {b32['bound_ms']:.4f}), "
                     f"{flops / med['kernel'] / 1e9:.2f} TFLOP/s of float32 products; the step's "
                     f"products through torch.matmul (a yardstick): float32 "
                     f"{yard['float32']:.4f} ms, TF32 {yard['tf32']:.4f} ms a step")
        log("times", f"[{card}] kernel 3, {what}: products {wide_geometry_note(fn, batch)}")

        out[key] = dict(kernel_ms=med["kernel"], plain_ms=med["plain (profiler)"], steps=nb,
                        batch=batch, bound=b, library_ms=nb * yard["float32"])

    from easyhybrid_tpu_torch.ops import _build

    counts = tensor_core_instructions(_build.build_library().path)
    products = {k: v for k, v in counts.items() if "tc_kernel" in k}
    if not products or not all(products.values()):
        raise AssertionError(f"tensor-core instructions in kernel 3's products: {products}")
    log("times", f"[{card}] kernel 3, tensor-core instructions (HGMMA, or HMMA on TF32) by "
                 "cuobjdump -sass in each kernel of the built library: "
                 + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))

    t0 = time.perf_counter()
    torch_result = et.train(wide_model(et), cols, use_kernel=False, **WIDE_TRAIN_KW)
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    if torch_result.epoch_path != "torch":
        raise AssertionError(f"use_kernel=False took {torch_result.epoch_path!r}")
    t0 = time.perf_counter()
    again = et.train(wide_model(et), cols, **WIDE_TRAIN_KW)
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    if again.epoch_path != "cuda_fused_wide":
        raise AssertionError(f"the second fused train() took {again.epoch_path!r}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        et.train(wide_model(et), cols, **WIDE_TRAIN_KW)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    log("times", f"[{card}] wide train() wall, {WIDE_TRAIN_KW['nepochs']} epochs of "
                 f"{out['main']['steps']} steps + an evaluation per epoch: cuda_fused_wide "
                 f"{main['wall']:.2f} s in the first call and {again_wall:.2f} s in a second one "
                 f"(gate included; best val mse {again.best_loss:.6f}), torch {torch_wall:.2f} s "
                 f"(best val mse {torch_result.best_loss:.6f}); a third fused call under the "
                 f"profiler: {traced_wall:.2f} s wall, {busy_s:.3f} s of device activities, "
                 f"busy {busy_s / traced_wall:.1%}")
    return out


def bits(t) -> torch.Tensor:
    """A float32 tensor's bits, on the host."""
    return t.detach().contiguous().view(torch.int32).cpu()


def launched_per_chunk(ff, fn, x, forcing) -> dict:
    """Kernel 1 launched once per chunk of ``fn.batch_size`` rows, the form
    of the first kernel's ``predict``: the reference for the bits of one
    launch over every chunk. Its launches are not counted."""
    names = fn.plan.output_names + fn.plan.neural_names
    out = {k: torch.empty((x.shape[0],), dtype=torch.float32, device=x.device) for k in names}
    counted = ff.launch_fused_forward.launches
    for start in range(0, x.shape[0], fn.batch_size):
        sl = slice(start, min(start + fn.batch_size, x.shape[0]))
        ff.launch_fused_forward(fn.plan, x[sl], {k: c[sl] for k, c in forcing.items()},
                                {k: v[sl] for k, v in out.items()})
    ff.launch_fused_forward.launches = counted
    torch.cuda.synchronize()
    return out


def predict_trace(fn, cols) -> dict:
    """One ``predict`` call under ``torch.profiler``: its wall ms, the device
    activities' ms (the busy share is their ratio) and its host-device
    copies. A trace without a kernel or without a copy in each direction
    (the profiler now and then drops records) is taken again, at most three
    times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(cols)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        copies = {d: sum(e.count for e in events if f"Memcpy {d}" in e.key) for d in ("HtoD", "DtoH")}
        if all(copies.values()) and any("Memcpy" not in e.key for e in events):
            break
    return dict(wall=wall, busy=sum(e.self_device_time_total for e in events) / 1e3,
                copies=sum(copies.values()))


def serving_times(et, ff, card, quick, x, forcing, cols) -> dict:
    """Phase 5: kernel 1 per launch at 1,024 and 131,072 rows against its
    plain version; ``predict`` rows/s, launches, copies and busy share on
    both engines."""
    fns, reps = {}, {}
    for rows in (BATCH, N_ROWS):
        one = et.make_fused_forward(quick, batch_size=rows)
        xs, fs = x[:rows].contiguous(), {k: v[:rows].contiguous() for k, v in forcing.items()}
        fns[f"kernel {rows} rows"] = (lambda one=one, xs=xs, fs=fs: one(xs, fs))
        fns[f"plain {rows} rows"] = (lambda one=one, xs=xs, fs=fs: one.reference(xs, fs))
        # the plain version is ~30 small kernels a call: 20 calls stay within the launch queue
        reps[f"kernel {rows} rows"], reps[f"plain {rows} rows"] = (50 if rows == BATCH else 20), 20
    dev = {k: [] for k in fns}
    for f in fns.values():
        host_ms(f, 3)  # warm-up
    for i in range(6):
        for k in (list(fns) if i % 2 == 0 else list(reversed(list(fns)))):
            dev[k].append(device_ms(fns[k], reps[k]))
    ms = {k: statistics.median(v) for k, v in dev.items()}
    log("times", f"[{card}] kernel 1, one launch, device ms per call, median of 6: "
                 + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()))

    plain_model = build_model(et, mechanistic=rbq10_untagged)
    plain_model.load_state_dict(quick.state_dict())
    engines = {
        f"cuda_fused_forward b{BATCH}": et.make_inference_fn(quick, batch_size=BATCH),
        f"torch b{BATCH}": et.make_inference_fn(plain_model, batch_size=BATCH),
        f"cuda_fused_forward b{N_ROWS}": et.make_inference_fn(quick, batch_size=N_ROWS),
        f"torch b{N_ROWS}": et.make_inference_fn(plain_model, batch_size=N_ROWS),
    }
    if engines[f"torch b{BATCH}"].engine != "torch":
        raise AssertionError("the untagged model should run the plain engine")
    walls = {k: [] for k in engines}
    for f in engines.values():
        f(cols)  # warm-up
    for i in range(6):
        for k in (list(engines) if i % 2 == 0 else list(reversed(list(engines)))):
            walls[k].append(host_ms(lambda: engines[k](cols), 1))
    rates = {k: N_ROWS / statistics.median(v) * 1e3 for k, v in walls.items()}
    traces = {}
    for k, f in engines.items():
        before = ff.launch_fused_forward.launches
        traces[k] = {**predict_trace(f, cols), "launches": ff.launch_fused_forward.launches - before}
    # the busy share: the device activities of a traced call over an untraced call's wall
    log("times", f"[{card}] end-to-end predict, {N_ROWS} rows from host columns, median of 6: "
                 + ", ".join(f"{k} {statistics.median(walls[k]):.3f} ms a call, {r:,.0f} rows/s "
                             f"({traces[k]['launches']} kernel-1 launches, {traces[k]['copies']} "
                             f"host-device copies, device busy {traces[k]['busy']:.3f} ms, "
                             f"{traces[k]['busy'] / statistics.median(walls[k]):.1%} of the call)"
                             for k, r in rates.items()))
    # one copy in per input array (x and each forcing), one copy out per output
    plan = one.plan
    want = 1 + len(plan.forcing_names) + len(plan.output_names) + len(plan.neural_names)
    for k in (f"cuda_fused_forward b{BATCH}", f"cuda_fused_forward b{N_ROWS}"):
        if traces[k]["launches"] != 1 or traces[k]["copies"] != want:
            raise AssertionError(f"{k}: {traces[k]['launches']} launches and "
                                 f"{traces[k]['copies']} copies a call, not 1 and {want}")
    return dict(kernel_ms=ms[f"kernel {N_ROWS} rows"], plain_ms=ms[f"plain {N_ROWS} rows"])


def main() -> None:
    # 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
                  f"torch {torch.__version__} CUDA {torch.version.cuda} | "
                  f"count {torch.cuda.device_count()}")

    import easyhybrid_tpu_torch as et
    from easyhybrid_tpu_torch.ops import _build
    from easyhybrid_tpu_torch.ops import fused_forward as ff

    # 2. build ----------------------------------------------------------------
    # kernel 2's stamped build (phase 8), kernel 5's (phase 12) and kernel 4's
    # chain-only build (phase 15) are made beside the library's
    pool = concurrent.futures.ThreadPoolExecutor(3)
    stamped_build = pool.submit(_build.build_variant, "fused_epoch.cu", ("-DEHE_STAMPS",))
    ms_stamped_build = pool.submit(_build.build_variant, "fused_multisite.cu", ("-DEHM_STAMPS",))
    chain_build = pool.submit(_build.build_variant, "fused_epoch_lstm.cu", ("-DEHL_CHAIN_ONLY",))
    pool.shutdown(wait=False)
    built = _build.build_library()
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS[:2])} -> {built.path.name} "
                 f"in {built.seconds:.2f} s (set-up), one nvcc per source in parallel: "
                 + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(built.source_seconds.items())))
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())
    _build.load_library()

    # 3. kernel against the plain version --------------------------------------
    cases = []
    cols = et.rbq10_columns(N_ROWS, seed=42)
    quick = build_model(et)
    x, forcing = to_device(et, quick, cols)
    cases.append(("quick-start [16,16] swish static N=131072 batch 1024", quick, x, forcing, BATCH))

    small = et.rbq10_columns(1000, seed=1)
    m = build_model(et, hidden=(8,), activation="tanh", norm=False, seed=1)
    cases.append(("[8] tanh no norm N=1000", m, *to_device(et, m, small), BATCH))

    odd = et.rbq10_columns(777, seed=2)
    for i, act in enumerate(sorted(et.ACTIVATIONS)):
        m = build_model(et, hidden=(12, 5), activation=act, seed=10 + i)
        cases.append((f"[12,5] {act} static N=777 batch 256", m, *to_device(et, m, odd), 256))
    for hidden in ((24, 32), (64, 48)):
        m = build_model(et, hidden=hidden, activation="selu", seed=3)
        cases.append((f"{list(hidden)} selu static N=777", m, *to_device(et, m, odd), BATCH))

    m = build_model(
        et, hidden=(16, 16), seed=4,
        parameters={**RBQ10_PARAMS, "tref": (15.0, 0.0, 30.0)},
        neural_param_names=["Q10"], global_param_names=["rb"],
    )
    cases.append(("neural Q10, global rb, fixed tref N=777", m, *to_device(et, m, odd), BATCH))

    nan_cols = et.rbq10_columns(4096, seed=5)
    nan_cols["sw_pot"][np.random.default_rng(5).random(4096) < 0.05] = np.nan
    m = build_model(et, seed=5)
    cases.append(("quick-start with 5% NaN predictor rows N=4096", m, *to_device(et, m, nan_cols), BATCH))

    # the edges of the launch: around a chunk and a block, at each compiled width
    for hidden in ((16, 16), (24, 32), (64, 48)):
        m = build_model(et, hidden=hidden, seed=6)
        for n in (1, 1023, 1024, 1025, N_ROWS):
            edge = et.rbq10_columns(n, seed=6)
            edge["sw_pot"][5::97] = np.nan
            edge["dsw_pot"][n - 1] = np.nan if n > 1 else edge["dsw_pot"][0]
            cases.append((f"{list(hidden)} swish static N={n} with NaN rows", m,
                          *to_device(et, m, edge), BATCH))

    kernel_err = 0.0
    for what, model, cx, cf, batch in cases:
        fn = et.make_fused_forward(model, batch_size=batch)
        got = fn(cx, cf)
        torch.cuda.synchronize()
        err = compare(got, fn.reference(cx, cf), what)
        kernel_err = max(kernel_err, err)
        chunked = launched_per_chunk(ff, fn, cx, cf)
        if not all(torch.equal(bits(got[k]), bits(chunked[k])) for k in got):
            raise AssertionError(f"{what}: one launch and a launch per chunk gave other bits")
        log("kernel", f"{what}: width {fn.plan.width}, max |diff| {err:.3e}, one launch equals a "
                      f"launch per chunk of {batch} bit for bit (ok)")

    # 4. main path --------------------------------------------------------------
    fn = et.make_inference_fn(quick, batch_size=BATCH)
    if fn.engine != "cuda_fused_forward":
        raise AssertionError(f"engine {fn.engine!r}: {fn.engine_reason}")
    ff.launch_fused_forward.launches = 0
    out = et.predict(quick, cols, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = ff.launch_fused_forward.launches
    expected = -(-N_ROWS // et.make_fused_forward(quick, batch_size=BATCH).group_rows)
    if launches != expected:
        raise AssertionError(f"predict launched the kernel {launches} times, not {expected}")
    if set(out) != {"reco", "rb"}:
        raise AssertionError(f"predict returned keys {sorted(out)}")
    for k, v in out.items():
        if v.shape != (N_ROWS,) or not np.isfinite(v).all():
            raise AssertionError(f"predict output {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    quick.eval()
    with torch.no_grad():
        plain = quick(x, forcing)
    main_err = compare(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {"reco": plain["reco"].cpu(), "rb": plain["parameters"]["rb"].cpu()},
        "predict against the plain module forward",
    )
    # the mechanistic relation itself, in float64 on the host
    q10 = et.scale_param(float(quick.globals.Q10.item()), 1.0, 4.0)
    reco64 = out["rb"].astype(np.float64) * q10 ** (0.1 * (cols["ta"].astype(np.float64) - 15.0))
    rel = float(np.max(np.abs(out["reco"] - reco64) / np.maximum(1.0, np.abs(reco64))))
    if rel > TOL:
        raise AssertionError(f"reco != rb * Q10^((ta - 15)/10): {rel:.3e}")
    # every batch size: the torch engine's keys and shapes, a launch per chunk's bits
    chunked = launched_per_chunk(ff, et.make_fused_forward(quick, batch_size=BATCH), x, forcing)
    for batch in (1, BATCH, N_ROWS):
        got = et.predict(quick, cols, batch_size=batch)
        keys = {"reco", "rb", "Q10"} if batch == 1 else {"reco", "rb"}
        if set(got) != keys or any(v.shape != (N_ROWS,) for v in got.values()):
            raise AssertionError(f"predict at batch_size {batch}: "
                                 f"{ {k: v.shape for k, v in got.items()} }")
        for k in ("reco", "rb"):
            if not torch.equal(bits(torch.from_numpy(got[k])), bits(chunked[k])):
                raise AssertionError(f"predict at batch_size {batch}: {k} differs in its bits "
                                     "from a launch per chunk")
    log("main", f"predict: engine {fn.engine}, {launches} launch(es) for {N_ROWS} rows at "
                f"batch_size {BATCH}, keys {sorted(out)}, max |diff| vs plain forward "
                f"{main_err:.3e}, relation err {rel:.3e}; at batch_size 1, {BATCH} and {N_ROWS} "
                "the torch engine's keys and shapes and a launch per chunk's bits (ok)")

    # 5. times --------------------------------------------------------------------
    serving = serving_times(et, ff, card, quick, x, forcing, cols)

    # 6. kernel 2 against the plain version --------------------------------------
    from easyhybrid_tpu_torch.ops import fused_epoch as fe

    quick_cols = et.rbq10_columns(TRAIN_ROWS, seed=42)
    epoch_err = 0.0
    for case in epoch_cases(et, quick_cols):
        what, fn, packed, tensors, perms = prepare_epoch_case(et, fe, **case)
        def named(p, o, l):
            return {"params": p.params, "bn": p.bn, **slots(o), "loss": l.reshape(1)}

        got = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms))
        torch.cuda.synchronize()
        again = named(*fn(packed, fresh_state(fn, packed), tensors, perms=perms))
        ref = named(*fn.reference(packed, fresh_state(fn, packed), tensors, perms=perms))
        if not all(bool(torch.isfinite(v).all()) for v in got.values()):
            raise AssertionError(f"{what}: the kernel returned non-finite values")
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise AssertionError(f"{what}: a second run from the same inputs gave other bits")
        err = compare(got, ref, what, TOL_EPOCH)
        epoch_err = max(epoch_err, err)
        g = fn.plan.geometry(int(tensors.weight.shape[1]))
        log("kernel2", f"{what}: width {fn.plan.width}, {g.cluster} block(s) of {g.threads} "
                       f"threads, {g.tiles} tile(s) of {g.tile} rows, stages {g.stages}, slots "
                       f"{'shared' if g.moments_shared else 'in device memory'}, "
                       f"{int(got['t'][0])} steps, max |diff| {err:.3e}, second run bitwise "
                       "equal (ok)")

    # 7. main path: train() ------------------------------------------------------
    model = build_model(et, norm=True, seed=0)
    with gate_counted_apart(fe.launch_fused_epoch) as gate_launches:
        t0 = time.perf_counter()
        result = et.train(model, quick_cols, **TRAIN_KW)
        torch.cuda.synchronize()
        fused_wall = time.perf_counter() - t0
        epoch_launches = fe.launch_fused_epoch.launches
    if result.epoch_path != "cuda_fused_epoch" or "exactness gate passed" not in result.engine_reason:
        raise AssertionError(f"train() took {result.epoch_path!r}: {result.engine_reason}")
    expected_launches = TRAIN_KW["nepochs"] // TRAIN_KW.get("eval_every", 1)
    if epoch_launches != expected_launches:
        raise AssertionError(f"train() launched kernel 2 {epoch_launches} times, not {expected_launches}")
    q10 = float(et.scale_param(result.params["globals.Q10"], 1.0, 4.0))
    pred = result.val_pred_columns["reco_pred"]
    if not (abs(q10 - 2.0) < 0.15 and result.best_loss < 0.05):
        raise AssertionError(f"train() learned Q10 {q10:.4f}, best val mse {result.best_loss:.4f}")
    if pred.shape != (TRAIN_ROWS // 5,) or not np.isfinite(pred).all():
        raise AssertionError(f"val predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    log("main", f"train(): {result.epoch_path}, {result.engine_reason}; {epoch_launches} launches "
                f"after the gate's {gate_launches}; Q10 {q10:.4f}, best val mse "
                f"{result.best_loss:.5f} at epoch {result.best_epoch}; {fused_wall:.2f} s wall (ok)")
    reference = reference_main_path(et, fe, card, quick_cols)

    # 8. times ---------------------------------------------------------------------
    what, fn, packed, tensors, perms = prepare_epoch_case(
        et, fe, **{**epoch_cases(et, quick_cols)[0], "epochs": 1})
    opt0 = fe.init_fused_opt_state(packed)
    epoch_fns = {"kernel": lambda: fn(packed, opt0, tensors, perms=perms),
                 "plain": lambda: fn.reference(packed, opt0, tensors, perms=perms)}
    for f in epoch_fns.values():
        host_ms(f, 2)  # warm-up
    # the kernel: behind a sleep kernel; the plain version (~5,000 kernels an
    # epoch) from the profiler's device activities; the kernel both ways
    epoch_dev = {"kernel": [], "kernel (profiler)": [], "plain (profiler)": []}
    epoch_wall = {"kernel": [], "plain": []}
    for i in range(6):
        epoch_dev["kernel"].append(device_ms(epoch_fns["kernel"], 20, "kernel 2"))
        epoch_dev["kernel (profiler)"].append(profiled_device_ms(epoch_fns["kernel"], 5))
        epoch_dev["plain (profiler)"].append(profiled_device_ms(epoch_fns["plain"], 1))
        for k in (list(epoch_wall) if i % 2 == 0 else list(reversed(list(epoch_wall)))):
            epoch_wall[k].append(host_ms(epoch_fns[k], 5 if k == "kernel" else 1))
    epoch_ms = {k: statistics.median(v) for k, v in epoch_dev.items()}
    epoch_ms["plain"] = epoch_ms["plain (profiler)"]
    wall_ms = {k: statistics.median(v) for k, v in epoch_wall.items()}
    steps = tensors.weight.shape[0]
    log("times", f"[{card}] kernel 2, one epoch of {steps} steps (batch {tensors.weight.shape[1]}, "
                 f"{what}), geometry {fn.plan.geometry(int(tensors.weight.shape[1]))}, median of 6: "
                 "device ms per epoch "
                 + ", ".join(f"{k} {v:.4f} ms ({steps / v * 1e3:,.0f} steps/s)"
                             for k, v in epoch_ms.items() if k != "plain")
                 + "; wall ms per epoch " + ", ".join(f"{k} {v:.3f}" for k, v in wall_ms.items()))
    stamped = stamped_build.result()
    fe.stage_cycles(fn, packed, opt0, tensors, perms)  # warm-up
    cycles = fe.stage_cycles(fn, packed, opt0, tensors, perms)
    whole = cycles.pop("kernel")
    if whole <= 0 or any(v < 0 for v in cycles.values()):
        raise AssertionError(f"the stamped build of kernel 2 returned {cycles}, {whole}")
    log("times", f"[{card}] kernel 2, a step split by stage (thread 0 of block 0, clock64() in a "
                 f"build with -DEHE_STAMPS, nvcc {stamped.seconds:.1f} s): cycles a step and share "
                 "of the launch: "
                 + ", ".join(f"{k} {v / steps:.0f} ({v / whole:.1%})" for k, v in cycles.items())
                 + f"; the launch {whole} cycles, {whole / steps:.0f} a step")

    torch_model = build_model(et, norm=True, seed=0)
    torch_epochs = 20  # a fifth of the fused run's depth: the torch engine takes ~0.17 s an epoch
    t0 = time.perf_counter()
    torch_result = et.train(torch_model, quick_cols, use_kernel=False,
                            **{**TRAIN_KW, "nepochs": torch_epochs})
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    if torch_result.epoch_path != "torch":
        raise AssertionError(f"use_kernel=False took {torch_result.epoch_path!r}")
    torch_q10 = float(et.scale_param(torch_result.params["globals.Q10"], 1.0, 4.0))
    log("times", f"[{card}] train() wall, epochs of {steps} steps + an evaluation per epoch: "
                 f"cuda_fused_epoch {fused_wall:.2f} s for {TRAIN_KW['nepochs']} epochs (gate "
                 f"included), torch {torch_wall:.2f} s for {torch_epochs} epochs "
                 f"({torch_wall / torch_epochs * TRAIN_KW['nepochs']:.2f} s per "
                 f"{TRAIN_KW['nepochs']}; Q10 {torch_q10:.4f}, best val mse "
                 f"{torch_result.best_loss:.5f})")

    prim_err, prim_ms = primitive_checks(card)
    ms_err = multisite_kernel_checks(et)
    ms_main = multisite_main_path(et, card)
    ms_times = multisite_times(et, card, ms_main, ms_stamped_build.result())
    lstm_err = lstm_kernel_checks(et)
    lstm_main = lstm_main_path(et, card)
    lstm_ms = lstm_times(et, card, lstm_main, chain_build.result())["main"]
    wide_cols = et.rbq10_columns(WIDE_ROWS, seed=42)
    wide_train_cols = {k: v[: WIDE_ROWS * 4 // 5] for k, v in wide_cols.items()}
    wide_err = wide_kernel_checks(et, wide_train_cols)
    wide_main = wide_main_path(et, card, wide_cols)
    wide_ms = wide_times(et, card, wide_main, wide_cols, wide_train_cols)["main"]

    quick_dims = (2, 16, 16, 1)
    print(json.dumps({"kernels": [{
        "name": "fused_forward",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_forward.cu",
        "replaces": "easyhybrid_tpu/ops/fused_forward.py:140",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": serving["kernel_ms"],
        "plain_ms": serving["plain_ms"],
        # one launch over N_ROWS rows: 2 predictors and 1 forcing in, reco and rb out
        **bound(bytes_moved=N_ROWS * 4 * (3 + 2), flops=N_ROWS * forward_flops(quick_dims)),
        "library_ms": None,
    }, {
        "name": "fused_epoch",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_epoch.cu",
        "replaces": "easyhybrid_tpu/ops/fused_epoch.py:2662",
        # this slice's main path: the reference quick-start (rmsprop); the adam
        # quick-start's launches are checked and logged in phase 7
        "launches": reference["launches"],
        "max_abs_err": epoch_err,
        "ms": epoch_ms["kernel"],
        "plain_ms": epoch_ms["plain"],
        # one epoch: every row's 2 predictors, forcing, target, mask and index once
        **bound(bytes_moved=steps * tensors.weight.shape[1] * 4 * 6,
                flops=steps * tensors.weight.shape[1] * 3 * forward_flops(quick_dims)),
        "library_ms": None,
    }, {
        "name": "fused_multisite",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_multisite.cu",
        "replaces": "easyhybrid_tpu/ops/fused_multisite.py:1125",
        "launches": ms_main["launches"],
        "max_abs_err": ms_err,
        "ms": ms_times["kernel_ms"],
        "plain_ms": ms_times["plain_ms"],
        # one step: every sample's 2 predictors, forcing, target and mask once; every
        # site's parameter and two moments read and written once
        **bound(bytes_moved=ms_times["samples"] * 4 * 5 + MS_SITES * 4 * 6,
                flops=ms_times["samples"] * 3 * forward_flops(quick_dims)),
        "library_ms": None,
    }, {
        "name": "multisite_primitives",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/multisite_primitives.cu",
        "replaces": "tools/probe_multisite_primitives.py:32",
        "launches": ms_main["primitive_launches"],
        "max_abs_err": prim_err,
        "ms": prim_ms["kernel"],
        "plain_ms": prim_ms["plain"],
        # site_reduce at the main path's shape: the mask read once, one count per site out
        **bound(bytes_moved=ms_times["samples"] * 4 + MS_TRAIN_SITES * 4,
                flops=ms_times["samples"]),
        "library_ms": prim_ms["plain"],  # torch.sum(x, 1), which is also the plain version
    }, {
        "name": "fused_epoch_lstm",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_epoch_lstm.cu",
        "replaces": "easyhybrid_tpu/ops/fused_epoch.py:2662",  # kernel_body_lstm, :1700
        "launches": lstm_main["launches"],
        "max_abs_err": lstm_err,
        "ms": lstm_ms["kernel_ms"],
        "plain_ms": lstm_ms["plain_ms"],
        # one epoch at the main path's shape: see lstm_step_bound
        **bound(**{k: v * lstm_ms["steps"]
                   for k, v in lstm_step_bound(lstm_ms["batch"], 10).items()}),
        "library_ms": None,  # no single PyTorch call computes the step
    }, {
        "name": "fused_wide",
        "route": "cuda",
        "source": "easyhybrid_tpu_torch/csrc/fused_wide.cu",
        "replaces": "easyhybrid_tpu/ops/fused_epoch.py:2662",  # kernel_body_elem, :1541
        "launches": wide_main["launches"],
        "max_abs_err": wide_err,
        "ms": wide_ms["kernel_ms"],
        "plain_ms": wide_ms["plain_ms"],
        # one epoch at the main path's shape: per step every row's 2 predictors, forcing,
        # target, mask and index once, every parameter and its two moments read and
        # written once; three passes of the layer products, each three TF32 products on
        # the tensor cores
        **wide_ms["bound"],
        # no single PyTorch call computes the step: the step's layer products through
        # torch.matmul in float32, a yardstick
        "library_ms": wide_ms["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
