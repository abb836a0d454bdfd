"""Kernel 3 (``easyhybrid_tpu_torch/csrc/fused_wide.cu``) alone on a CUDA GPU:
a quick loop for work on that kernel.

Compiles only ``fused_wide.cu`` (seconds, where the whole library takes minutes),
prints ptxas's registers and spills, holds the kernel against its plain
PyTorch version on the tower [1024, 512, 256, 128, 64] and on small edge
cases, element by element and leaf by leaf, runs the no-norm mae case in
float64 as well (which of the two float32 versions is nearer the truth), and
times one epoch at the main shape kernel by kernel from ``torch.profiler``.
It asserts nothing: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
the kernel to its tolerances.

Run from the repository root on a machine with a GPU and ``nvcc``:

    PYTHONPATH=. python tools/dev_fused_wide_gpu.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training.epoch import epoch_tensors_to, perms_for_epochs

TOWER = (1024, 512, 256, 128, 64)
TOL = 1e-4


def build_alone(workdir: Path) -> ctypes.CDLL:
    """``fused_wide.cu`` and the error-string function in a library of their
    own, put in the place of the package's."""
    err = workdir / "err.cu"
    err.write_text('#include <cuda_runtime.h>\nextern "C" const char* eh_cuda_error_string(int c)'
                   "{return cudaGetErrorString((cudaError_t)c);}\n")
    src = Path(fw.__file__).resolve().parent.parent / "csrc" / "fused_wide.cu"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(workdir / "libwide.so"), str(src),
           str(err)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True)
    print(f"nvcc exit {done.returncode} in {time.perf_counter() - t0:.1f} s")
    keep = ("registers", "spill", "error", "warning", "Compiling")
    print("\n".join(l for l in (done.stdout + done.stderr).splitlines() if any(k in l for k in keep)))
    if done.returncode:
        sys.exit(1)
    lib = ctypes.CDLL(str(workdir / "libwide.so"))
    lib.eh_fused_wide.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.eh_fused_wide.restype = ctypes.c_int
    lib.eh_fused_wide_args_size.restype = ctypes.c_int
    lib.eh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def case(what, hidden, *, act="swish", norm="static", opt=("adam", 0.01), loss="mse", shuffle=True,
         n=1000, batch=128, epochs=2, nan_frac=0.0, mask_first=0, agg="sum", seed=0, cols=None):
    model = et.construct_hybrid_model(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation=act, scale_nn_outputs=True, input_batchnorm=norm,
        generator=torch.Generator().manual_seed(seed))
    if cols is None:
        cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    cols["reco"][:mask_first] = np.nan
    data = HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"]], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})
    et.fit_input_norm(model, et.prepare_data(model, cols))
    tensors = epoch_tensors_to(et.build_epoch_tensors(data, batch), "cuda")
    logging = et.LoggingLoss(training_loss=loss, loss_types=(loss,), agg=agg)
    fn = et.make_fused_wide_epoch(model, opt, logging, shuffle=shuffle, epochs_per_call=epochs)
    perms = perms_for_epochs(shuffle, tensors, epochs,
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    return what, fn, fn.plan.pack(model), tensors, perms


def check(what, fn, p0, tensors, perms):
    """Kernel against plain version: misses beyond ``TOL * max(1, |ref|)``
    per vector and per leaf, and whether a second run gives the same bits."""
    got_p, got_o, got_l = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    torch.cuda.synchronize()
    again_p, again_o, _ = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref_p, ref_o, ref_l = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    same = all(torch.equal(a, b) for a, b in ((got_p.params, again_p.params),
                                              (got_o["m"], again_o["m"]), (got_o["v"], again_o["v"])))
    out = [what, "same bits", same, "t", int(got_o["t"]), int(ref_o["t"]), "loss", float(got_l),
           float(ref_l)]
    for name, g, r in (("p", got_p.params, ref_p.params), ("m", got_o["m"], ref_o["m"]),
                       ("v", got_o["v"], ref_o["v"])):
        d = (g - r).abs()
        miss = d > TOL * r.abs().clamp_min(1.0)
        out += [name, f"max {float(d.max()):.3e}", f"miss {int(miss.sum())}/{d.numel()}"]
        if int(miss.sum()):
            out += ["by leaf", {k: int((v > TOL).sum()) for k, v in fn.plan.leaves(d).items()
                                if int((v > TOL).sum())}]
    print(*out, flush=True)


def check_float64(what, fn, p0, tensors, perms):
    """The kernel and the float32 plain version against the plain version
    run in float64 on the same rows."""
    plan = fn.plan
    data = fn._make_data(plan, tensors)
    rows = fn.rows(tensors, perms)
    as64 = lambda cols: tuple(c.double() for c in cols)
    data64 = fe.FusedData(data.x.double(), as64(data.forcing), as64(data.y), as64(data.mask),
                          data.n_batches, data.batch)
    o = fe.init_fused_opt_state(p0)
    ref64 = fw.fused_wide_reference(
        plan, fe.FusedParams(p0.params.double(), p0.bn.double()),
        {"m": o["m"].double(), "v": o["v"].double(), "t": o["t"]}, data64, rows)
    got = fn(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    ref = fn.reference(p0, fe.init_fused_opt_state(p0), tensors, perms=perms)
    for name, a in (("kernel", got[0].params), ("plain float32", ref[0].params)):
        print(what, name, "against float64: max |diff|",
              f"{float((a.double() - ref64[0].params).abs().max()):.3e}")
    print(what, "kernel against plain float32: max |diff|",
          f"{float((got[0].params - ref[0].params).abs().max()):.3e}", "losses", float(got[2]),
          float(ref[2]), float(ref64[2]), flush=True)


def time_main_shape(main_cols):
    from torch.profiler import ProfilerActivity, profile

    _, fn, p0, tensors, perms = case("tower", TOWER, batch=1024, epochs=1, cols=dict(main_cols))
    opt0 = fe.init_fused_opt_state(p0)
    for _ in range(2):
        fn(p0, opt0, tensors, perms=perms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(p0, opt0, tensors, perms=perms)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 3e3, e.count // 3)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    total = sum(r[1] for r in rows if "eh_wide" in r[0])
    print(f"epoch of 16 steps of 1,024: eh_wide kernels {total:.4f} ms, {total / 16:.4f} a step")
    for key, ms, count in rows[:10]:
        print(f"  {ms:9.4f} ms  x{count:4d}  {key[:90]}")
    t0 = time.perf_counter()
    for _ in range(5):
        fn(p0, opt0, tensors, perms=perms)
    torch.cuda.synchronize()
    print(f"wall ms per epoch call {(time.perf_counter() - t0) / 5 * 1e3:.3f}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn.reference(p0, opt0, tensors, perms=perms)
        torch.cuda.synchronize()
    plain = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    print(f"plain version: {plain:.4f} ms of device time an epoch")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("dev_fused_wide_gpu: needs a CUDA GPU")
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_alone(Path(tmp))
        _build.load_library = lambda: lib
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
        main_cols = {k: v[:16384] for k, v in et.rbq10_columns(20480, seed=42).items()}
        first = {k: v[:1024] for k, v in main_cols.items()}
        check(*case("tower sgd 1 step", TOWER, opt=("sgd", 1e-3), shuffle=False, batch=1024,
                    epochs=1, cols=dict(first)))
        check(*case("tower adam 1 step", TOWER, shuffle=False, batch=1024, epochs=1,
                    cols=dict(first)))
        for epochs in (1, 2):
            check(*case(f"tower adam {epochs}x16", TOWER, batch=1024, epochs=epochs,
                        cols=dict(main_cols)))
        check(*case("tower batch 64, 2x16", TOWER, batch=64, epochs=2, cols=dict(first)))
        check(*case("(100,37) tanh", (100, 37), act="tanh", n=777, batch=100))
        check(*case("nan ragged", (128, 64), nan_frac=0.3, n=1000, batch=300, agg="mean"))
        check(*case("masked first", (128, 64), shuffle=False, mask_first=128, n=1024, batch=128,
                    epochs=1))
        check(*case("batches", (65,), act="gelu", shuffle="batches", n=2000, batch=300))
        for lr in (0.05, 1e-3):
            check_float64(*case(f"mae sgd {lr} no norm, 8 steps", (128, 64), norm=False,
                                opt=("sgd", lr), loss="mae", shuffle=False, batch=256, epochs=2,
                                cols=et.rbq10_columns(1000, seed=3), seed=1))
        time_main_shape(main_cols)


if __name__ == "__main__":
    main()
