#!/usr/bin/env python3
"""Sweep the geometry of the gradient kernel of the port's multi-site kernel.

For the PyTorch / CUDA port (easyhybrid_tpu_torch); needs one NVIDIA GPU and
nvcc, imports no JAX. At the shape of ``chip_smoke.py``'s multi-site main
path (8,000 training sites x 64 observations, MLP [16,16]) it sets the
largest tile (``max_threads`` of ``ops/fused_multisite.py::multisite_geometry``:
rows a block holds, which decide the blocks a multiprocessor keeps) and the
number of thread blocks the geometry aims at (``target_blocks``: the tiles a
block walks) to a range of values and prints the device time per optimizer step of the
gradient kernel and of the update kernel, which sums the gradient blocks'
partial rows. Run from the repository root:

    PYTHONPATH=. python tools/sweep_multisite_blocks_gpu.py
"""

import statistics
import subprocess

import torch

import chip_smoke as cs
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import fused_epoch as fe


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    case = {**cs.multisite_cases()[0], "epochs": 5}
    _, fn, packed, tensors, _ = cs.prepare_multisite_case(et, **case)
    opt0 = fe.init_fused_opt_state(packed)
    for rnd in range(2):
        for threads in (256, 192, 128, 64):
            for target in (132, 264, 528, 1056, 2112):
                fn.aim = dict(target_blocks=target, max_threads=threads)
                geo = fn.geometry(tensors)

                def call():
                    return fn(packed, opt0, tensors)

                call()
                torch.cuda.synchronize()
                grad, update = (
                    statistics.median(cs.kernel_device_ms(call, 4, name) / 5 for _ in range(3))
                    for name in ("eh_ms_grad", "eh_ms_update"))
                print(f"round {rnd}, tiles of at most {threads} rows, {target} blocks aimed "
                      f"at: {geo}: gradient kernel {grad:.4f} ms, update kernel "
                      f"{update:.4f} ms, together {grad + update:.4f} ms per step", flush=True)

if __name__ == "__main__":
    main()
