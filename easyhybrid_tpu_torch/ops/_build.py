"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all of them at once (``csrc/*.cuh`` are the headers they
share), and the objects are linked into one
shared library with a plain C interface, in
``easyhybrid_tpu_torch/_build/`` (not under version control). The library's
file name carries a hash of the sources and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Any failure raises:
there is no stand-in library and no fallback to another implementation.

No PyTorch header is included, so a build takes seconds; the library
exchanges only raw device pointers and the CUDA stream with Python.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["find_nvcc", "build_library", "build_variant", "load_library", "measuring_library",
           "BuildResult"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PACKAGE_DIR / "csrc"
_BUILD_DIR = _PACKAGE_DIR / "_build"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"

# no --use_fast_math: NaN rows must propagate and expf/powf keep full
# precision; -Xptxas -v puts each kernel's registers and spills in the log
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # wall seconds of the whole build; 0.0 when reused
    log: str        # nvcc's output (ptxas register/spill report)
    source_seconds: Dict[str, float]  # each source's compile, run in parallel


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` / ``$CUDA_PATH`` or the
    toolkit's default prefix; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 _DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of easyhybrid_tpu_torch are "
        "compiled at first use and need the CUDA toolkit (nvcc on PATH or "
        "under CUDA_HOME)"
    )


def _sources():
    sources = sorted(_SRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_SRC_DIR}")
    return sources


def _run(procs):
    """Wait for every (source, cmd, process, start time); return each
    source's (seconds until its own process ended, log) and raise on the
    first failure, after stopping the others."""
    def wait(proc, t0):
        stdout, _ = proc.communicate()
        return time.perf_counter() - t0, stdout

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(procs)) as pool:
        futures = [pool.submit(wait, proc, t0) for _, _, proc, t0 in procs]
        out = {}
        for (src, cmd, proc, _), fut in zip(procs, futures):
            out[src] = fut.result()
            if proc.returncode != 0:
                for _, _, other, _ in procs:
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{out[src][1]}")
    return out


def build_library() -> BuildResult:
    """Compile the kernels unless a build of the same sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources + sorted(_SRC_DIR.glob("*.cuh")):  # the headers they include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libeh_kernels_{tag}.so"
    if lib_path.is_file():
        return BuildResult(lib_path, 0.0, "", {})

    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs, objects = [], []
    for src in sources:
        obj = _BUILD_DIR / f"{src.stem}_{tag}.{pid}.o"
        objects.append(obj)
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        procs.append((src.name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter()))
    tmp_path = lib_path.with_suffix(f".{pid}.tmp")
    try:
        compiled = _run(procs)
        link = [nvcc, "-gencode", NVCC_FLAGS[1], "-shared", "-o", str(tmp_path),
                *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp_path, lib_path)
    finally:
        tmp_path.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    log = "".join(f"== {name}\n{text}" for name, (_, text) in compiled.items())
    return BuildResult(lib_path, time.perf_counter() - t0, log,
                       {name: sec for name, (sec, _) in compiled.items()})


def build_variant(source: str, defines: Tuple[str, ...]) -> BuildResult:
    """One source of ``csrc/`` compiled alone with extra ``-D`` flags into a
    library of its own, beside the package's: a measuring build of one kernel
    (its stage stamps, its arithmetic stubbed out). Reused when it exists."""
    src = _SRC_DIR / source
    digest = hashlib.sha256()
    for f in [src] + sorted(_SRC_DIR.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    lib_path = _BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return BuildResult(lib_path, 0.0, "", {})
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp_path), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp_path, lib_path)
    return BuildResult(lib_path, seconds, proc.stdout, {source: seconds})


def measuring_library(source: str, entry: str, *defines: str) -> ctypes.CDLL:
    """``build_variant(source, defines)`` loaded, with the launcher ``entry``
    (arguments, width, stream) and ``entry + "_args_size"`` declared: a
    measuring build of one kernel (its stage stamps, its arithmetic stubbed
    out) that a launcher takes in place of the package's library."""
    lib = ctypes.CDLL(str(build_variant(source, tuple(defines)).path))
    launch = getattr(lib, entry)
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    getattr(lib, entry + "_args_size").restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C function's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build_library().path))
    for fn in (lib.eh_fused_forward, lib.eh_fused_epoch, lib.eh_fused_lstm,
               lib.eh_fused_multisite):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.eh_fused_forward_args_size, lib.eh_fused_epoch_args_size,
               lib.eh_fused_lstm_args_size, lib.eh_fused_multisite_args_size,
               lib.eh_fused_wide_args_size):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.eh_fused_wide.argtypes = [ptr, ptr]  # the arguments and the stream: no width to pick
    lib.eh_fused_wide.restype = num
    lib.eh_wide_tc_product.argtypes = [ptr, num, ptr, num, ptr, num, num, num, num, num, num, num,
                                       ptr]
    lib.eh_wide_tc_product.restype = num
    for fn, argtypes in (
        (lib.eh_prim_site_gather, [ptr, ptr, ptr, num, num, ptr]),
        (lib.eh_prim_site_reduce, [ptr, ptr, num, num, ptr]),
        (lib.eh_prim_site_update, [ptr, ptr, ptr, num, ptr]),
        (lib.eh_prim_site_chain, [ptr, ptr, ptr, ptr, num, num, ptr]),
        (lib.eh_prim_block_sum, [ptr, ptr, num, num, ptr]),
    ):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.eh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib
