"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, in
``easyhybrid_tpu_torch/_build/`` (not under version control). The library's
file name carries a hash of the sources and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Any failure raises:
there is no stand-in library and no fallback to another implementation.

No PyTorch header is included, so a build takes seconds; the library
exchanges only raw device pointers and the CUDA stream with Python.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

__all__ = ["find_nvcc", "build_library", "load_library", "BuildResult"]

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
    seconds: float  # 0.0 when an existing build was reused
    log: str        # nvcc's output (ptxas register/spill report)


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


def build_library() -> BuildResult:
    """Compile the kernels unless a build of the same sources exists."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = _BUILD_DIR / f"libeh_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return BuildResult(lib_path, 0.0, "")

    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_path), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp_path, lib_path)
    return BuildResult(lib_path, seconds, log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C function's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build_library().path))
    lib.eh_fused_forward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.eh_fused_forward.restype = ctypes.c_int
    lib.eh_fused_forward_args_size.argtypes = []
    lib.eh_fused_forward_args_size.restype = ctypes.c_int
    lib.eh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib
