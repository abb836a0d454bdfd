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

A model whose mechanistic function is traced (``ops/kernel_forms.py``), or
that trains on a traced elementwise loss, runs each kernel from a library of
that kernel's source built against the form's and the loss's headers
(:func:`form_library`): one ``nvcc`` run per kernel, form and loss, kept on
disk under the same directory and reused by later processes. A model with
``compute_dtype=torch.bfloat16`` runs each kernel from its source's bf16 build
(:func:`bf16_defines`), made the same way at the first call that asks for it.
Such a build of kernel 1 or 2, whose kernels are instantiated by width, is
made for the width its plan launches alone (:func:`width_defines`).
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
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["find_nvcc", "build_library", "build_variant", "load_library", "measuring_library",
           "form_build", "form_library", "kernel_library", "nvcc_seconds", "BuildResult",
           "bf16_defines", "width_defines"]

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
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# each kernel source's launcher and its argument types: (arguments, width,
# stream), or (arguments, stream) for kernel 3 and kernel 4's split form, which
# have no width to pick
LAUNCHERS = {
    "fused_forward.cu": ("eh_fused_forward", (_PTR, _INT, _PTR)),
    "fused_epoch.cu": ("eh_fused_epoch", (_PTR, _INT, _PTR)),
    "fused_epoch_multinn.cu": ("eh_fused_epoch_multinn", (_PTR, _INT, _PTR)),
    "fused_epoch_lstm.cu": ("eh_fused_lstm", (_PTR, _INT, _PTR)),
    "fused_lstm_split.cu": ("eh_fused_lstm_split", (_PTR, _PTR)),
    "fused_multisite.cu": ("eh_fused_multisite", (_PTR, _INT, _PTR)),
    "fused_wide.cu": ("eh_fused_wide", (_PTR, _PTR)),
}
_LAUNCHER_ARGTYPES = dict(LAUNCHERS.values())

_lock = threading.Lock()
_nvcc_seconds = [0.0]  # the wall seconds of every build this process made


def nvcc_seconds() -> float:
    """Wall seconds this process has spent in builds (``nvcc``) so far."""
    return _nvcc_seconds[0]


def _count(seconds: float) -> None:
    with _lock:
        _nvcc_seconds[0] += seconds


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
    seconds = time.perf_counter() - t0
    _count(seconds)
    return BuildResult(lib_path, seconds, log,
                       {name: sec for name, (sec, _) in compiled.items()})


def build_variant(source: str, defines: Tuple[str, ...]) -> BuildResult:
    """One source of ``csrc/`` compiled alone with extra ``-D`` flags into a
    library of its own, beside the package's: a measuring build of one kernel
    (its stage stamps, its arithmetic stubbed out). Reused when it exists;
    keyed by every source and header (a source may include another)."""
    src = _SRC_DIR / source
    digest = hashlib.sha256()
    digest.update(src.name.encode())
    for f in _sources() + sorted(_SRC_DIR.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    lib_path = _BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return BuildResult(lib_path, 0.0, "", {})
    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_path = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp_path), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    _count(seconds)
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp_path, lib_path)
    return BuildResult(lib_path, seconds, proc.stdout, {source: seconds})


def _declare(lib: ctypes.CDLL, entry: str) -> ctypes.CDLL:
    """``lib`` with the launcher ``entry`` (typed as in ``LAUNCHERS``),
    ``entry + "_args_size"`` and ``eh_cuda_error_string`` declared."""
    launch = getattr(lib, entry)
    launch.argtypes = list(_LAUNCHER_ARGTYPES[entry])
    launch.restype = _INT
    size = getattr(lib, entry + "_args_size")
    size.argtypes = []
    size.restype = _INT
    lib.eh_cuda_error_string.argtypes = [_INT]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def measuring_library(source: str, entry: str, *defines: str) -> ctypes.CDLL:
    """``build_variant(source, defines)`` loaded, with the launcher ``entry``
    declared: a measuring build of one kernel (its stage stamps, its
    arithmetic stubbed out) that a launcher takes in place of the package's
    library. It evaluates the hand-written form only: its launcher refuses a
    traced one."""
    return _declare(ctypes.CDLL(str(build_variant(source, tuple(defines)).path)), entry)


def _header_defines(text: str, stem: str, macro: str) -> Tuple[str, ...]:
    """The flags that build a source against a generated header: the header
    written once under ``_build/forms/`` with the hash of its text in the
    file name, on the include path, and named by ``macro``."""
    forms = _BUILD_DIR / "forms"
    header = forms / f"{stem}_{hashlib.sha256(text.encode()).hexdigest()[:16]}.cuh"
    if not header.is_file():
        forms.mkdir(parents=True, exist_ok=True)
        tmp = header.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, header)
    return (f"-I{forms}", f'-D{macro}="{header.name}"')


def _form_defines(form, loss=None) -> Tuple[str, ...]:
    """The flags that build a source against a traced form
    (``EH_TRACED_FORM_HEADER``) and a traced elementwise loss
    (``EH_TRACED_LOSS_HEADER``), each where there is one."""
    out: Tuple[str, ...] = ()
    if form.header is not None:
        out += _header_defines(form.header, "eh_form", "EH_TRACED_FORM_HEADER")
    if loss is not None:
        out += _header_defines(loss.header, "eh_loss", "EH_TRACED_LOSS_HEADER")
    return out


_form_locks: Dict[Tuple, threading.Lock] = {}
_form_libs: Dict[Tuple, ctypes.CDLL] = {}


def _form_lock(key) -> threading.Lock:
    with _lock:
        return _form_locks.setdefault(key, threading.Lock())


def _form_key(source: str, form, loss, defines) -> Tuple:
    """A build's key: the source, the form's and the loss's headers (a
    build without a traced loss keeps the key it always had)."""
    key = (source, form.header_hash if form.header is not None else None, tuple(defines))
    return key if loss is None else key + (loss.header_hash,)


def form_build(source: str, form, *defines: str, loss=None) -> BuildResult:
    """Build ``source`` against kernel form ``form`` (traced, or hand-written
    with a traced ``loss``), the traced elementwise loss ``loss`` where there
    is one, and any extra ``defines``, unless that build exists; raises when
    ``nvcc`` is missing or fails. Builds of other sources, forms or losses may
    run at once from several threads; one of the same waits for the first."""
    with _form_lock(_form_key(source, form, loss, defines)):
        return build_variant(source, _form_defines(form, loss) + tuple(defines))


def form_library(source: str, form, *defines: str, loss=None) -> ctypes.CDLL:
    """:func:`form_build` loaded, with the source's launcher declared. A
    failed build raises; nothing falls back to the package's library."""
    key = _form_key(source, form, loss, defines)
    if key not in _form_libs:
        lib = _declare(ctypes.CDLL(str(form_build(source, form, *defines, loss=loss).path)),
                       LAUNCHERS[source][0])
        with _lock:
            _form_libs.setdefault(key, lib)
    return _form_libs[key]


def width_defines(width: Optional[int] = None) -> Tuple[str, ...]:
    """For a source whose kernels are instantiated by width (kernels 1 and
    2), the one width the plan launches (``-DEH_ONLY_WIDTH``): a build against
    a traced form or loss, or a bf16 build, compiles a third of the source,
    and its launcher refuses other widths. None: every width."""
    return () if width is None else (f"-DEH_ONLY_WIDTH={int(width)}",)


def bf16_defines(width: Optional[int] = None) -> Tuple[str, ...]:
    """The defines of a source's bf16 build: ``-DEH_BF16`` and
    :func:`width_defines`."""
    return ("-DEH_BF16",) + width_defines(width)


def kernel_library(source: str, form, loss=None, *, bf16: bool = False,
                   width: Optional[int] = None) -> ctypes.CDLL:
    """The library whose ``source`` kernel evaluates ``form`` and the
    training loss: the package's for a hand-written form and a loss the
    kernels hold (mse, mae, ...), :func:`form_library` for a traced form or
    a traced elementwise ``loss``; with ``bf16`` (a model with
    ``compute_dtype=torch.bfloat16``) the source's bf16 build. Kernels 1 and
    2 pass their plan's ``width``: such a build is made for it alone
    (:func:`width_defines`), at the first call that asks for it."""
    if form.header is None and loss is None and not bf16:
        return load_library()
    return form_library(source, form, *(bf16_defines(width) if bf16 else width_defines(width)),
                        loss=loss)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C function's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build_library().path))
    for entry, _ in LAUNCHERS.values():
        _declare(lib, entry)
    lib.eh_wide_tc_product.argtypes = [_PTR, _INT, _PTR, _INT, _PTR, _INT, _INT, _INT, _INT, _INT,
                                       _INT, _INT, _PTR]
    lib.eh_wide_tc_product.restype = _INT
    for fn, argtypes in (
        (lib.eh_prim_site_gather, [_PTR, _PTR, _PTR, _INT, _INT, _PTR]),
        (lib.eh_prim_site_reduce, [_PTR, _PTR, _INT, _INT, _PTR]),
        (lib.eh_prim_site_update, [_PTR, _PTR, _PTR, _INT, _PTR]),
        (lib.eh_prim_site_chain, [_PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR]),
        (lib.eh_prim_block_sum, [_PTR, _PTR, _INT, _INT, _PTR]),
    ):
        fn.argtypes = argtypes
        fn.restype = _INT
    return lib
