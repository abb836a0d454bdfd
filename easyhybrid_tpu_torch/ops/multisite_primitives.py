"""The building blocks of the multi-site kernel as kernels of their own.

Counterpart of the JAX package's probe scripts
(``tools/probe_multisite_primitives.py`` and ``…primitives2.py``), which
checked on a TPU the primitives its multi-site kernel is made of. Here each
is a tiny CUDA kernel (``csrc/multisite_primitives.cu``) beside its plain
PyTorch version: on CPU tensors a wrapper computes the plain version, on
CUDA tensors it launches its kernel or raises. ``chip_smoke.py`` and the
GPU tests hold each kernel against its plain version on the card.

``site_reduce`` is also on the training path: the multi-site epoch counts
each site's valid targets with it (``ops/fused_multisite.py``).

A site index holds one site id per slot, or -1 for a padding slot.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["site_gather", "site_reduce", "site_update", "site_chain", "block_sum",
           "launch_primitive"]


def _check(name, t, dtype, device):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}; got "
                         f"{t.dtype} on {t.device}, contiguous {t.is_contiguous()}")


def launch_primitive(fn_name: str, device, *args) -> None:
    """Launch one of the library's ``eh_prim_*`` kernels on ``device``'s
    current stream; raises if the launch is refused. Counts launches in
    ``launch_primitive.launches``."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: {lib.eh_cuda_error_string(rc).decode()}")
    launch_primitive.launches += 1


launch_primitive.launches = 0


def _on_cuda(t) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the multi-site primitives run on CUDA or CPU tensors; got {t.device}")
    return t.device.type == "cuda"


def site_gather(values, index, n_obs: int):
    """``out[j, t] = values[index[j]]`` (0 where ``index[j] < 0``): a
    per-site value read through the site index, broadcast over time."""
    if not _on_cuda(values):
        live = index >= 0
        picked = torch.where(live, values[index.clamp_min(0).long()], torch.zeros_like(values[:1]))
        return picked[:, None].expand(index.shape[0], n_obs).contiguous()
    _check("values", values, torch.float32, values.device)
    _check("index", index, torch.int32, values.device)
    out = torch.empty((index.shape[0], n_obs), dtype=torch.float32, device=values.device)
    launch_primitive("eh_prim_site_gather", values.device, values.data_ptr(), index.data_ptr(),
            out.data_ptr(), index.shape[0], n_obs)
    return out


def site_reduce(x):
    """``out[j] = sum_t x[j, t]``: a per-site reduction over time. On the
    card a group of lanes shares a row (16-byte loads where the row allows)
    and adds in a fixed tree order."""
    if not _on_cuda(x):
        return x.sum(1)
    _check("x", x, torch.float32, x.device)
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    launch_primitive("eh_prim_site_reduce", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    return out


def site_update(values, index, fresh) -> None:
    """``values[index[j]] = fresh[j]`` in place for ``index[j] >= 0``; every
    other site keeps its bits. The live entries of ``index`` are distinct."""
    if not _on_cuda(values):
        live = index >= 0
        values[index[live].long()] = fresh[live]
        return
    _check("values", values, torch.float32, values.device)
    _check("index", index, torch.int32, values.device)
    _check("fresh", fresh, torch.float32, values.device)
    launch_primitive("eh_prim_site_update", values.device, values.data_ptr(), index.data_ptr(),
            fresh.data_ptr(), index.shape[0])


def site_chain(values, index, x, acc) -> None:
    """``acc[index[j]] += sum_t values[index[j]] * x[j, t]`` in place: the
    select, multiply, reduce over time and accumulate chain of a per-site
    gradient. The live entries of ``index`` are distinct."""
    if not _on_cuda(values):
        live = index >= 0
        sites = index[live].long()
        acc[sites] += (values[sites][:, None] * x[live]).sum(1)
        return
    for name, t in (("values", values), ("x", x), ("acc", acc)):
        _check(name, t, torch.float32, values.device)
    _check("index", index, torch.int32, values.device)
    launch_primitive("eh_prim_site_chain", values.device, values.data_ptr(), index.data_ptr(),
            x.data_ptr(), acc.data_ptr(), index.shape[0], x.shape[1])


def block_sum(partials):
    """``out[p] = sum_b partials[b, p]`` in block order: the same bits on
    every run, as the shared gradient's sum across blocks must be."""
    if not _on_cuda(partials):
        return partials.sum(0)
    _check("partials", partials, torch.float32, partials.device)
    out = torch.empty((partials.shape[1],), dtype=torch.float32, device=partials.device)
    launch_primitive("eh_prim_block_sum", partials.device, partials.data_ptr(), out.data_ptr(),
            partials.shape[0], partials.shape[1])
    return out
