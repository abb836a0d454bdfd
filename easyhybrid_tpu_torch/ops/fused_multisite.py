"""Fused multi-site training epochs: a hand-written CUDA kernel for Hopper
(kernel 5).

Counterpart of ``easyhybrid_tpu/ops/fused_multisite.py``
(``make_fused_multisite_epoch``). One call of the launcher of
``csrc/fused_multisite.cu`` enqueues every optimizer step of
``epochs_per_call`` epochs × ``num_batches`` site batches of a
:class:`~easyhybrid_tpu_torch.parallel.multisite.MultiSiteHybridModel`: the
shared MLP over the batch's (site, time) samples, each site's globals read,
differentiated and updated on the card, the shared gradient summed across
thread blocks in a fixed order, and the optax ``adam`` / ``sgd`` update of
the shared leaves and of **every** site's globals (a site outside the batch
has a zero gradient, which still decays Adam's moments, as the torch epoch
does on the whole ``(S, 1)`` leaf).

The packed layout is the single-series kernel's (``FusedEpochPlan``): the
shared parameters, then each global's ``S`` per-site raw values. What the
Pallas kernel packs into 128-lane tiles with slot maps is here a plain
``(S,)`` array per global, and a **site index** ``(epochs, num_batches,
batch)`` drawn with torch expresses every batch size and all three shuffle
modes; ``-1`` marks a padding slot. Data row ``s`` must hold site ``s``
(``prepare_multisite_data``'s layout), which the envelope checks.

As in the JAX kernel the loss scales are computed outside the kernel, per
site batch: ``agg_scale / max(Σ mask, 1)`` for mse and mae, ``agg_scale /
max(Σ (y − ȳ)² m, 1e-12)`` for nseLoss, with a validity flag (a batch with
no valid target changes nothing) and the step count after each step.

:func:`fused_multisite_reference` is the same algorithm in plain PyTorch.
On CPU tensors the wrapper computes it; on CUDA tensors it launches the
kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.loaders import EpochTensors
from ..losses.specs import LoggingLoss
from ..models.nn import MLP
from ..parallel.multisite import MultiSiteHybridModel
from ..training.epoch import perms_for_epochs
from . import _build
from .fused_epoch import (
    _UNIT_TABLE,
    MAX_SMEM_BYTES,
    MAX_TARGETS,
    SHUFFLES,
    _TILE_ROWS,
    FusedEpochPlan,
    FusedParams,
    _layout_sizes,
    _loss_name,
    _Optimizer,
    _reference_update,
    build_plan,
    fill_common_args,
    form_args,
    gradient_units,
    opt_slots,
    optimizer_reason,
    padded_offsets,
    reference_backward,
    reference_cotangents,
    reference_forward,
    slot_u,
    split_consts,
)
from .fused_forward import (
    MAX_ARGS,
    MAX_FORCING,
    MAX_LAYERS,
    _ACT_IDS,
    fused_forward_unsupported_reason,
)
from .multisite_primitives import site_reduce

__all__ = [
    "FusedMultisiteEpoch",
    "fused_multisite_reference",
    "fused_multisite_unsupported_reason",
    "launch_fused_multisite",
    "make_fused_multisite_epoch",
    "multisite_geometry",
    "supports_fused_multisite",
]

MS_LOSSES = ("mse", "mae", "nseLoss")
_LOSS_KINDS = {"mse": 0, "nseLoss": 0, "mae": 1}  # squared or absolute differences
_SST_EPS = 1e-12  # the floor of nseLoss's denominator (losses/metrics.py)
# gradient blocks aimed at: two a multiprocessor, the blocks the card holds at
# once for the quick-start model (91 KB of shared memory each), so a step is
# one wave and a block walks many tiles, each next tile's rows in flight
# (tools/sweep_multisite_blocks_gpu.py: at 8,000 sites x 64 this ran 4.5%
# faster than eight a multiprocessor, and smaller tiles ran slower; PERF.md)
_TARGET_BLOCKS = 2 * 132
_MAX_THREADS = 256  # EHM_MAX_THREADS in csrc/fused_multisite.cu: a tile's rows


# --------------------------------------------------------------------------
# envelope
# --------------------------------------------------------------------------

def _envelope_floats(n_shared, f, n_consts, t, tile_rows, res) -> int:
    """The floats that decide the envelope (the first kernel's gradient block:
    the shared parameters and their gradient, the small vectors and a tile of
    ``tile_rows`` residual rows with a pad column). Kept as it was, so the
    envelope admits what it did; :func:`multisite_geometry` lays out the
    kernel's own block."""
    return 2 * n_shared + n_consts + 2 * f + t + tile_rows + res * (tile_rows + 1)


def _tile_rows(model) -> Optional[int]:
    n_params, res = _layout_sizes(model)
    g, k = len(model.global_param_names), len(model.fixed_param_names)
    f, p, t = model.nn.in_dim, model.nn.out_dim, len(model.targets)
    for rows in _TILE_ROWS:
        if 4 * _envelope_floats(n_params - g, f, 2 * p + 2 * g + k, t, rows, res) <= MAX_SMEM_BYTES:
            return rows
    return None


def fused_multisite_unsupported_reason(model, optimizer, logging: LoggingLoss, tensors=None, *,
                                       shuffle: Any = False) -> Optional[str]:
    """Why the fused multi-site kernel cannot train ``model`` with this
    optimizer and loss, or None when it can.

    The envelope: a :class:`MultiSiteHybridModel` with shared network
    weights over a SingleNN MLP base in float32 inside the fused forward's
    model envelope, ``input_batchnorm`` False or ``"static"``;
    ``training_loss`` mse, mae or nseLoss with ``agg`` sum or mean and no
    ``extra_loss``; a single ``adam`` spec or an ``sgd`` spec without
    momentum. With ``tensors``: ``x`` of shape ``(num_batches, batch, N,
    F)``, and for minibatched sites a shuffle mode of True, False or
    ``"batches"`` and the identity site order in ``_site_idx``."""
    if not isinstance(model, MultiSiteHybridModel):
        return f"{type(model).__name__} is not a MultiSiteHybridModel"
    if not model.share_nn:
        return "share_nn=False (per-site network weights)"
    reason = fused_forward_unsupported_reason(model.base, training=True)
    if reason is not None:
        return reason
    if isinstance(model.nn, MLP) and model.nn.input_batchnorm is True:
        return "trainable input BatchNorm (input_batchnorm=True) is outside the multisite kernel"
    if len(model.targets) > MAX_TARGETS:
        return f"{len(model.targets)} targets exceed the kernel's cap of {MAX_TARGETS}"
    if _loss_name(logging.training_loss) not in MS_LOSSES:
        return (f"training_loss={logging.training_loss!r} (the multisite kernel trains "
                f"{', '.join(MS_LOSSES)})")
    if logging.agg_name not in ("sum", "mean"):
        return f"agg={logging.agg!r} (the kernel aggregates sum or mean)"
    if logging.extra_loss is not None:
        return "an extra_loss (the kernel adds none)"
    reason = optimizer_reason(optimizer)
    if reason is not None:
        return reason
    if _tile_rows(model) is None:
        return ("the shared parameters and a 32-row residual tile exceed the kernel's "
                f"{MAX_SMEM_BYTES // 1024} KB of shared memory")
    if tensors is not None:
        if isinstance(tensors.x, dict) or tensors.x.ndim != 4:
            return (f"x of shape {tuple(getattr(tensors.x, 'shape', ()))}: the kernel takes "
                    "(num_batches, batch, N, F)")
        if int(tensors.weight.shape[0]) != 1:
            if shuffle not in SHUFFLES:
                return f"shuffle={shuffle!r} (minibatched sites take True, False or 'batches')"
            sidx = tensors.forcing.get("_site_idx")
            if sidx is not None:
                # data row s must hold site s; read one id per site, not the block
                first = sidx[..., 0].reshape(-1)
                first = np.asarray(first.cpu() if torch.is_tensor(first) else first)
                n = int(tensors.n_samples)
                if not np.array_equal(first[:n], np.arange(n, dtype=first.dtype)):
                    return "the data's site order (_site_idx) is not the identity"
    return None


def supports_fused_multisite(model, optimizer, logging: LoggingLoss, tensors=None, *,
                             shuffle: Any = False) -> bool:
    return fused_multisite_unsupported_reason(model, optimizer, logging, tensors,
                                              shuffle=shuffle) is None


# --------------------------------------------------------------------------
# plan, data, site index and loss scales
# --------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``struct EhFusedMultisiteArgs`` in csrc/fused_multisite.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("forcing", ctypes.c_void_p * MAX_FORCING),
        ("y", ctypes.c_void_p * MAX_TARGETS),
        ("mask", ctypes.c_void_p * MAX_TARGETS),
        ("site_index", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("valid", ctypes.c_void_p),
        ("tcount", ctypes.c_void_p),
        ("params", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("u", ctypes.c_void_p),
        ("bn", ctypes.c_void_p),
        ("consts", ctypes.c_void_p),
        ("gsite", ctypes.c_void_p),
        ("partials", ctypes.c_void_p),
        ("lamb_parts", ctypes.c_void_p),
        ("epoch_loss", ctypes.c_void_p),
        ("stamps", ctypes.c_void_p),
        ("n_obs", ctypes.c_int),
        ("n_epochs", ctypes.c_int),
        ("n_batches", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("n_sites", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("tile_sites", ctypes.c_int),
        ("site_tiles", ctypes.c_int),
        ("sites_per_block", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("acts", ctypes.c_int * MAX_LAYERS),
        ("norm_mode", ctypes.c_int),
        ("norm_eps", ctypes.c_float),
        ("n_shared", ctypes.c_int),
        ("p_off_w", ctypes.c_int * MAX_LAYERS),
        ("p_off_b", ctypes.c_int * MAX_LAYERS),
        ("p_off_g", ctypes.c_int),
        ("n_padded", ctypes.c_int),
        ("pp_off_w", ctypes.c_int * MAX_LAYERS),
        ("pp_off_b", ctypes.c_int * MAX_LAYERS),
        ("pp_off_g", ctypes.c_int),
        ("n_globals", ctypes.c_int),
        ("n_fixed", ctypes.c_int),
        ("scale_nn_outputs", ctypes.c_int),
        ("form", ctypes.c_int),
        ("n_args", ctypes.c_int),
        ("arg_src", ctypes.c_int * MAX_ARGS),
        ("arg_idx", ctypes.c_int * MAX_ARGS),
        ("arg_const", ctypes.c_float * MAX_ARGS),
        ("n_targets", ctypes.c_int),
        ("target_out", ctypes.c_int * MAX_TARGETS),
        ("loss_kind", ctypes.c_int),
        ("optimizer", _Optimizer),
        ("n_forcing", ctypes.c_int),
        ("res_floats", ctypes.c_int),
        ("r_off_xhat", ctypes.c_int),
        ("r_off_d0", ctypes.c_int),
        ("r_off_g", ctypes.c_int),
        ("r_off_h", ctypes.c_int * MAX_LAYERS),
        ("r_off_d", ctypes.c_int * MAX_LAYERS),
        ("r_off_out", ctypes.c_int),
        ("r_off_dsc", ctypes.c_int),
        ("r_off_one", ctypes.c_int),
        ("n_unit_table", ctypes.c_int),
    ]


def plan_fused_multisite(model, optimizer, logging: LoggingLoss) -> FusedEpochPlan:
    """Check the envelope and the kernel form and lay out the model's
    parameters: the shared ones, then each global's ``n_sites`` values."""
    reason = fused_multisite_unsupported_reason(model, optimizer, logging)
    if reason is not None:
        raise ValueError(f"model not supported by the fused multisite kernel: {reason}")
    return build_plan(model, optimizer, logging, tile_rows=_tile_rows(model),
                      n_sites=model.n_sites)


def _static_args(plan: FusedEpochPlan) -> bytes:
    """The kernel's static arguments; each call fills in the pointers, the
    sizes and the geometry."""
    a = _Args()
    dims = plan.dims
    a.n_sites = plan.n_sites
    a.n_layers = len(dims) - 1
    a.dims[: len(dims)] = dims
    a.acts[: len(plan.acts)] = [_ACT_IDS[act] for act in plan.acts]
    fill_common_args(a, plan)
    o = plan.offsets()
    a.n_shared = a.p_off_g = o["p_g"]
    a.p_off_w[: len(o["p_w"])] = o["p_w"]
    a.p_off_b[: len(o["p_b"])] = o["p_b"]
    pp = padded_offsets(dims, plan.has_norm, 0)  # the shared parameters alone
    a.pp_off_w[: len(pp["pp_w"])] = pp["pp_w"]
    a.pp_off_b[: len(pp["pp_b"])] = pp["pp_b"]
    a.pp_off_g, a.n_padded = pp["pp_g"], pp["n_padded"]
    a.loss_kind = _LOSS_KINDS[plan.loss]
    a.n_forcing = len(plan.forcing_names)
    # the backward's residuals, then the network's outputs, the bound scaling's
    # derivative and a feature of ones (kernel 2's tile row)
    a.res_floats = plan.tile_floats
    a.r_off_xhat, a.r_off_d0, a.r_off_g = o["r_xhat"], o["r_d0"], o["r_g"]
    a.r_off_h[: len(o["r_h"])] = o["r_h"]
    a.r_off_d[: len(o["r_d"])] = o["r_d"]
    a.r_off_out, a.r_off_dsc = plan.res_floats, plan.res_floats + dims[-1]
    a.r_off_one = plan.res_floats + 2 * dims[-1]
    a.n_unit_table = _n_unit_table(plan)
    return bytes(a)


def _smem_floats(*, n_padded, n_shared, f, p, g, k, t, n_forcing, threads, tile_floats, tile_sites,
                 n_unit_table) -> int:
    """Shared-memory floats of a gradient block of ``threads`` threads;
    ``ehm_smem_floats`` in csrc/fused_multisite.cu computes the same."""
    cols = f + n_forcing + 2 * t
    return (n_padded + n_shared + (2 * p + 2 * g + k) + 2 * f + t + threads // 32 + g
            + 8 * n_unit_table + tile_floats * threads + 2 * (cols * threads + tile_sites * g))


class MultisiteGeometry(NamedTuple):
    """How the gradient kernel cuts a step over ``batch`` sites of ``n_obs``
    observations: tiles of ``threads`` rows (one a thread) that hold
    ``tile_sites`` whole sites, or, for a site longer than that, a site in
    ``site_tiles`` tiles; a block owns ``sites_per_block`` whole sites and
    walks their tiles, the next tile's rows staged while the current tile's
    sums run; ``blocks`` blocks, each writing one partial row."""

    threads: int
    tile_sites: int
    site_tiles: int
    sites_per_block: int
    blocks: int


def _block_smem_bytes(plan: FusedEpochPlan, threads: int, tile_sites: int) -> int:
    n_shared, g = plan.offsets()["p_g"], len(plan.global_names)
    return 4 * _smem_floats(
        n_padded=padded_offsets(plan.dims, plan.has_norm, 0)["n_padded"], n_shared=n_shared,
        f=plan.dims[0], p=plan.dims[-1], g=g, k=len(plan.fixed_names),
        t=len(plan.target_names), n_forcing=len(plan.forcing_names), threads=threads,
        tile_floats=plan.tile_floats, tile_sites=tile_sites, n_unit_table=_n_unit_table(plan))


def _n_unit_table(plan: FusedEpochPlan) -> int:
    """The shared parameters' gradient units a block describes once (the
    per-site globals have no unit: each site is summed on its own)."""
    return min(_UNIT_TABLE, gradient_units(plan.dims, plan.has_norm, 0))


def multisite_geometry(plan: FusedEpochPlan, batch: int, n_obs: int, *,
                       target_blocks: int = _TARGET_BLOCKS,
                       max_threads: int = _MAX_THREADS) -> MultisiteGeometry:
    """The gradient kernel's geometry: a pure function of the plan, the site
    batch and the observations a site. A tile has at most ``max_threads``
    rows, fewer where the block's shared memory (the padded parameters,
    their gradient, the residual tile and two stages) would not fit; it
    holds as many whole sites as fit (its threads the next multiple of 32 of
    their rows), or a site longer than that in tiles of that many rows.
    Blocks take whole sites, as few tiles each as reach about
    ``target_blocks`` blocks; the blocks' partial rows are summed in
    parallel, so nothing caps the grid. The defaults are the kernel's own;
    the tests and the sweep (``tools/sweep_multisite_blocks_gpu.py``) pass
    others, a target beyond 528 blocks to exercise the update kernel's sum
    over more partial rows than the first kernel's grid could have."""
    if batch < 1 or n_obs < 1:
        raise ValueError(f"a site batch of {batch} sites of {n_obs} observations")
    if max_threads % 32 != 0 or not 32 <= max_threads <= _MAX_THREADS:
        raise ValueError(f"tiles of at most {max_threads} rows: a multiple of 32 up to "
                         f"{_MAX_THREADS}")
    most = max_threads
    while True:
        if n_obs <= most:
            tile_sites, site_tiles = min(most // n_obs, batch), 1
            threads = -(-tile_sites * n_obs // 32) * 32
        else:
            tile_sites, site_tiles, threads = 1, -(-n_obs // most), most
        if _block_smem_bytes(plan, threads, tile_sites) <= MAX_SMEM_BYTES:
            break
        if most == 32:
            raise ValueError("the shared parameters and a 32-row tile exceed the kernel's "
                             f"{MAX_SMEM_BYTES // 1024} KB of shared memory")
        most -= 32
    n_tiles = batch * site_tiles if site_tiles > 1 else -(-batch // tile_sites)
    tiles = -(-n_tiles // target_blocks)
    sites_per_block = min(batch, max(1, tiles // site_tiles) if site_tiles > 1
                          else tiles * tile_sites)
    return MultisiteGeometry(threads, tile_sites, site_tiles, sites_per_block,
                             -(-batch // sites_per_block))


class MultisiteData(NamedTuple):
    """The padded epoch arrays with the batch axes flattened to slots:
    ``x (n_slots, N, F)`` and one ``(n_slots, N)`` array per forcing, target
    and mask; ``live (n_slots,)`` is false for a padding slot."""

    x: torch.Tensor
    forcing: Tuple[torch.Tensor, ...]
    y: Tuple[torch.Tensor, ...]
    mask: Tuple[torch.Tensor, ...]
    live: torch.Tensor
    n_batches: int
    batch: int


def multisite_data(plan: FusedEpochPlan, tensors: EpochTensors) -> MultisiteData:
    nb, batch = tensors.weight.shape
    n = nb * batch

    def slots(a):
        return a.reshape((n,) + tuple(a.shape[2:])).contiguous()

    return MultisiteData(
        x=slots(tensors.x),
        forcing=tuple(slots(tensors.forcing[f]) for f in plan.forcing_names),
        y=tuple(slots(tensors.y[t]) for t in plan.target_names),
        mask=tuple(slots(tensors.mask[t]) for t in plan.target_names),
        live=tensors.weight.reshape(n) > 0,
        n_batches=int(nb),
        batch=int(batch),
    )


def site_index(shuffle, perms, data: MultisiteData, epochs: int) -> torch.Tensor:
    """``(epochs, num_batches, batch)`` int32 site of every slot of every
    step: a permutation of the slots (shuffle True), of the batches
    (``"batches"``) or the identity (no shuffle, or ``perms`` None), with
    -1 where the slot is padding."""
    nb, batch = data.n_batches, data.batch
    dev = data.live.device
    if perms is None:
        slots = torch.arange(nb * batch, device=dev).expand(epochs, nb * batch)
    else:
        slots = perms.to(device=dev, dtype=torch.int64)
        if shuffle == "batches":
            slots = (slots[:, :, None] * batch + torch.arange(batch, device=dev)).reshape(epochs, -1)
    index = torch.where(data.live[slots], slots, torch.full_like(slots, -1))
    return index.reshape(epochs, nb, batch).to(torch.int32).contiguous()


def batch_scales(plan: FusedEpochPlan, data: MultisiteData, index: torch.Tensor):
    """``(scale (E, nb, T), valid (E, nb))``: every site batch's loss scale
    per target and its validity flag, from the batch's targets and masks
    alone. The per-site counts of valid targets come from one reduction
    over time (the ``site_reduce`` kernel on CUDA tensors)."""
    live = index >= 0
    rows = index.clamp_min(0).long()
    counts, scales = [], []
    for y, mask in zip(data.y, data.mask):
        n_site = site_reduce(mask)  # whole numbers: exact in any order
        count = torch.where(live, n_site[rows], torch.zeros_like(n_site[:1])).sum(-1)
        counts.append(count)
        if plan.loss == "nseLoss":
            on = live[..., None]
            m = torch.where(on, mask[rows], torch.zeros_like(mask[:1]))
            yb = torch.where(on, y[rows], torch.zeros_like(y[:1]))
            mu = (yb * m).sum((-2, -1)) / count.clamp_min(1.0)
            dev2 = (yb - mu[..., None, None]) * m
            scales.append(plan.agg_scale / (dev2 * dev2).sum((-2, -1)).clamp_min(_SST_EPS))
        else:
            scales.append(plan.agg_scale / count.clamp_min(1.0))
    valid = (torch.stack(counts).sum(0) > 0).to(torch.float32)
    return torch.stack(scales, -1).to(torch.float32).contiguous(), valid.contiguous()


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def multisite_reference_grads(plan: FusedEpochPlan, p, bn, consts, data: MultisiteData, sites,
                              scale):
    """One step's forward and hand-written backward on the site batch
    ``sites`` (``(batch,)``, -1 padding): ``(grad, batch_loss)`` with
    ``grad`` packed like ``p`` (zero for the sites outside the batch)."""
    n_shared, n_glob, n_sites = plan.offsets()["p_g"], len(plan.global_names), plan.n_sites
    live = sites >= 0
    rows = sites.clamp_min(0).long()
    n_obs = data.x.shape[1]

    def samples(a):  # (batch, N, ...) of the batch's sites -> one row per sample
        a = a[rows]
        on = live.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(on, a, torch.zeros_like(a[:1])).reshape((-1,) + tuple(a.shape[2:]))

    x = samples(data.x)
    forcing = [samples(c) for c in data.forcing]
    fwd = reference_forward(plan, p, bn, consts, x)
    _, _, glo, gspan, fixed = split_consts(plan, consts)
    raw = p[n_shared:].view(n_glob, n_sites)[:, rows]                  # (G, batch)
    raw = torch.where(live, raw, torch.zeros_like(raw))
    sg = torch.sigmoid(raw)
    per_row = (glo[:, None] + gspan[:, None] * sg).repeat_interleave(n_obs, 1)
    scalars = list(per_row) + [f.reshape(1) for f in fixed]
    args = form_args(plan, fwd.neural, forcing, scalars)
    outs = plan.form.torch_fn(*args)
    parts = plan.form.partials_fn(*args)

    loss_rows = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    cots = []
    for j in range(len(plan.target_names)):
        on = samples(data.mask[j]) > 0
        pred = outs[plan.target_out[j]]
        diff = torch.where(on, pred - samples(data.y[j]), torch.zeros_like(pred))
        if plan.loss == "mae":
            loss_rows = loss_rows + scale[j] * diff.abs()
            cots.append(scale[j] * torch.sign(diff))
        else:  # mse, and nseLoss with its own scale
            loss_rows = loss_rows + scale[j] * diff * diff
            cots.append((2.0 * scale[j]) * diff)

    dn, dg_rows = reference_cotangents(plan, fwd.neural, parts, cots)
    grads = reference_backward(plan, p, fwd, dn)
    g_batch = dg_rows.view(-1, n_obs, n_glob).sum(1).T * (gspan[:, None] * (sg * (1.0 - sg)))
    g_site = torch.zeros((n_glob, n_sites), dtype=p.dtype, device=p.device)
    g_site[:, rows[live]] = g_batch[:, live]
    return torch.cat(grads + [g_site.reshape(-1)]), loss_rows.sum()


def fused_multisite_reference(plan: FusedEpochPlan, packed: FusedParams, opt_state,
                              data: MultisiteData, index: torch.Tensor, scale, valid):
    """The plain PyTorch version of the kernel: ``index.shape[0]`` epochs of
    ``data.n_batches`` steps over the sites ``index[e, b]``, with the loss
    scales and validity flags of :func:`batch_scales`. Returns ``(packed,
    opt_state, mean_loss)``; the loss is the last epoch's mean batch loss
    (a batch without valid targets counts 0)."""
    p, bn = packed.params, packed.bn
    slots = opt_slots(opt_state)
    t = opt_state["t"].to(torch.float32)
    consts = plan.consts.to(p.device)
    epoch_loss = None
    for e in range(index.shape[0]):
        epoch_loss = torch.zeros((), dtype=p.dtype, device=p.device)
        for b in range(data.n_batches):
            g, loss = multisite_reference_grads(plan, p, bn, consts, data, index[e, b],
                                                scale[e, b])
            ok = valid[e, b] > 0
            p, slots, t = _reference_update(plan, p, slots, t, g, ok)
            epoch_loss = epoch_loss + torch.where(ok, loss, torch.zeros_like(loss))
    new_state = {**slots, "t": t.round().to(torch.int32)}
    return FusedParams(p, bn), new_state, epoch_loss / data.n_batches


# --------------------------------------------------------------------------
# kernel launch and the epoch function
# --------------------------------------------------------------------------

def launch_fused_multisite(plan: FusedEpochPlan, packed: FusedParams, opt_state,
                           data: MultisiteData, index: torch.Tensor, scale, valid,
                           epoch_loss: torch.Tensor, *, lib=None, stamps=None,
                           target_blocks: int = _TARGET_BLOCKS,
                           max_threads: int = _MAX_THREADS) -> None:
    """Enqueue every step of ``index`` (``(epochs, num_batches, batch)``)
    with one call of the C launcher, updating ``packed`` and ``opt_state``
    in place and adding each epoch's valid batch losses into ``epoch_loss``
    (zeros on entry); raises if a launch is refused. Counts calls in
    ``launch_fused_multisite.launches``. ``lib`` is a measuring build of the
    kernel (``_build.measuring_library``) in place of the package's library,
    whose launches are not counted, and ``stamps`` the int64 tensor its stage
    cycles go to; ``target_blocks`` and ``max_threads`` go to
    :func:`multisite_geometry`."""
    main_lib = _build.load_library()
    measuring = lib is not None
    lib = lib or main_lib
    if lib.eh_fused_multisite_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            "the kernel's argument struct and its ctypes mirror differ in size: "
            f"{lib.eh_fused_multisite_args_size()} != {ctypes.sizeof(_Args)}"
        )
    dev = data.x.device
    epochs, nb, batch = index.shape
    n_obs = data.x.shape[1]
    n_shared, n_glob = plan.offsets()["p_g"], len(plan.global_names)
    geo = multisite_geometry(plan, batch, n_obs, target_blocks=target_blocks,
                             max_threads=max_threads)
    t0 = opt_state["t"].to(torch.float32)
    tcount = (t0 + torch.cumsum(valid.reshape(-1), 0)).contiguous()
    gsite = torch.zeros((max(n_glob * plan.n_sites, 1),), dtype=torch.float32, device=dev)
    partials = torch.empty((geo.blocks, n_shared + 1), dtype=torch.float32, device=dev)

    a = _Args.from_buffer_copy(_static_args(plan))
    a.x = data.x.data_ptr()
    for i, c in enumerate(data.forcing):
        a.forcing[i] = c.data_ptr()
    for i, (yc, mc) in enumerate(zip(data.y, data.mask)):
        a.y[i], a.mask[i] = yc.data_ptr(), mc.data_ptr()
    a.site_index, a.scale, a.valid = index.data_ptr(), scale.data_ptr(), valid.data_ptr()
    a.tcount = tcount.data_ptr()
    a.params, a.bn = packed.params.data_ptr(), packed.bn.data_ptr()
    a.m, a.v = opt_state["m"].data_ptr(), opt_state["v"].data_ptr()
    a.u = slot_u(plan, opt_state)
    a.consts = plan.consts.data_ptr()
    a.gsite, a.partials, a.epoch_loss = gsite.data_ptr(), partials.data_ptr(), epoch_loss.data_ptr()
    if plan.opt_name == "lamb":  # a row of leaf norms per update block (eh_ms_update_kernel)
        update_blocks = -(-(n_shared + 1) // 8) + -(-(n_glob * plan.n_sites) // 256)
        lamb_parts = torch.empty((update_blocks, 2 * a.optimizer.n_leaves), dtype=torch.float32,
                                 device=dev)
        a.lamb_parts = lamb_parts.data_ptr()
    a.stamps = stamps.data_ptr() if stamps is not None else None
    a.n_obs, a.n_epochs, a.n_batches, a.batch = n_obs, epochs, nb, batch
    a.threads, a.tile_sites, a.site_tiles = geo.threads, geo.tile_sites, geo.site_tiles
    a.sites_per_block, a.n_blocks = geo.sites_per_block, geo.blocks
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.eh_fused_multisite(ctypes.byref(a), plan.width, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused multisite kernel launch failed: {main_lib.eh_cuda_error_string(rc).decode()}")
    opt_state["t"].copy_(tcount[-1:].round().to(torch.int32))
    if not measuring:
        launch_fused_multisite.launches += 1


launch_fused_multisite.launches = 0

# the stamped build's stages (-DEHM_STAMPS; the last stamp is the whole kernel)
STAGES = ("wait for the staged rows", "forward to loss", "backward",
          "start the next tile's copies", "shared gradient units", "per-site sums",
          "block's end")


def stage_cycles(fn: "FusedMultisiteEpoch", packed: FusedParams, opt_state,
                 tensors: EpochTensors, perms=None) -> dict:
    """One call of the stamped build on CUDA tensors: the ``clock64()``
    cycles thread 0 of the first gradient block spent in each stage
    (:data:`STAGES`), summed over the call's steps, and ``"kernel"``, that
    block's whole time. For measurement only; the result is dropped."""
    data, index, scale, valid = fn.inputs(tensors, perms)
    packed = FusedParams(packed.params.clone(), packed.bn.clone())
    opt_state = {k: v.clone() for k, v in opt_state.items()}
    dev = data.x.device
    epoch_loss = torch.zeros((index.shape[0],), dtype=torch.float32, device=dev)
    stamps = torch.zeros((len(STAGES) + 1,), dtype=torch.int64, device=dev)
    launch_fused_multisite(fn.plan, packed, opt_state, data, index, scale, valid, epoch_loss,
                           lib=_build.measuring_library("fused_multisite.cu", "eh_fused_multisite",
                                                        "-DEHM_STAMPS"),
                           stamps=stamps, **fn.aim)
    return dict(zip(STAGES + ("kernel",), stamps.tolist()))


class FusedMultisiteEpoch:
    """``fn(model_or_packed, opt_state, tensors, perms=None, generator=None)
    -> (model_or_packed, opt_state, mean_loss)``: ``epochs_per_call`` epochs
    of site batches in one launcher call on CUDA tensors, the plain version
    on CPU tensors. The call signature, the packed parameters and the
    optimizer state are those of
    :class:`~easyhybrid_tpu_torch.ops.fused_epoch.FusedEpoch`; ``perms``
    permute site slots (shuffle True) or site batches (``"batches"``). The
    data may cover fewer sites than the model has: the others see no
    gradient and still take every step. ``target_blocks`` and
    ``max_threads`` go to :func:`multisite_geometry` (the tests and the
    sweep set them; the defaults are the kernel's own)."""

    def __init__(self, model, optimizer, logging: LoggingLoss, *, shuffle: Any = True,
                 epochs_per_call: int = 1, target_blocks: int = _TARGET_BLOCKS,
                 max_threads: int = _MAX_THREADS):
        if shuffle not in SHUFFLES:
            raise ValueError(
                f"fused multisite epoch supports shuffle=True/False/'batches', got {shuffle!r}")
        self.plan = plan_fused_multisite(model, optimizer, logging)
        self.shuffle = shuffle
        self.epochs = max(1, int(epochs_per_call))
        self.aim = dict(target_blocks=int(target_blocks), max_threads=int(max_threads))

    def geometry(self, tensors: EpochTensors) -> MultisiteGeometry:
        """The gradient kernel's geometry for a call on ``tensors``."""
        return multisite_geometry(self.plan, int(tensors.weight.shape[1]),
                                  int(tensors.x.shape[2]), **self.aim)

    def inputs(self, tensors: EpochTensors, perms=None, generator=None):
        """``(data, site index, loss scales, validity flags)`` of a call."""
        data = multisite_data(self.plan, tensors)
        if data.x.ndim != 3 or int(tensors.n_samples) > self.plan.n_sites:
            raise ValueError(
                f"x of shape {tuple(tensors.x.shape)} with {tensors.n_samples} sites does not "
                f"hold (num_batches, batch, N, F) site batches of a model of "
                f"{self.plan.n_sites} sites")
        perms = perms_for_epochs(self.shuffle, tensors, self.epochs, generator=generator,
                                 perm=perms)
        index = site_index(self.shuffle, perms, data, self.epochs)
        if perms is None:  # every epoch has the same batches
            scale, valid = batch_scales(self.plan, data, index[:1])
            scale = scale.expand(self.epochs, -1, -1).contiguous()
            valid = valid.expand(self.epochs, -1).contiguous()
        else:
            scale, valid = batch_scales(self.plan, data, index)
        return data, index, scale, valid

    def __call__(self, model_or_packed, opt_state, tensors: EpochTensors, perms=None,
                 generator=None):
        plan = self.plan
        model = None if isinstance(model_or_packed, FusedParams) else model_or_packed
        packed = plan.pack(model) if model is not None else model_or_packed
        dev = tensors.weight.device
        for name, t in (("parameters", packed.params), ("moments", opt_state["m"]),
                        ("constants", plan.consts)):
            if t.device != dev:
                raise ValueError(f"the {name} are on {t.device}, the data on {dev}")
        data, index, scale, valid = self.inputs(tensors, perms, generator)
        if dev.type == "cpu":
            packed, opt_state, loss = fused_multisite_reference(
                plan, packed, opt_state, data, index, scale, valid)
        elif dev.type == "cuda":
            packed = FusedParams(packed.params.clone(), packed.bn.clone())
            opt_state = {k: v.clone() for k, v in opt_state.items()}
            epoch_loss = torch.zeros((self.epochs,), dtype=torch.float32, device=dev)
            launch_fused_multisite(plan, packed, opt_state, data, index, scale, valid, epoch_loss,
                                   **self.aim)
            loss = epoch_loss[-1] / data.n_batches
        else:
            raise ValueError(f"the fused multisite epoch runs on CUDA or CPU tensors; got {dev}")
        if model is not None:
            plan.unpack(packed, model)
            return model, opt_state, loss
        return packed, opt_state, loss

    def reference(self, packed: FusedParams, opt_state, tensors: EpochTensors, perms=None,
                  generator=None):
        """The plain version on the tensors' device (no kernel-5 launch)."""
        return fused_multisite_reference(self.plan, packed, opt_state,
                                         *self.inputs(tensors, perms, generator))


def make_fused_multisite_epoch(model, optimizer, logging: LoggingLoss, *, shuffle: Any = True,
                               epochs_per_call: int = 1, target_blocks: int = _TARGET_BLOCKS,
                               max_threads: int = _MAX_THREADS) -> FusedMultisiteEpoch:
    """Build the fused epoch of a :class:`MultiSiteHybridModel` (see
    :class:`FusedMultisiteEpoch`); raises if the model, optimizer or loss is
    outside the envelope or the kernel form's probe check fails."""
    return FusedMultisiteEpoch(model, optimizer, logging, shuffle=shuffle,
                               epochs_per_call=epochs_per_call, target_blocks=target_blocks,
                               max_threads=max_threads)
