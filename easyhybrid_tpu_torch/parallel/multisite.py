"""Multi-site hybrid modelling: one model over a leading ``site`` axis.

PyTorch counterpart of ``easyhybrid_tpu/parallel/multisite.py``. A
:class:`~easyhybrid_tpu_torch.models.hybrid.SingleNNHybridModel` is lifted
over sites, in one of two modes:

* ``share_nn=True`` (the default): the network's weights are shared by all
  sites while every global physical parameter is learned per site (one Q10
  per site), as one ``(S, 1)`` parameter;
* ``share_nn=False``: every site has its own network weights too
  (:class:`SiteNetworks`: stacked ``(S, …)`` leaves and one batched product
  per layer). This mode runs the torch engine only.

Data layout: ``x (S, N, F)``, forcing and targets ``(S, N)``. Batching
slices sites; ``forcing["_site_idx"]`` (added by
:func:`prepare_multisite_data`) tells the model which sites a batch holds.

Where the JAX model threads ``params`` / ``state`` pytrees, this module
holds them, under the same names as the base model: ``nn.*`` (the base's
own network, shared with it), ``globals.<name>`` (``(S, 1)``) and the
``fixed.<name>`` buffers. ``param_table`` is the parameter table
(``nn.Module.parameters`` is taken).

Trainable input BatchNorm (``input_batchnorm=True``) in training mode
normalises each site with its own statistics over time and moves the running
statistics by their mean over sites, as the JAX model's ``vmap`` over sites
does; the static and absent forms do not depend on the site.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..data.prepare import HybridData, _is_dataframe, dataframe_to_dict, prepare_data
from ..models.hybrid import MultiNNHybridModel, SingleNNHybridModel, _call_mechanistic
from ..models.nn import MLP, get_activation
from ..params import scale_param
from ..utils.device import default_device

__all__ = ["MultiSiteHybridModel", "SiteNetworks", "prepare_multisite_data"]


def _site_batchnorm(norm, x, scale, bias):
    """Training-mode BatchNorm under the site axis: ``x (S_b, N, F)`` is
    normalised per site over time, and the running statistics of ``norm``
    move by the mean over sites of the sites' statistics."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    with torch.no_grad():
        m = norm.momentum
        norm.mean.copy_((1 - m) * norm.mean + m * mean.mean(dim=(0, 1)))
        norm.var.copy_((1 - m) * norm.var + m * var.mean(dim=(0, 1)))
    return (x - mean) * torch.rsqrt(var + norm.eps) * scale + bias


class _SiteDense(nn.Module):
    """One layer of every site: ``weight (S, out, in)``, ``bias (S, out)``."""

    def __init__(self, layer, n_sites: int, generator):
        super().__init__()
        self.activation = layer.activation
        limit = (6.0 / (layer.in_dim + layer.out_dim)) ** 0.5  # glorot uniform, per site
        weight = torch.empty((n_sites, layer.out_dim, layer.in_dim), dtype=torch.float32)
        self.weight = nn.Parameter(weight.uniform_(-limit, limit, generator=generator))
        self.bias = nn.Parameter(torch.zeros((n_sites, layer.out_dim), dtype=torch.float32))


class _SiteNorm(nn.Module):
    """The input norm of every site: per-site affine ``scale`` / ``bias``
    ``(S, F)`` around one set of statistics."""

    def __init__(self, norm, n_sites: int):
        super().__init__()
        self.eps, self.momentum, self.frozen = norm.eps, norm.momentum, norm.frozen
        self.scale = nn.Parameter(torch.ones((n_sites, norm.in_dim)))
        self.bias = nn.Parameter(torch.zeros((n_sites, norm.in_dim)))
        self.register_buffer("mean", norm.mean.detach().clone())
        self.register_buffer("var", norm.var.detach().clone())


class SiteNetworks(nn.Module):
    """One MLP per site, shaped like ``template``: every parameter carries a
    leading site axis and a layer is one batched product over the sites of
    the batch. Weights are drawn per site from ``generator``."""

    def __init__(self, template: MLP, n_sites: int, generator=None):
        super().__init__()
        if not isinstance(template, MLP) or template.compute_dtype is not None:
            raise NotImplementedError(
                f"share_nn=False lifts a float32 MLP; a network of its own per site over "
                f"{type(template).__name__} (an LSTMNet, or an MLP with compute_dtype) is not "
                "ported to easyhybrid_tpu_torch yet (ROADMAP.md, queue A, item 4)")
        self.in_dim, self.out_dim, self.hidden = template.in_dim, template.out_dim, template.hidden
        self.input_batchnorm = template.input_batchnorm
        self.layers = nn.ModuleList(_SiteDense(layer, n_sites, generator)
                                    for layer in template.layers)
        self.norm = _SiteNorm(template.norm, n_sites) if template.norm is not None else None

    def forward(self, x, rows=None):
        """``x (S_b, N, F)`` through the networks of the sites ``rows``
        (``(S_b,)`` int64; every site in order when None)."""
        def of_batch(p):
            return p if rows is None else p[rows]

        h = x
        if self.norm is not None:
            norm = self.norm
            scale, bias = of_batch(norm.scale)[:, None, :], of_batch(norm.bias)[:, None, :]
            if self.training and not norm.frozen:
                h = _site_batchnorm(norm, h, scale, bias)
            else:
                h = (h - norm.mean) * torch.rsqrt(norm.var + norm.eps) * scale + bias
        for layer in self.layers:
            w, b = of_batch(layer.weight), of_batch(layer.bias)
            h = get_activation(layer.activation)(torch.baddbmm(b[:, None, :], h, w.transpose(1, 2)))
        return h


class _SiteScalars(nn.Module):
    """Named ``(S, 1)`` float32 parameters: one raw global per site."""

    def __init__(self, values: Mapping[str, torch.Tensor], n_sites: int):
        super().__init__()
        self.names = tuple(values)
        for name, v in values.items():
            tiled = v.detach().reshape(1, 1).to(torch.float32).repeat(n_sites, 1)
            self.register_parameter(name, nn.Parameter(tiled))

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.names}


class MultiSiteHybridModel(nn.Module):
    """``base`` over ``n_sites`` sites with per-site globals, each tiled
    from the base's current value, and the base's own network shared by all
    sites (``share_nn=True``) or one network per site drawn from
    ``generator`` (``share_nn=False``). Built on ``device``, or on the CUDA
    device when there is one and none is named; a shared network moves with
    it, because the base holds the same one."""

    def __init__(self, base: SingleNNHybridModel, n_sites: int, share_nn: bool = True, *,
                 generator: Optional[torch.Generator] = None, device: Any = None):
        super().__init__()
        if isinstance(base, MultiNNHybridModel):
            raise NotImplementedError(
                "MultiSiteHybridModel over a MultiNNHybridModel base (a network per neural "
                "parameter, per site or shared) is not ported to easyhybrid_tpu_torch yet "
                "(ROADMAP.md, queue A, item 4)")
        if not isinstance(base, SingleNNHybridModel):
            raise TypeError(
                f"MultiSiteHybridModel lifts a SingleNNHybridModel; got {type(base).__name__}")
        if int(n_sites) < 1:
            raise ValueError(f"n_sites must be positive; got {n_sites}")
        # the base is kept for its static description only: registering it as
        # a submodule would list its own (1,) globals among the parameters
        object.__setattr__(self, "base", base)
        self.n_sites = int(n_sites)
        self.share_nn = bool(share_nn)
        if self.share_nn or base.nn is None:
            self.nn = base.nn
        else:
            self.nn = SiteNetworks(base.nn, self.n_sites, generator)
        self.fixed = base.fixed
        self.globals = _SiteScalars(base.globals.as_dict(), self.n_sites)
        self.to(default_device() if device is None else device)

    # the base's static description --------------------------------------
    @property
    def targets(self):
        return self.base.targets

    @property
    def forcing(self):
        return self.base.forcing

    @property
    def predictors(self):
        return self.base.predictors

    @property
    def param_table(self):
        return self.base.param_table

    @property
    def mechanistic_model(self):
        return self.base.mechanistic_model

    @property
    def neural_param_names(self):
        return self.base.neural_param_names

    @property
    def global_param_names(self):
        return self.base.global_param_names

    @property
    def fixed_param_names(self):
        return self.base.fixed_param_names

    @property
    def scale_nn_outputs(self):
        return self.base.scale_nn_outputs

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ---------------------------------------------------------------------
    def forward(self, x, forcing: Optional[Mapping[str, Any]] = None):
        """Hybrid forward on ``x (S_b, N, F)`` and forcing name → ``(S_b,
        N)``. ``forcing["_site_idx"]`` (site ids as floats, one per row, or
        per sample and window step) selects the batch's rows of the per-site
        globals; without it the batch holds every site in order. Returns
        ``{**mechanistic_outputs, "parameters": all_params}`` with the
        per-site globals as ``(S_b, 1)``."""
        forcing = dict(forcing or {})
        site_idx = forcing.pop("_site_idx", None)
        rows = None
        if site_idx is not None:
            rows = site_idx.to(torch.int64)
            if rows.ndim > 1:
                rows = rows[..., 0]  # a copy per sample or window step: one per site
        table = self.param_table
        site_globals = {
            g: scale_param(raw if rows is None else raw[rows], table.lower_of(g), table.upper_of(g))
            for g, raw in self.globals.as_dict().items()
        }
        if self.nn is not None and self.neural_param_names:
            nn_params = self.base._split_nn_outputs(self._network(x, rows))
        else:
            nn_params = {}
        all_params = {**nn_params, **site_globals, **self.fixed.as_dict()}
        y_pred = _call_mechanistic(self.mechanistic_model, {**forcing, **all_params})
        return {**y_pred, "parameters": all_params}


    def _network(self, x, rows):
        net = self.nn
        if isinstance(net, SiteNetworks):
            return net(x, rows)
        norm = net.norm
        if norm is None or norm.frozen or not self.training or x.ndim != 3:
            return net(x)
        h = _site_batchnorm(norm, x, norm.scale, norm.bias)
        for layer in net.layers:
            h = layer(h)
        return h


def prepare_multisite_data(model, data, site_column: str) -> HybridData:
    """Tabular data with a site id column → site-major :class:`HybridData`.

    ``x (S, N, F)``, forcing and targets ``(S, N)`` with ``N`` the longest
    site's length; shorter sites are padded with NaN targets (masked out)
    and zero predictors. Sites keep the order of their first row. Feed the
    result to ``train`` with a :class:`MultiSiteHybridModel`; batching then
    slices sites."""
    if _is_dataframe(data):
        ids = np.asarray(data[site_column])
        cols = dataframe_to_dict(data)
    elif isinstance(data, Mapping):
        cols = {k: np.asarray(v) for k, v in data.items()}
        ids = np.asarray(cols[site_column])
    else:
        raise NotImplementedError(
            f"prepare_multisite_data takes a DataFrame or a dict of columns; "
            f"{type(data).__name__} (xarray input) is not ported to "
            "easyhybrid_tpu_torch yet (ROADMAP.md, queue A, item 1)")

    unique_ids = list(dict.fromkeys(ids.tolist()))
    per_site = []
    for sid in unique_ids:
        sel = np.nonzero(ids == sid)[0]
        site_cols = {k: np.asarray(v)[sel] for k, v in cols.items() if k != site_column}
        per_site.append(prepare_data(model, site_cols, drop_missing_rows=False))

    n_max = max(d.n_samples for d in per_site)

    def pad_stack(get, fill):
        arrs = []
        for d in per_site:
            a = np.asarray(get(d), np.float32)
            if a.shape[0] < n_max:
                pad = [(0, n_max - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad, constant_values=fill)
            arrs.append(a)
        return np.stack(arrs)

    x = pad_stack(lambda d: d.x, 0.0)
    forcing = {f: pad_stack(lambda d, f=f: d.forcing[f], 0.0) for f in model.forcing}
    # the per-site parameter selector: the site's index on every row
    forcing["_site_idx"] = np.broadcast_to(
        np.arange(len(per_site), dtype=np.float32)[:, None], (len(per_site), n_max)
    ).copy()
    y = {t: pad_stack(lambda d, t=t: d.y[t], np.nan) for t in model.targets}
    return HybridData(x=x, forcing=forcing, y=y)
