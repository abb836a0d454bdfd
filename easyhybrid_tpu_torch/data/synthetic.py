"""Synthetic data for examples, tests and the on-card smoke run.

The same recipe and random stream as ``gen_rbq10_data`` in
``easyhybrid_tpu/data/synthetic.py``: the same seed gives the same columns
in both packages, and :func:`gen_multisite_arrays` is the numpy-only copy of
the JAX package's multi-site fixture. The numpy part is :func:`rbq10_columns`, which returns a
dict of columns (what ``prepare_data`` takes); pandas is imported only by
:func:`gen_rbq10_data`, which wraps those columns in a DataFrame.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .prepare import HybridData

__all__ = ["gen_rbq10_data", "rbq10_columns", "gen_multisite_arrays"]


def rbq10_columns(
    n: int = 20_000,
    *,
    seed: int = 42,
    true_q10: float = 2.0,
    tref: float = 15.0,
    noise: float = 0.1,
    nan_frac: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Synthetic soil-respiration columns with known Q10.

    ``reco = rb(sw_pot) * Q10^((ta - tref)/10) + noise`` with
    ``rb = 3 + 0.02 (sw_pot - mean)``; ``nan_frac`` of the targets are NaN.
    """
    rng = np.random.default_rng(seed)
    ta = 10.0 + 10.0 * rng.standard_normal(n)
    sw_pot = np.abs(50.0 + 20.0 * rng.standard_normal(n))
    dsw_pot = np.concatenate([[0.0], np.diff(sw_pot)])
    true_rb = 3.0 + 0.02 * (sw_pot - sw_pot.mean())
    reco = true_rb * true_q10 ** (0.1 * (ta - tref)) + noise * rng.standard_normal(n)
    if nan_frac > 0:
        drop = rng.random(n) < nan_frac
        reco = np.where(drop, np.nan, reco)
    return dict(
        ta=ta.astype(np.float32),
        sw_pot=sw_pot.astype(np.float32),
        dsw_pot=dsw_pot.astype(np.float32),
        rb_syn=true_rb.astype(np.float32),
        reco=reco.astype(np.float32),
        id=np.arange(1, n + 1),
    )


def linear_columns(n: int = 1000, *, seed: int = 123) -> Dict[str, np.ndarray]:
    """``obs = a_syn(x2, x3) * x1 + 2 + noise`` with
    ``a_syn = exp(-5 (x2 - 0.7)^2) + x3 / 10``, as a dict of columns; ``seqID``
    numbers runs of 10 rows."""
    rng = np.random.default_rng(seed)
    x1, x2, x3 = rng.random((3, n), dtype=np.float32)
    a_syn = np.exp(-5.0 * (x2 - 0.7) ** 2) + x3 / 10.0
    obs = a_syn * x1 + 2.0 + 0.1 * rng.random(n, dtype=np.float32)
    return dict(
        x1=x1, x2=x2, x3=x3,
        a_syn=a_syn.astype(np.float32),
        obs=obs.astype(np.float32),
        pred_syn=obs.astype(np.float32),
        seqID=np.repeat(np.arange(1, n // 10 + 1), 10)[:n],
    )


def linear_2outputs_columns(n: int = 1000, *, seed: int = 123) -> Dict[str, np.ndarray]:
    """The two-target dynamic variant: ``a_dyn`` is the cumulative sum of
    ``x2 - x3`` within each run of 10 rows, ``obs_dyn1 = a_dyn * x1 + 2`` and
    ``obs_dyn2 = 0.5 * a_dyn * x2``."""
    rng = np.random.default_rng(seed)
    x1, x2, x3 = rng.random((3, n), dtype=np.float32)
    seq_id = np.repeat(np.arange(1, n // 10 + 1), 10)[:n]
    a_dyn = np.zeros(n, np.float32)
    for sid in np.unique(seq_id):
        m = seq_id == sid
        a_dyn[m] = np.cumsum(x2[m] - x3[m])
    return dict(
        x1=x1, x2=x2, x3=x3, seqID=seq_id, a_dyn_syn=a_dyn,
        obs_dyn1=(a_dyn * x1 + 2.0).astype(np.float32),
        obs_dyn2=(0.5 * a_dyn * x2).astype(np.float32),
    )


def gen_linear_data(n: int = 1000, *, seed: int = 123):
    """:func:`linear_columns` as a pandas DataFrame."""
    import pandas as pd

    return pd.DataFrame(linear_columns(n, seed=seed))


def gen_linear_data_2outputs(n: int = 1000, *, seed: int = 123):
    """:func:`linear_2outputs_columns` as a pandas DataFrame."""
    import pandas as pd

    return pd.DataFrame(linear_2outputs_columns(n, seed=seed))


def gen_rbq10_data(n: int = 20_000, **kwargs):
    """:func:`rbq10_columns` as a pandas DataFrame."""
    import pandas as pd

    return pd.DataFrame(rbq10_columns(n, **kwargs))


def gen_multisite_arrays(
    n_sites: int,
    n_obs: int,
    *,
    seed: int = 0,
    nan_frac: float = 0.0,
    site_idx: bool = True,
) -> HybridData:
    """Synthetic multi-site arrays in ``prepare_multisite_data``'s layout:
    ``x (S, N, 2)``, forcing ``ta (S, N)``, target ``reco (S, N)`` and, when
    ``site_idx``, the identity per-site selector ``_site_idx``. The same
    seed gives the same numbers as the JAX package's fixture.

    The fused multisite kernel reads site ``s``'s parameters for data row
    ``s``; ``supports_fused_multisite`` checks that the data's site order is
    this identity before ``train`` takes the kernel."""
    S, N = int(n_sites), int(n_obs)
    rng = np.random.default_rng(seed)
    x = rng.random((S, N, 2)).astype(np.float32)
    forcing = {"ta": (10 + 10 * rng.random((S, N))).astype(np.float32)}
    if site_idx:
        forcing["_site_idx"] = np.broadcast_to(
            np.arange(S, dtype=np.float32)[:, None], (S, N)
        ).copy()
    y = (2 + rng.random((S, N))).astype(np.float32)
    if nan_frac:
        y[rng.random((S, N)) < nan_frac] = np.nan
    return HybridData(x=x, forcing=forcing, y={"reco": y})
