"""Synthetic RbQ10 data for examples, tests and the on-card smoke run.

The same recipe and random stream as ``gen_rbq10_data`` in
``easyhybrid_tpu/data/synthetic.py``: the same seed gives the same columns
in both packages. The numpy part is :func:`rbq10_columns`, which returns a
dict of columns (what ``prepare_data`` takes); pandas is imported only by
:func:`gen_rbq10_data`, which wraps those columns in a DataFrame.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["gen_rbq10_data", "rbq10_columns"]


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


def gen_rbq10_data(n: int = 20_000, **kwargs):
    """:func:`rbq10_columns` as a pandas DataFrame."""
    import pandas as pd

    return pd.DataFrame(rbq10_columns(n, **kwargs))
