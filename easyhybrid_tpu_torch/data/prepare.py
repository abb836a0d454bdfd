"""Data preparation: tabular data → dense batch-major numpy arrays.

A numpy-only copy of ``easyhybrid_tpu/data/prepare.py``: DataFrame
missing→NaN coercion, row filtering (drop rows with any-NaN
predictor/forcing or all-NaN targets), float32 cast, samples on the leading
axis (``(N, features)``, row-major). The port takes a DataFrame, a dict of
columns or a :class:`HybridData`; xarray input is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Sequence

import numpy as np

__all__ = ["HybridData", "prepare_data", "dataframe_to_dict"]


class HybridData(NamedTuple):
    """Prepared dataset: ``((x, forcing), y)`` flattened into one record.

    * ``x`` — ``(N, F)`` float32 predictors (SingleNN), a dict
      ``branch -> (N, F_b)`` (MultiNN), or ``(N, T, F)`` after windowing.
    * ``forcing`` — dict ``name -> (N,)`` (or ``(N, T)`` after windowing).
    * ``y`` — dict ``target -> (N,)`` (or ``(N, T_out)`` after windowing).

    Arrays stay host-side numpy; the inference driver moves each chunk to
    the model's device.
    """

    x: Any
    forcing: Dict[str, Any]
    y: Dict[str, Any]

    @property
    def n_samples(self) -> int:
        x = self.x
        if isinstance(x, Mapping):
            x = next(iter(x.values()))
        return int(np.shape(x)[0])

    def take(self, idx) -> "HybridData":
        """Subset samples along the leading axis (host-side numpy)."""
        take_x = (
            {k: np.asarray(v)[idx] for k, v in self.x.items()}
            if isinstance(self.x, Mapping)
            else np.asarray(self.x)[idx]
        )
        return HybridData(
            x=take_x,
            forcing={k: np.asarray(v)[idx] for k, v in self.forcing.items()},
            y={k: np.asarray(v)[idx] for k, v in self.y.items()},
        )

    def as_batch(self):
        """The model-apply view: ``((x, forcing), y)``."""
        return (self.x, self.forcing), self.y


def _is_dataframe(data) -> bool:
    return type(data).__name__ == "DataFrame" and hasattr(data, "columns")


def dataframe_to_dict(df) -> Dict[str, np.ndarray]:
    """DataFrame → dict of float32 columns with missing → NaN."""
    out = {}
    for col in df.columns:
        s = df[col]
        try:
            arr = s.to_numpy(dtype=np.float32, na_value=np.nan)
        except (TypeError, ValueError):
            arr = s.to_numpy()  # non-numeric (ids etc.) pass through
        out[str(col)] = arr
    return out


def _stack_columns(cols: Dict[str, np.ndarray], names: Sequence[str]) -> np.ndarray:
    missing = [n for n in names if n not in cols]
    if missing:
        raise KeyError(f"columns {missing} not found in data; have {sorted(cols)}")
    return np.stack([np.asarray(cols[n], np.float32) for n in names], axis=-1)


def prepare_data(
    model,
    data,
    *,
    drop_missing_rows: bool = True,
    return_keep: bool = False,
):
    """Extract predictors/forcing/targets for ``model`` from ``data``.

    ``data`` may be a pandas DataFrame, a mapping ``column -> 1-D array``,
    or an already-prepared :class:`HybridData` (passed through).
    """
    if isinstance(data, HybridData):
        return (data, None) if return_keep else data
    if isinstance(data, tuple) and len(data) == 2:
        (x, forcing), y = data
        out = HybridData(x=x, forcing=dict(forcing), y=dict(y))
        return (out, None) if return_keep else out

    if _is_dataframe(data):
        cols = dataframe_to_dict(data)
    elif isinstance(data, Mapping):
        cols = {str(k): np.asarray(v) for k, v in data.items()}
    else:
        raise TypeError(
            "prepare_data expects a DataFrame, a dict of columns, or a "
            f"HybridData; got {type(data).__name__}"
        )

    predictors = model.predictors
    multi = isinstance(predictors, tuple) and predictors and isinstance(
        predictors[0], tuple
    ) and not isinstance(predictors[0], str)

    if multi:
        pred_names = sorted({p for _, ps in predictors for p in ps})
    else:
        pred_names = list(predictors)
    forcing_names = list(model.forcing)
    target_names = list(model.targets)

    # row filtering: complete predictors/forcing AND at least one target
    keep = None
    if drop_missing_rows:
        n = len(next(iter(cols.values())))
        keep = np.ones(n, bool)
        predforce = pred_names + [f for f in forcing_names if f not in pred_names]
        if predforce:
            pf = _stack_columns(cols, predforce)
            keep &= ~np.any(np.isnan(pf), axis=-1)
        if target_names:
            ty = _stack_columns(cols, target_names)
            keep &= np.any(~np.isnan(ty), axis=-1)
        if not np.all(keep):
            cols = {
                k: (np.asarray(v)[keep] if np.ndim(v) >= 1 and len(v) == n else v)
                for k, v in cols.items()
            }

    if multi:
        x = {name: _stack_columns(cols, ps) for name, ps in predictors}
    elif pred_names:
        x = _stack_columns(cols, pred_names)
    else:
        x = np.zeros((len(next(iter(cols.values()))), 0), np.float32)

    forcing = {f: np.asarray(cols[f], np.float32) for f in forcing_names}
    y = {t: np.asarray(cols[t], np.float32) for t in target_names}
    out = HybridData(x=x, forcing=forcing, y=y)
    return (out, keep) if return_keep else out
