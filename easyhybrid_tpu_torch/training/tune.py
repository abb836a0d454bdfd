"""Hyperparameter tuning.

PyTorch counterpart of ``easyhybrid_tpu/training/tune.py`` (parity: the
reference ``ModelSpec`` / ``tune`` / ``best_hyperparams``,
src/training/tune.jl:3-57): rebuild the model from its own fields merged
with hyper overrides, then train; :func:`random_search`, :func:`grid_search`
and :func:`cross_validate` are drivers over :func:`train` and
:func:`~easyhybrid_tpu_torch.utils.folds.make_folds`, with the JAX package's
numpy draws, so that their trials and folds equal the JAX package's.

The port's ``train`` trains a model in place, where the JAX package's
returns new parameters and leaves the model as it was. So a rebuilt model
draws its weights from ``torch.Generator(random_seed)`` (``train``'s
``random_seed``, its default if none is given: every trial starts from the
same stream, as every JAX trial starts from the same key), and each fold of
:func:`cross_validate` trains a copy of the model, so every fold starts from
the same parameters.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.train_config import TrainConfig
from ..models.hybrid import MultiNNHybridModel, SingleNNHybridModel, construct_hybrid_model
from .train import train

__all__ = [
    "ModelSpec",
    "model_to_kwargs",
    "tune",
    "best_hyperparams",
    "random_search",
    "grid_search",
    "cross_validate",
]

log = logging.getLogger("easyhybrid_tpu_torch")


@dataclasses.dataclass
class ModelSpec:
    """Hyper overrides: ``hyper_model`` feeds the model constructor,
    ``hyper_train`` feeds ``train`` (parity: tune.jl:3-12)."""

    hyper_model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hyper_train: Dict[str, Any] = dataclasses.field(default_factory=dict)


def model_to_kwargs(model) -> Dict[str, Any]:
    """Extract the constructor kwargs of a generic hybrid model
    (parity: the ``to_namedtuple(model) + model.config`` merge, tune.jl:28)."""
    if isinstance(model, MultiNNHybridModel):
        predictors: Any = {k: list(v) for k, v in model.predictors}
    elif isinstance(model, SingleNNHybridModel):
        predictors = list(model.predictors)
    else:
        raise TypeError(
            f"tune supports generic hybrid models; got {type(model).__name__}"
        )
    kwargs = dict(
        predictors=predictors,
        forcing=list(model.forcing),
        targets=list(model.targets),
        mechanistic_model=model.mechanistic_model,
        parameters=model.param_table,
        global_param_names=list(model.global_param_names),
    )
    if isinstance(model, SingleNNHybridModel):
        kwargs["neural_param_names"] = list(model.neural_param_names)
    for k, v in model.config:
        if isinstance(v, tuple) and all(
            isinstance(e, tuple) and len(e) == 2 for e in v
        ) and v:
            v = dict(v)  # re-thaw frozen dict configs
        kwargs[k] = v
    return kwargs


def _random_seed(train_kwargs: Mapping[str, Any]) -> int:
    cfg = train_kwargs.get("train_cfg")
    default = cfg.random_seed if cfg is not None else TrainConfig().random_seed
    return int(train_kwargs.get("random_seed", default))


def tune(model, data, mspec: Optional[ModelSpec] = None, **kwargs):
    """Rebuild ``model`` with hyper overrides and train (tune.jl:27-44). The
    rebuilt model lives on ``model``'s device and draws its weights from
    ``torch.Generator(random_seed)``."""
    mspec = mspec or ModelSpec()
    train_kwargs = {**mspec.hyper_train, **kwargs}
    model_kwargs = {**model_to_kwargs(model), "device": model.device,
                    "generator": torch.Generator().manual_seed(_random_seed(train_kwargs)),
                    **mspec.hyper_model}
    hm = construct_hybrid_model(**model_kwargs)
    return train(hm, data, **train_kwargs)


def best_hyperparams(
    trials: Sequence[Tuple[Dict[str, Any], Any]], metric: str = "mse"
):
    """Direction-aware best over (hyperparams, TrainResults) trial records
    (parity: best_hyperparams(ho), tune.jl:46-57). ``best_loss`` tracks the
    first configured ``loss_types`` entry, so maximize-direction metrics
    (r2, nse, kge, pearson) must pick the LARGEST value — pass that metric
    name here (the search drivers do this automatically)."""
    from ..losses.metrics import is_better

    best = trials[0]
    for t in trials[1:]:
        if is_better(t[1].best_loss, best[1].best_loss, metric):
            best = t
    return best[0]


def _trial_metric(*kwarg_dicts: Mapping[str, Any]) -> str:
    """The metric name ``best_loss`` is tracked against for a trial: the
    first ``loss_types`` entry (falling back to ``training_loss``, then mse),
    scanning override dicts in priority order."""
    from ..losses.specs import loss_name

    for kw in kwarg_dicts:
        lt = kw.get("loss_types")
        if lt:
            return loss_name(lt[0])
    for kw in kwarg_dicts:
        tl = kw.get("training_loss")
        if tl is not None:
            return loss_name(tl)
    return "mse"


def _sample_space(space: Mapping[str, Any], rng: np.random.Generator):
    out = {}
    for k, v in space.items():
        if callable(v):
            out[k] = v(rng)
        elif isinstance(v, (list, tuple)):
            out[k] = v[int(rng.integers(len(v)))]
        else:
            out[k] = v
    return out


def _split_overrides(model, overrides: Dict[str, Any]) -> ModelSpec:
    model_keys = {
        "hidden_layers",
        "activation",
        "scale_nn_outputs",
        "input_batchnorm",
        "start_from_default",
    }
    hyper_model = {k: v for k, v in overrides.items() if k in model_keys}
    hyper_train = {k: v for k, v in overrides.items() if k not in model_keys}
    return ModelSpec(hyper_model, hyper_train)


def random_search(
    model,
    data,
    space: Mapping[str, Any],
    *,
    n_trials: int = 10,
    seed: int = 0,
    **train_kwargs,
):
    """Random search over ``space`` (values: list of choices or
    ``f(rng) -> value``). Returns ``(best_params, trials)``."""
    rng = np.random.default_rng(seed)
    trials: List[Tuple[Dict[str, Any], Any]] = []
    for i in range(n_trials):
        overrides = _sample_space(space, rng)
        mspec = _split_overrides(model, overrides)
        mspec.hyper_train.update(train_kwargs)
        result = tune(model, data, mspec)
        trials.append((overrides, result))
        log.info(
            "trial %d/%d %s -> best val %.6g",
            i + 1,
            n_trials,
            overrides,
            result.best_loss,
        )
    metric = _trial_metric(train_kwargs, *(ov for ov, _ in trials))
    return best_hyperparams(trials, metric), trials


def _n_rows(data) -> Optional[int]:
    """Rows of tabular data: a DataFrame's length, a dict of columns' column
    length; None when unsized."""
    if isinstance(data, Mapping):
        first = next(iter(data.values()), None)
        return None if first is None else len(first)
    return len(data) if hasattr(data, "__len__") else None


def cross_validate(
    model,
    data,
    *,
    k: int = 5,
    shuffle: bool = True,
    seed: int = 0,
    **train_kwargs,
):
    """K-fold cross-validation: train a copy of ``model`` once per fold,
    return ``(scores, results)`` (parity: the reference folds tutorial,
    docs/literate/tutorials/folds.jl, built on make_folds)."""
    from ..utils.folds import make_folds

    n = _n_rows(data)
    if n is None:
        raise TypeError("cross_validate needs sized tabular data")
    folds = make_folds(range(n), k=k, shuffle=shuffle, seed=seed)
    scores, results = [], []
    for fold in range(1, k + 1):
        res = train(copy.deepcopy(model), data, folds=folds, val_fold=fold, **train_kwargs)
        scores.append(res.best_loss)
        results.append(res)
        log.info("fold %d/%d best val loss %.6g", fold, k, res.best_loss)
    return scores, results


def grid_search(
    model,
    data,
    space: Mapping[str, Sequence[Any]],
    **train_kwargs,
):
    """Exhaustive grid over ``space`` (values: lists of choices)."""
    keys = list(space.keys())
    trials: List[Tuple[Dict[str, Any], Any]] = []
    for combo in itertools.product(*(space[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        mspec = _split_overrides(model, overrides)
        mspec.hyper_train.update(train_kwargs)
        result = tune(model, data, mspec)
        trials.append((overrides, result))
        log.info("grid %s -> best val %.6g", overrides, result.best_loss)
    metric = _trial_metric(train_kwargs, *(ov for ov, _ in trials))
    return best_hyperparams(trials, metric), trials
