"""Pretty-printing for hybrid models and parameter tables.

A copy of ``easyhybrid_tpu/models/show.py`` for the port's modules: the same
plain-text tables, so ``print(model)`` gives the JAX package's string. The
port's models keep their parameter table in ``param_table`` and a MultiNN
model its networks in the ``ModuleDict`` ``nns``.
"""

from __future__ import annotations

from typing import List

__all__ = ["format_parameter_table", "format_model", "install_reprs"]


def format_parameter_table(pc, neural=(), global_=(), fixed=()) -> str:
    rows: List[List[str]] = []
    for i, name in enumerate(pc.names):
        kind = (
            "neural"
            if name in neural
            else "global"
            if name in global_
            else "fixed"
            if name in fixed
            else "-"
        )
        rows.append(
            [
                name,
                f"{pc.default[i]:.4g}",
                f"{pc.lower[i]:.4g}",
                f"{pc.upper[i]:.4g}",
                kind,
            ]
        )
    headers = ["parameter", "default", "lower", "upper", "kind"]
    widths = [
        max(len(headers[j]), *(len(r[j]) for r in rows)) if rows else len(headers[j])
        for j in range(5)
    ]

    def fmt(cells):
        return " │ ".join(c.ljust(w) for c, w in zip(cells, widths))

    sep = "─┼─".join("─" * w for w in widths)
    lines = [fmt(headers), sep] + [fmt(r) for r in rows]
    return "\n".join("  " + line for line in lines)


def _nn_summary(nn) -> str:
    if nn is None:
        return "none"
    cls = type(nn).__name__
    if hasattr(nn, "hidden"):
        return (
            f"{cls}({nn.in_dim} → {' → '.join(map(str, nn.hidden))} → "
            f"{nn.out_dim}, act={nn.activation}"
            f"{', input_batchnorm' if getattr(nn, 'input_batchnorm', False) else ''})"
        )
    if hasattr(nn, "hidden_size"):
        return f"{cls}({nn.in_dim} → lstm({nn.hidden_size}) → {nn.out_dim})"
    return cls


def format_model(m) -> str:
    lines = [f"{type(m).__name__}("]
    if hasattr(m, "nns"):
        lines.append("  NNs:")
        for name, nn in m.nns.items():
            preds = dict(m.predictors)[name]
            lines.append(f"    {name}: {_nn_summary(nn)}  predictors={list(preds)}")
    else:
        lines.append(f"  NN: {_nn_summary(getattr(m, 'nn', None))}")
        lines.append(f"  predictors: {list(m.predictors)}")
    lines.append(f"  forcing:    {list(m.forcing)}")
    lines.append(f"  targets:    {list(m.targets)}")
    mech = getattr(m, "mechanistic_model", None)
    if mech is not None:
        lines.append(f"  mechanistic_model: {getattr(mech, '__name__', mech)}")
    lines.append(
        f"  scale_nn_outputs={m.scale_nn_outputs}, "
        f"start_from_default={m.start_from_default}"
    )
    lines.append("  parameters:")
    lines.append(
        format_parameter_table(
            m.param_table,
            m.neural_param_names,
            m.global_param_names,
            m.fixed_param_names,
        )
    )
    lines.append(")")
    return "\n".join(lines)


def install_reprs() -> None:
    """``repr`` (and so ``print``) of the port's hybrid models is
    :func:`format_model`'s table, as in the JAX package."""
    from .hybrid import MultiNNHybridModel, SingleNNHybridModel

    SingleNNHybridModel.__repr__ = lambda self: format_model(self)
    MultiNNHybridModel.__repr__ = lambda self: format_model(self)
