"""The port's optimizer rules against optax: the same gradients over 5
steps, with a masked (skipped) step in the middle, for every rule the port
implements, and the rules it does not (with their ROADMAP item). Tolerance:
rtol 1e-5, atol 1e-7 on the parameters and every state slot (float32;
``b**t`` from another pow)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easyhybrid_tpu.training.optimizers import resolve_optimizer as jax_resolve
from easyhybrid_tpu_torch.training import optimizers as topt

SPECS = [
    ("adam", 0.01), "adam", ("adamw", 0.01), ("sgd", 0.05), ("sgd", 0.05, 0.9),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": 1.0}),
    ("rmsprop", 0.01), ("adagrad", 0.1), ("lion", 0.001), ("adamax", 0.01),
    ("nadam", 0.01), ("adadelta", 0.5), ("radam", 0.01), ("amsgrad", 0.01),
    ("lamb", 0.01), ("adam", {"learning_rate": 0.02, "b1": 0.8, "eps": 1e-6}),
]


def _jax_spec(spec):
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[1], dict) and "nesterov" in spec[1]:
        kw = dict(spec[1])
        kw["nesterov"] = bool(kw["nesterov"])
        return (spec[0], kw)
    return spec


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_rule_matches_optax(spec):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "g": rng.standard_normal((1,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    skip = 2  # an all-masked batch: the epoch does not call the optimizer

    jopt = jax_resolve(_jax_spec(spec))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt_ = topt.resolve_optimizer(spec)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt_.init(tp)
    for i, g in enumerate(grads):
        if i == skip:
            continue
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt_.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = topt.apply_updates(tp, tupd)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
    assert int(ts["count"]) == 4
    # every float slot of the optax state is in the port's state
    jleaves = sorted(float(np.abs(np.asarray(l)).sum()) for l in __import__("jax").tree.leaves(js)
                     if np.asarray(l).dtype == np.float32)
    tleaves = sorted(float(v.abs().sum()) for slot, tree in ts.items() if slot != "count"
                     for v in tree.values())
    np.testing.assert_allclose(tleaves, jleaves, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec,item", [
    ("noisy_sgd", "item 6"), ({"nn": "adam"}, "item 6"), ("lbfgs", "item 12"),
    (("rmsprop", {"learning_rate": 0.1, "centered": True}), "item 6"),
])
def test_rules_not_ported_name_their_roadmap_item(spec, item):
    with pytest.raises(NotImplementedError, match=item):
        topt.resolve_optimizer(spec)


def test_unknown_rule_and_defaults():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.resolve_optimizer("adamz")
    opt = topt.resolve_optimizer("sgd")
    assert opt.learning_rate == 0.01 and opt.hyperparameters["momentum"] == 0.0
    assert topt.resolve_optimizer(("adam", 0.1, 0.5)).hyperparameters["b1"] == 0.5
    assert set(topt.OPTIMIZERS) == {
        "adam", "adamw", "sgd", "rmsprop", "adagrad", "lion", "adamax", "nadam",
        "adadelta", "radam", "amsgrad", "lamb"}
