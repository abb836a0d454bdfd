"""Port parity: bound transforms and the parameter table of
easyhybrid_tpu_torch.params against easyhybrid_tpu.params (float32,
rtol=1e-5, atol=1e-6)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu.params as jp
import easyhybrid_tpu_torch.params as tp

RTOL, ATOL = 1e-5, 1e-6
BOUNDS = [(0.0, 13.0), (1.0, 4.0), (0.1, 0.7), (-5.0, 5.0)]


def _raw(seed=0, n=257):
    return (np.random.default_rng(seed).standard_normal(n) * 6).astype(np.float32)


@pytest.mark.parametrize("kind", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_scale_param_matches_jax(kind, lo, hi):
    raw = _raw()
    want = np.asarray(jp.scale_param(jnp.asarray(raw), lo, hi, kind))
    got = tp.scale_param(torch.from_numpy(raw), lo, hi, kind).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_unscale_param_matches_jax(kind, lo, hi):
    rng = np.random.default_rng(1)
    # inside the box, away from the bounds where the logit blows up
    vals = (lo + (hi - lo) * rng.uniform(0.05, 0.95, 101)).astype(np.float32)
    want = np.asarray(jp.unscale_param(jnp.asarray(vals), lo, hi, kind))
    got = tp.unscale_param(torch.from_numpy(vals), lo, hi, kind).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    # and the round trip
    back = tp.scale_param(torch.from_numpy(got), lo, hi, kind).numpy()
    np.testing.assert_allclose(back, vals, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "name", ["sigmoid", "hard_sigmoid", "inv_sigmoid", "inv_hard_sigmoid"]
)
def test_transforms_on_tensors(name):
    x = _raw(2)
    if name == "inv_sigmoid":
        x = np.random.default_rng(2).uniform(0.01, 0.99, 257).astype(np.float32)
    want = np.asarray(getattr(jp, name)(jnp.asarray(x)))
    got = getattr(tp, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("y", [0.0, 1.0, -0.5, 1.5, 0.25, 0.999])
def test_inv_sigmoid_python_scalars(y):
    """Python floats stay on the host and hit the bounds as the tensor log
    would: ±inf at 0/1, nan outside."""
    want = jp.inv_sigmoid(y)
    got = tp.inv_sigmoid(y)
    assert isinstance(got, float)
    if math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("x", [-800.0, -3.0, 0.0, 2.5, 800.0])
def test_scalar_sigmoids(x):
    assert tp.sigmoid(x) == pytest.approx(float(jp.sigmoid(x)), rel=1e-6, abs=1e-30)
    assert tp.hard_sigmoid(x) == pytest.approx(float(jp.hard_sigmoid(x)))
    assert tp.scale_param(x, 1.0, 4.0) == pytest.approx(
        float(jp.scale_param(x, 1.0, 4.0)), rel=1e-6
    )


def test_parameter_container_matches_jax():
    table = {
        "rb": (3.0, 0.0, 13.0),
        "Q10": {"default": 2.0, "lower": 1.0, "upper": 4.0},
        "k": 0.5,
        "m": {"default": -2.0},
    }
    a, b = jp.ParameterContainer.from_dict(table), tp.ParameterContainer.from_dict(table)
    assert a.names == b.names
    for field in ("default", "lower", "upper"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.as_dict() == b.as_dict()
    assert tp.build_parameters(b) is b
    assert b.bounds_of(["Q10"])[1][0] == 4.0
    assert b.subset(["k"]).names == ("k",)
    with pytest.raises(KeyError):
        b.index("nope")


@pytest.mark.parametrize(
    "table", [{"a": (1.0, 2.0, 3.0)}, {"a": (1.0, 3.0, 2.0)}, {"a": (1.0, 2.0)}]
)
def test_parameter_container_rejects_what_jax_rejects(table):
    with pytest.raises(ValueError):
        jp.ParameterContainer.from_dict(table)
    with pytest.raises(ValueError):
        tp.ParameterContainer.from_dict(table)
