"""Port parity: SingleNNHybridModel.forward of easyhybrid_tpu_torch against
the JAX model's apply, on the README quick-start model and on the
conftest RbQ10 fixture, all outputs including "parameters" (float32,
rtol=1e-5, atol=1e-6)."""

import jax
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm

RTOL, ATOL = 1e-5, 1e-6
PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}


def rbq10(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


QUICK_START = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
    mechanistic_model=rbq10, parameters=PARAMS,
    neural_param_names=["rb"], global_param_names=["Q10"],
    hidden_layers=[16, 16], activation="swish",
    scale_nn_outputs=True, input_batchnorm="static",
)
# the spec of tests/conftest.py's rbq10_model fixture
CONFTEST_FIXTURE = {**QUICK_START, "hidden_layers": [8, 8], "activation": "tanh",
                    "input_batchnorm": True}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(spec, data, seed=0):
    """The same model in both packages, the JAX weights carried across."""
    jm = eh.construct_hybrid_model(**spec)
    params, state = jm.init(jax.random.PRNGKey(seed))
    state = jax_fit_input_norm(jm, state, data)
    tm = et.construct_hybrid_model(**spec, device="cpu")  # compared with numpy: on the host
    et.load_jax_params(tm, _np_tree(params), _np_tree(state))
    return jm, params, state, tm


def _inputs(data):
    return torch.tensor(data.x), {k: torch.tensor(v) for k, v in data.forcing.items()}


def _assert_outputs_match(got, want):
    assert set(got) == set(want)
    assert set(got["parameters"]) == set(want["parameters"])
    for k, v in want["parameters"].items():
        np.testing.assert_allclose(got["parameters"][k].detach().numpy(), np.asarray(v),
                                   rtol=RTOL, atol=ATOL)
    for k in want:
        if k != "parameters":
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spec", [QUICK_START, CONFTEST_FIXTURE],
                         ids=["quick_start", "conftest_fixture"])
def test_forward_matches_jax_apply(spec):
    df = eh.gen_rbq10_data(300, seed=7)
    data = eh.prepare_data(eh.construct_hybrid_model(**spec), df)
    jm, params, state, tm = _pair(spec, data)
    x, forcing = _inputs(data)

    want, _ = jm.apply(params, state, (data.x, data.forcing), training=False)
    tm.eval()
    with torch.no_grad():
        got = tm(x, forcing)
    _assert_outputs_match(got, want)

    want_t, new_state = jm.apply(params, state, (data.x, data.forcing), training=True)
    tm.train()
    with torch.no_grad():
        got_t = tm(x, forcing)
    _assert_outputs_match(got_t, want_t)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm.nn.norm, k).numpy(),
                                   np.asarray(new_state["nn"]["norm"][k]),
                                   rtol=RTOL, atol=ATOL)


def test_conftest_fixture_matches(rbq10_model, rbq10_df):
    """The conftest fixture itself, against its port built from the same spec."""
    data = eh.prepare_data(rbq10_model, rbq10_df)
    params, state = rbq10_model.init(jax.random.PRNGKey(3))
    tm = et.construct_hybrid_model(**CONFTEST_FIXTURE)
    et.load_jax_params(tm, _np_tree(params), _np_tree(state))
    want, _ = rbq10_model.apply(params, state, (data.x, data.forcing))
    tm.eval()
    with torch.no_grad():
        got = tm(*_inputs(data))
    _assert_outputs_match(got, want)


def test_init_matches_jax_defaults():
    """Globals start at the inverse sigmoid of the table default; fixed
    parameters sit in buffers at their defaults."""
    spec = {**QUICK_START, "parameters": {**PARAMS, "tref": (15.0, 0.0, 30.0)}}
    jm = eh.construct_hybrid_model(**spec)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tm.globals.Q10.detach().numpy(),
                               np.asarray(params["globals"]["Q10"]), rtol=RTOL)
    assert tm.fixed_param_names == jm.fixed_param_names == ("tref",)
    assert tm.fixed.tref.item() == float(state["fixed"]["tref"][0])
    assert "fixed.tref" in dict(tm.named_buffers())
    assert "globals.Q10" in dict(tm.named_parameters())
    # explicit generator: same seed, same weights
    tm2 = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tm.nn.layers[0].weight, tm2.nn.layers[0].weight)
    # random start of the globals draws from the generator
    r = et.construct_hybrid_model(**{**spec, "start_from_default": False},
                                  generator=torch.Generator().manual_seed(1))
    assert 0.0 <= r.globals.Q10.item() < 1.0


def test_predict_df_matches_jax():
    df = eh.gen_rbq10_data(200, seed=3)
    df.loc[5, "sw_pot"] = np.nan
    data = eh.prepare_data(eh.construct_hybrid_model(**QUICK_START), df)
    jm, params, state, tm = _pair(QUICK_START, data)
    want = jm.predict_df(params, state, df)
    got = tm.predict_df(df)
    assert list(got.columns) == list(want.columns)
    for c in ("reco_pred", "rb_pred"):
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                   rtol=RTOL, atol=ATOL)
    assert np.isnan(got.loc[5, "reco_pred"])
    assert tm.training  # predict_df leaves the mode as it found it


def test_constructor_errors():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        et.construct_hybrid_model(**{**QUICK_START, "predictors": {"rb": ["sw_pot"]}})
    with pytest.raises(ValueError, match="global parameter"):
        et.construct_hybrid_model(**{**QUICK_START, "global_param_names": ["nope"]})
    with pytest.raises(ValueError, match="mechanistic_model"):
        et.construct_hybrid_model(**{**QUICK_START, "mechanistic_model": None})
    tm = et.construct_hybrid_model(**QUICK_START)
    with pytest.raises(KeyError, match="requires"):
        tm(torch.zeros((4, 2)), {})


def test_model_without_network():
    """No predictors: the mechanistic model runs on globals and forcing."""
    spec = {**QUICK_START, "predictors": [], "neural_param_names": [],
            "global_param_names": ["rb", "Q10"]}
    jm = eh.construct_hybrid_model(**spec)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = et.construct_hybrid_model(**spec)
    assert tm.nn is None
    et.load_jax_params(tm, _np_tree(params), _np_tree(state))
    ta = np.linspace(-5, 30, 11).astype(np.float32)
    want, _ = jm.apply(params, state, (np.zeros((11, 0), np.float32), {"ta": ta}))
    got = tm(torch.zeros((11, 0)), {"ta": torch.from_numpy(ta)})
    _assert_outputs_match(got, want)


@pytest.mark.parametrize("has_cuda,want", [(True, "cuda"), (False, "cpu")])
def test_default_device_follows_cuda_availability(monkeypatch, has_cuda, want):
    """Entry points take the card when there is one: the helper's rule, with
    no tensor moved (this machine may have no card)."""
    from easyhybrid_tpu_torch.utils import device as device_module

    monkeypatch.setattr(torch.cuda, "is_available", lambda: has_cuda)
    assert et.default_device() == torch.device(want)
    asked = []
    monkeypatch.setattr(et.SingleNNHybridModel, "to",
                        lambda self, device: asked.append(torch.device(device)) or self)
    et.construct_hybrid_model(**QUICK_START)
    et.construct_hybrid_model(**QUICK_START, device="cpu")
    assert asked == [torch.device(want), torch.device("cpu")]
    assert device_module.default_device() == torch.device(want)


def test_models_asked_for_the_cpu_stay_there():
    tm = et.construct_hybrid_model(**QUICK_START, device="cpu")
    ms = et.MultiSiteHybridModel(tm, 3, device="cpu")
    assert tm.device.type == ms.device.type == "cpu"
    assert et.make_inference_fn(tm).engine == "torch"
