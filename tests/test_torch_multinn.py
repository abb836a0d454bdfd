"""Port parity of the MultiNN model family: ``MultiNNHybridModel`` (one
single-output MLP per neural parameter) and the Mapping branch of
``construct_hybrid_model`` against the JAX package's ``apply`` on the same
numpy inputs and carried parameters (``parameters`` and ``nn_outputs`` at
atol 1e-6, rtol 1e-5; the targets at atol 1e-6 times the size of their
formula's terms); ``load_jax_params`` /
``export_jax_params`` round trips; ``fit_input_norm`` per branch;
``predict_df`` / ``predict`` / ``train`` on the dict predictors; the printed
tables of ``models/show.py`` (equal strings); and ``make_hybrid``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm

from test_torch_fused_multinn import (BN_BRANCH, EXPO, MIXED, TWO_BRANCH, columns, expo_model,
                                      nee_jnp, nee_torch, reco_q)

RTOL, ATOL = 1e-5, 1e-6
QUICK_START = dict(
    predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
    mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
    neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=[16, 16],
    activation="swish", scale_nn_outputs=True, input_batchnorm="static")
# name -> (spec, JAX function, torch function, the columns it takes)
MODELS = {"expo": (EXPO, expo_model, expo_model, "expo"),
          "two_branch": (TWO_BRANCH, nee_jnp, nee_torch, "two_branch"),
          "bn_branch": (BN_BRANCH, reco_q, reco_q, "two_branch"),
          "per_branch_mapping": (MIXED, nee_jnp, nee_torch, "two_branch")}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def pair(name, n=300, seed=3):
    """The same MultiNN model in both packages from the JAX parameters, the
    static norms fitted per branch by the JAX package; the port's data."""
    spec, jax_fn, torch_fn, kind = MODELS[name]
    jm = eh.construct_hybrid_model(**spec, mechanistic_model=jax_fn)
    tm = et.construct_hybrid_model(**spec, mechanistic_model=torch_fn, device="cpu")
    data = et.prepare_data(tm, columns(kind, n, seed))
    params, state = jm.init(jax.random.PRNGKey(seed))
    state = jax_fit_input_norm(jm, state, data)
    et.load_jax_params(tm, _np_tree(params), _np_tree(state))
    return jm, params, state, tm, data


def _torch_inputs(data):
    return ({k: torch.tensor(v) for k, v in data.x.items()},
            {k: torch.tensor(v) for k, v in data.forcing.items()})


def _assert_close(got, want, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close(got[k], want[k], atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax_apply(name, training):
    jm, params, state, tm, data = pair(name)
    want, new_state = jm.apply(params, state, (data.x, data.forcing), training=training)
    tm.train(training)
    got = tm(*_torch_inputs(data))
    assert set(got) == set(want) and set(got["nn_outputs"]) == set(tm.nns)
    _assert_close(got["parameters"], want["parameters"])
    _assert_close(got["nn_outputs"], want["nn_outputs"])
    # a target is held at atol 1e-6 times the size of the terms of its formula:
    # nee = reco - gpp cancels terms of up to ~70, whose float32 ulp is ~8e-6
    # (torch's and XLA's exp and pow differ by an ulp)
    scale = 1.0 if name in ("expo", "bn_branch") else 70.0
    for t in tm.targets:
        _assert_close(got[t], want[t], ATOL * scale)
    assert got["nn_outputs"]["rb"].shape == (data.n_samples, 1)
    # trainable BatchNorm's running statistics move as the JAX state does
    got_state = et.export_jax_params(tm)[1]
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(_np_tree(new_state))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_construction_follows_the_jax_rules():
    """The mapping's keys, in its order, are the neural parameters (a
    ``neural_param_names`` argument is ignored); each branch is a
    single-output MLP over its predictors; a Mapping ``hidden_layers`` or
    ``activation`` is per branch."""
    tm = et.construct_hybrid_model(**BN_BRANCH, mechanistic_model=reco_q, device="cpu")
    jm = eh.construct_hybrid_model(**BN_BRANCH, mechanistic_model=reco_q)
    assert tm.neural_param_names == jm.neural_param_names == ("rb", "q")
    ignored = et.construct_hybrid_model(**{**BN_BRANCH, "neural_param_names": ["q"]},
                                        mechanistic_model=reco_q, device="cpu")
    assert ignored.neural_param_names == ("rb", "q") and ignored.fixed_param_names == ()
    tm = et.construct_hybrid_model(**MIXED, mechanistic_model=nee_torch, device="cpu")
    assert list(tm.nns) == ["rb", "gpp_max"] and tm.predictors == (
        ("rb", ("sw_pot", "dsw_pot")), ("gpp_max", ("ta",)))
    assert tm.nns["rb"].hidden == (12, 5) and tm.nns["gpp_max"].hidden == (7,)
    assert tm.nns["rb"].activation == "swish" and tm.nns["gpp_max"].activation == "softplus"
    assert all(net.out_dim == 1 for net in tm.nns.values())
    # a shared spec dict ({"lstm": n}) goes to every branch
    lstm = et.construct_hybrid_model(**{**EXPO, "hidden_layers": {"lstm": 4}},
                                      mechanistic_model=expo_model, device="cpu")
    assert all(isinstance(net, et.LSTMNet) for net in lstm.nns.values())


def test_partial_per_branch_mapping_raises_as_in_jax():
    """ADVICE.md (easyhybrid_tpu/models/hybrid.py:448): a Mapping that names
    some branches but not all is taken as one shared spec dict, which
    ``construct_nn`` refuses; both packages raise the same ValueError."""
    spec = {**EXPO, "hidden_layers": {"rb": [8], "kk": [8]}}  # a typo for k
    with pytest.raises(ValueError, match="unknown NN spec dict") as jax_err:
        eh.construct_hybrid_model(**spec, mechanistic_model=expo_model)
    with pytest.raises(ValueError, match="unknown NN spec dict") as torch_err:
        et.construct_hybrid_model(**spec, mechanistic_model=expo_model, device="cpu")
    assert str(jax_err.value) == str(torch_err.value)


def test_parameters_are_carried_by_name_not_position():
    """JAX sorts the branch keys (k before rb); the port keeps the mapping's
    order (rb before k). Each branch gets its own leaves all the same."""
    jm, params, state, tm, _ = pair("expo")
    assert [n.split(".")[1] for n, _ in tm.named_parameters()][:1] == ["rb"]
    assert list(params["nns"]) == ["k", "rb"] or sorted(params["nns"]) == ["k", "rb"]
    np.testing.assert_array_equal(tm.nns["k"].layers[0].weight.detach().numpy(),
                                  np.asarray(params["nns"]["k"]["layers"][0]["w"]).T)
    np.testing.assert_array_equal(tm.nns["rb"].norm.mean.numpy(),
                                  np.asarray(state["nns"]["rb"]["norm"]["mean"]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_round_trips_and_nests_as_jax(name):
    jm, params, state, tm, _ = pair(name)
    got_p, got_s = et.export_jax_params(tm)
    assert jax.tree.structure(got_p["nns"]) == jax.tree.structure(_np_tree(params["nns"]))
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(_np_tree(params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(_np_tree(state))):
        np.testing.assert_array_equal(a, b)
    assert set(got_s["nns"]) == set(tm.nns)
    twin = et.construct_hybrid_model(**MODELS[name][0], mechanistic_model=MODELS[name][2],
                                     device="cpu")
    et.load_jax_params(twin, got_p, got_s)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k])


def test_load_refuses_missing_extra_and_misshapen_leaves():
    _, params, state, tm, _ = pair("two_branch")
    params, state = _np_tree(params), _np_tree(state)
    bad = copy.deepcopy(params)
    del bad["nns"]["gpp_max"]["layers"][1]["b"]
    with pytest.raises(ValueError, match="missing.*nns/gpp_max/layers/1/b"):
        et.load_jax_params(tm, bad, state)
    bad = copy.deepcopy(params)
    bad["nns"]["extra"] = {"w": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="extra.*nns/extra/w"):
        et.load_jax_params(tm, bad, state)
    bad = copy.deepcopy(params)
    bad["nns"]["rb"]["layers"][0]["w"] = np.zeros((3, 8), np.float32)
    with pytest.raises(ValueError, match="nns/rb/layers/0/w"):
        et.load_jax_params(tm, bad, state)


def test_fit_input_norm_fits_each_branch_as_jax():
    jm = eh.construct_hybrid_model(**TWO_BRANCH, mechanistic_model=nee_jnp)
    tm = et.construct_hybrid_model(**TWO_BRANCH, mechanistic_model=nee_torch, device="cpu")
    data = et.prepare_data(tm, columns("two_branch", 400, 5))
    _, state = jm.init(jax.random.PRNGKey(0))
    want = jax_fit_input_norm(jm, state, data)
    et.fit_input_norm(tm, data)
    for branch, net in tm.nns.items():
        np.testing.assert_allclose(net.norm.mean.numpy(), want["nns"][branch]["norm"]["mean"],
                                   rtol=1e-6)
        np.testing.assert_allclose(net.norm.var.numpy(), want["nns"][branch]["norm"]["var"],
                                   rtol=1e-6)
    # sw_pot feeds both branches: its statistics in each (numpy sums a column of
    # two and of one in another order, so a few ulp apart, in both packages)
    np.testing.assert_allclose(float(tm.nns["rb"].norm.mean[0]),
                               float(tm.nns["gpp_max"].norm.mean[0]), rtol=1e-6)


def test_predict_df_appends_the_example_columns_as_jax():
    """examples/expo_hybrid.py's post-hoc inference: reco_pred, rb_pred and
    k_pred (PARITY.md section 3), NaN rows kept."""
    import pandas as pd

    jm, params, state, tm, _ = pair("expo")
    df = pd.DataFrame(columns("expo", 40, 8))
    df.loc[3, "sw_pot"] = np.nan
    want = jm.predict_df(params, state, df)
    got = tm.predict_df(df)
    assert list(got.columns) == list(want.columns)
    for c in ("reco_pred", "rb_pred", "k_pred"):
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(), rtol=RTOL, atol=ATOL)
    assert np.isnan(got.loc[3, "rb_pred"]) and np.isfinite(got.loc[3, "k_pred"])


def test_predict_runs_the_torch_engine_with_a_reason():
    """Kernel 1 takes only a SingleNN model, as the JAX kernel 1 does; the
    chunked torch forward serves a MultiNN model, names why, and returns
    what the JAX ``predict`` returns. Both flatten the outputs' nested
    dicts in order, so a branch's raw ``(N, 1)`` output (``nn_outputs``)
    takes its parameter's key after the scaled parameter."""
    jm, params, state, tm, _ = pair("two_branch")
    fn = et.make_inference_fn(tm, batch_size=64, use_kernel=True)
    assert fn.engine == "torch" and "not a SingleNNHybridModel" in fn.engine_reason
    cols = columns("two_branch", 300, 3)
    cols["sw_pot"][7] = np.nan
    got = fn(cols)
    want = eh.predict(jm, params, state, cols, batch_size=64)
    assert set(got) == set(want) >= {"nee", "rb", "gpp_max"}
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, atol=1e-5, err_msg=k)
    assert got["gpp_max"].shape == (300, 1) and np.isnan(got["nee"][7])


def test_train_on_the_torch_engine_matches_jax_from_carried_parameters():
    """``train`` of the ExpoHybrid spec on the CPU (the torch engine) from the
    JAX initial parameters, against the JAX ``train`` from the same ones: the
    same validation losses epoch by epoch. Unshuffled, so no random stream
    enters."""
    jm, params, state, tm, _ = pair("expo")
    cols = columns("expo", 500, 4)
    kw = dict(nepochs=4, batchsize=100, optimizer=("adamw", 0.01), training_loss="nseLoss",
              loss_types=["nseLoss", "mse"], shuffle_each_epoch=False, show_progress=False)
    got = et.train(tm, cols, train_from=(_np_tree(params), _np_tree(state)), **kw)
    import pandas as pd

    want = eh.train(jm, pd.DataFrame(cols), train_from=(params, state), use_kernel=False, **kw)
    assert got.epoch_path == "torch"
    np.testing.assert_allclose(got.best_loss, want.best_loss, rtol=1e-4)
    np.testing.assert_allclose([h["nseLoss"]["sum"] for h in got.val_history],
                               [h["nseLoss"]["sum"] for h in want.val_history], rtol=1e-4)
    assert set(got.params) == {k for k, _ in tm.named_parameters()}
    assert "nns.k.norm.mean" in got.state


def test_printed_models_equal_the_jax_strings():
    """``print(model)`` (install_reprs) and ``format_model`` give the JAX
    package's table for the SingleNN quick-start and the MultiNN example."""
    for spec in (QUICK_START, {**EXPO, "mechanistic_model": expo_model},
                 {**MIXED, "mechanistic_model": nee_torch}):
        jm = eh.construct_hybrid_model(**spec)
        tm = et.construct_hybrid_model(**spec, device="cpu")
        assert repr(tm) == repr(jm) == et.format_model(tm)
        assert str(tm) == eh.format_model(jm)
    table = et.format_parameter_table(tm.param_table, ("rb",), ("Q10",), ("gpp_max",))
    assert table == eh.format_parameter_table(jm.parameters, ("rb",), ("Q10",), ("gpp_max",))


def test_make_hybrid_matches_jax():
    """A custom model (``@hybrid`` parity): an MLP over two predictors and two
    raw physical scalars, the user's forward; the same outputs as the JAX
    model's from the same parameters, and a train() on the torch engine."""
    def forward_j(nn_out, forcing, p):
        return {"reco": nn_out[:, 0] * p["Q10"] ** (0.1 * (forcing["ta"] - p["tref"]))}

    def forward_t(nn_out, forcing, p):
        return {"reco": nn_out[:, 0] * p["Q10"] ** (0.1 * (forcing["ta"] - p["tref"]))}

    args = ("custom", ["sw_pot", "dsw_pot"], ["ta"], ["reco"], {"Q10": 2.0, "tref": 15.0})
    jm = eh.make_hybrid(*args, forward_j, nn=[8])
    tm = et.make_hybrid(*args, forward_t, nn=[8], device="cpu")
    assert isinstance(tm, et.CustomHybridModel) and tm.predictors == jm.predictors
    params, state = jm.init(jax.random.PRNGKey(1))
    et.load_jax_params(tm.nn, _np_tree(params["nn"]), _np_tree(state["nn"]))
    with torch.no_grad():
        for k in ("Q10", "tref"):
            tm.phys[k].copy_(torch.from_numpy(np.array(params[k])))
    cols = et.rbq10_columns(64, seed=2)
    x = np.stack([cols["sw_pot"], cols["dsw_pot"]], -1)
    want, _ = jm.apply(params, state, (jnp.asarray(x), {"ta": jnp.asarray(cols["ta"])}))
    got = tm(torch.from_numpy(x), {"ta": torch.from_numpy(cols["ta"])})
    np.testing.assert_allclose(got["reco"].detach().numpy(), np.asarray(want["reco"]),
                               rtol=RTOL, atol=1e-5)
    r = et.train(tm, et.rbq10_columns(300, seed=2), nepochs=2, batchsize=64, use_kernel=True,
                 show_progress=False)
    assert r.epoch_path == "torch" and "CustomHybridModel" in r.engine_reason
    assert np.isfinite(r.best_loss) and set(r.params) == {"phys.Q10", "phys.tref", *(
        f"nn.{k}" for k, _ in tm.nn.named_parameters())}
