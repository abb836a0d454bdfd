"""The port's multi-site path against the JAX package: the synthetic fixture,
``prepare_multisite_data`` on a ragged table, ``MultiSiteHybridModel``'s
forward, the site-major layout through ``split_data`` / ``build_epoch_tensors``
/ ``fit_input_norm`` / the evaluator, the torch epoch with the JAX
permutations injected, ``train()`` as a whole, and the parameter carry.

Inputs come from numpy seeds; the JAX initial parameters are carried across
with ``load_jax_params`` and every model is built on the CPU explicitly.
Tolerances, float32: forward atol 1e-5; epochs atol 5e-5 / rtol 5e-4 after 3
epochs, as tests/test_fused_multisite.py holds its kernel to the XLA epoch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.data.prepare import HybridData as JaxHybridData
from easyhybrid_tpu.data.synthetic import gen_multisite_arrays as jax_multisite_arrays
from easyhybrid_tpu.parallel.multisite import prepare_multisite_data as jax_prepare_multisite
from easyhybrid_tpu.training.epoch import epoch_permutation as jax_permutation
from easyhybrid_tpu.training.epoch import make_dual_evaluator as jax_dual_evaluator
from easyhybrid_tpu.training.epoch import make_train_epoch as jax_train_epoch
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer
from easyhybrid_tpu_torch.training.train import _full_batch


def _rbq10(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def spec(hidden=(8, 8), norm=False, **kw):
    out = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers=list(hidden),
        activation="swish", scale_nn_outputs=True, input_batchnorm=norm,
    )
    out.update(kw)
    return out


def pair(S, *, seed=3, spread=True, share_nn=True, **kw):
    """The JAX multi-site model with its parameters and state, and the
    port's with the same parameters (per-site Q10 spread out by numpy)."""
    sp = spec(**kw)
    jm = eh.MultiSiteHybridModel(eh.construct_hybrid_model(mechanistic_model=_rbq10, **sp),
                                 n_sites=S, share_nn=share_nn)
    params, state = jm.init(jax.random.PRNGKey(seed))
    if spread:
        rng = np.random.default_rng(seed)
        params = dict(params)
        params["globals"] = {g: v + jnp.asarray(rng.normal(0, 0.5, v.shape), jnp.float32)
                             for g, v in params["globals"].items()}
    tm = et.MultiSiteHybridModel(
        et.construct_hybrid_model(mechanistic_model=et.rbq10, device="cpu", **sp), S,
        share_nn=share_nn, device="cpu")
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jm, params, state, tm


def as_jax(data):
    return JaxHybridData(x=data.x, forcing=dict(data.forcing), y=dict(data.y))


def ragged_table(seed=0):
    """A long table of 5 sites with 9, 4, 7, 9 and 1 rows, sites interleaved."""
    rng = np.random.default_rng(seed)
    site = np.repeat(np.array([11, 3, 7, 5, 2]), [9, 4, 7, 9, 1])
    order = rng.permutation(site.size)
    n = site.size
    cols = {
        "site": site[order],
        "sw_pot": rng.random(n).astype(np.float32),
        "dsw_pot": rng.random(n).astype(np.float32),
        "ta": (10 + 10 * rng.random(n)).astype(np.float32),
        "reco": (2 + rng.random(n)).astype(np.float32),
    }
    cols["reco"][::6] = np.nan
    return cols


def assert_data_equal(got, want):
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    assert set(got.forcing) == set(want.forcing) and set(got.y) == set(want.y)
    for k in want.forcing:
        np.testing.assert_array_equal(got.forcing[k], np.asarray(want.forcing[k]))
    for k in want.y:
        np.testing.assert_array_equal(got.y[k], np.asarray(want.y[k]))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(nan_frac=0.2), dict(site_idx=False, seed=5)], ids=str)
def test_gen_multisite_arrays_equals_jax_bit_for_bit(kw):
    got, want = et.gen_multisite_arrays(37, 6, **kw), jax_multisite_arrays(37, 6, **kw)
    assert_data_equal(got, want)
    assert ("_site_idx" in got.forcing) == kw.get("site_idx", True)
    assert got.x.dtype == np.float32 and got.y["reco"].dtype == np.float32


@pytest.mark.parametrize("kind", ["dict", "dataframe"])
def test_prepare_multisite_data_on_a_ragged_table(kind):
    import pandas as pd

    cols = ragged_table()
    table = cols if kind == "dict" else pd.DataFrame(cols)
    jm, _, _, tm = pair(5)
    got = et.prepare_multisite_data(tm.base, table, "site")
    assert_data_equal(got, jax_prepare_multisite(jm.base, table, "site"))
    assert got.x.shape == (5, 9, 2) and got.y["reco"].shape == (5, 9)
    # the shortest site: one real row, then NaN targets and zero predictors
    last = [s for s in dict.fromkeys(cols["site"].tolist())].index(2)
    assert np.isnan(got.y["reco"][last, 1:]).all() and not got.x[last, 1:].any()
    np.testing.assert_array_equal(got.forcing["_site_idx"][:, 0], np.arange(5, dtype=np.float32))


def test_prepare_multisite_data_refuses_other_containers():
    *_, tm = pair(2)
    with pytest.raises(NotImplementedError, match="queue A, item 1"):
        et.prepare_multisite_data(tm.base, object(), "site")


def test_per_site_networks_refuse_other_networks_naming_queue_a_item_4():
    from easyhybrid_tpu_torch.parallel.multisite import SiteNetworks

    *_, tm = pair(2)
    with pytest.raises(NotImplementedError, match=r"queue A, item 4\)"):
        SiteNetworks(object(), 2)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("share_nn", [True, False], ids=["shared nn", "per-site nn"])
@pytest.mark.parametrize("norm", [False, "static"])
@pytest.mark.parametrize("batch", ["all sites", "a gathered batch", "one id per site"])
def test_forward_matches_jax_apply(norm, batch, share_nn):
    S, N = 12, 5
    jm, params, state, tm = pair(S, norm=norm, share_nn=share_nn)
    data = et.gen_multisite_arrays(S, N, seed=1, site_idx=False)
    x, ta = data.x, data.forcing["ta"]
    forcing = {"ta": ta}
    if batch != "all sites":
        pick = np.array([7, 0, 11, 3, 3])
        x, forcing = x[pick], {"ta": ta[pick]}
        idx = np.broadcast_to(pick.astype(np.float32)[:, None], (len(pick), N)).copy()
        forcing["_site_idx"] = idx if batch == "a gathered batch" else idx[:, 0].copy()
    want, _ = jm.apply(params, state, (jnp.asarray(x), jax.tree.map(jnp.asarray, forcing)))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in forcing.items()})
    np.testing.assert_allclose(got["reco"].numpy(), np.asarray(want["reco"]), atol=1e-5, rtol=1e-5)
    for name in ("rb", "Q10"):
        np.testing.assert_allclose(got["parameters"][name].numpy(),
                                   np.asarray(want["parameters"][name]), atol=1e-5, rtol=1e-5)
    assert got["parameters"]["Q10"].shape == (x.shape[0], 1)


def test_model_mirrors_its_base_and_shares_its_network():
    *_, tm = pair(6)
    base = tm.base
    for name in ("targets", "forcing", "predictors", "param_table", "mechanistic_model",
                 "neural_param_names", "global_param_names", "fixed_param_names",
                 "scale_nn_outputs"):
        assert getattr(tm, name) == getattr(base, name) or getattr(tm, name) is getattr(base, name)
    assert tm.nn is base.nn and tm.device.type == "cpu" and tm.n_sites == 6 and tm.share_nn
    names = dict(tm.named_parameters())
    assert names["globals.Q10"].shape == (6, 1) and "base.globals.Q10" not in names
    assert set(names) == {f"nn.layers.{i}.{p}" for i in range(3) for p in ("weight", "bias")} | {
        "globals.Q10"}


@pytest.mark.parametrize("share_nn", [True, False], ids=["shared nn", "per-site nn"])
def test_trainable_batchnorm_normalises_each_site_as_jax_vmap_does(share_nn):
    """Training mode: per-site statistics over time, running statistics moved
    by their mean over sites; eval mode: the running statistics."""
    S, N = 7, 9
    jm, params, state, tm = pair(S, norm=True, share_nn=share_nn)
    data = et.gen_multisite_arrays(S, N, seed=8, site_idx=False)
    batch = (jnp.asarray(5 * data.x), {"ta": jnp.asarray(data.forcing["ta"])})
    x, forcing = torch.from_numpy(5 * data.x), {"ta": torch.from_numpy(data.forcing["ta"])}
    for training in (True, False):
        want, new_state = jm.apply(params, state, batch, training=training)
        tm.train(training)
        got = tm(x, forcing)
        np.testing.assert_allclose(got["reco"].detach().numpy(), np.asarray(want["reco"]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tm.nn.norm.mean.numpy(),
                                   np.asarray(new_state["nn"]["norm"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(tm.nn.norm.var.numpy(),
                                   np.asarray(new_state["nn"]["norm"]["var"]), atol=1e-6)
        state = new_state
    assert abs(float(tm.nn.norm.mean[0]) - 0.1 * float((5 * data.x[..., 0]).mean())) < 1e-5


def test_per_site_networks_hold_one_network_per_site():
    *_, tm = pair(3)
    ms = et.MultiSiteHybridModel(tm.base, 3, share_nn=False, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in ms.named_parameters()}
    assert shapes == {"nn.layers.0.weight": (3, 8, 2), "nn.layers.0.bias": (3, 8),
                      "nn.layers.1.weight": (3, 8, 8), "nn.layers.1.bias": (3, 8),
                      "nn.layers.2.weight": (3, 1, 8), "nn.layers.2.bias": (3, 1),
                      "globals.Q10": (3, 1)}
    assert not ms.share_nn and ms.nn is not tm.base.nn
    w = ms.nn.layers[0].weight
    assert not torch.equal(w[0], w[1]) and float(w.detach().abs().max()) <= (6.0 / 10) ** 0.5
    assert not et.supports_fused_multisite(ms, "adam", et.LoggingLoss())
    with pytest.raises(TypeError, match="SingleNNHybridModel"):
        et.MultiSiteHybridModel(tm, 3, device="cpu")


@pytest.mark.parametrize("share_nn", [True, False], ids=["shared nn", "per-site nn"])
def test_load_and_export_jax_params_round_trip(share_nn):
    jm, params, state, tm = pair(9, norm="static", share_nn=share_nn)
    got_p, got_s = et.export_jax_params(tm)
    assert got_p["globals"]["Q10"].shape == (9, 1)
    assert got_p["nn"]["layers"][0]["w"].shape == ((2, 8) if share_nn else (9, 2, 8))
    want_p, want_s = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    assert jax.tree.structure(got_p) == jax.tree.structure(want_p)
    for a, b in zip(jax.tree.leaves(got_p) + jax.tree.leaves(got_s),
                    jax.tree.leaves(want_p) + jax.tree.leaves(want_s)):
        np.testing.assert_array_equal(a, b)
    bad = {**want_p, "globals": {"Q10": want_p["globals"]["Q10"][:4]}}
    with pytest.raises(ValueError, match=r"globals/Q10.*\(4, 1\).*\(9, 1\)"):
        et.load_jax_params(tm, bad, want_s)


# --------------------------------------------------------------------------
# the site-major layout through the training modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 8])
def test_split_and_epoch_tensors_on_the_site_major_layout(batch):
    jm, _, _, tm = pair(21)
    data = et.gen_multisite_arrays(21, 6, seed=2, nan_frac=0.2)
    (ttr, tva), (jtr, jva) = et.split_data(data, tm), eh.split_data(as_jax(data), jm)
    assert_data_equal(ttr, jtr)
    assert_data_equal(tva, jva)
    assert ttr.n_samples == 17 and tva.n_samples == 4  # sites are the samples
    got, want = et.build_epoch_tensors(ttr, batch), jax_epoch_tensors(jtr, batch)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.weight, want.weight)  # one weight per site
    assert got.weight.shape == ((1, 17) if batch is None else (3, 8))
    for k in want.forcing:
        np.testing.assert_array_equal(got.forcing[k], want.forcing[k])
    np.testing.assert_array_equal(got.y["reco"], want.y["reco"])
    np.testing.assert_array_equal(got.mask["reco"], want.mask["reco"])
    assert got.mask["reco"].shape == got.y["reco"].shape == got.x.shape[:3]


def test_fit_input_norm_flattens_sites_and_time_as_jax_does():
    jm, _, state, tm = pair(6, norm="static")
    data = et.prepare_multisite_data(tm.base, ragged_table(), "site")  # padded zero rows
    jm5 = eh.MultiSiteHybridModel(jm.base, n_sites=5)
    want = jax_fit_input_norm(jm5, state, as_jax(data))["nn"]["norm"]
    et.fit_input_norm(tm, data)
    np.testing.assert_allclose(tm.nn.norm.mean.numpy(), np.asarray(want["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tm.nn.norm.var.numpy(), np.asarray(want["var"]), rtol=1e-6)
    # the padding rows of the short sites enter the statistics, in both packages
    assert abs(float(tm.nn.norm.mean[0]) - data.x[..., 0].mean()) < 1e-6


def test_evaluator_and_outputs_on_two_dimensional_targets():
    S, N = 14, 5
    jm, params, state, tm = pair(S)
    data = et.gen_multisite_arrays(S, N, seed=4, nan_frac=0.3)
    names = ("mse", "mae", "nseLoss")
    jll = eh.LoggingLoss(training_loss="mse", loss_types=names)
    tll = et.LoggingLoss(training_loss="mse", loss_types=names)
    jt = jax_epoch_tensors(as_jax(data), None)
    jbatch = ((jt.x[0], {k: v[0] for k, v in jt.forcing.items()}),
              ({k: v[0] for k, v in jt.y.items()}, {k: v[0] for k, v in jt.mask.items()}))
    (jm_tr, jout), _ = jax_dual_evaluator(jm, jll, jit=False)(params, state, jbatch, jbatch)
    tbatch = _full_batch(data, "cpu")
    assert tbatch[0][0].shape == (S, N, 2) and tbatch[1][1]["reco"].shape == (S, N)
    (tm_tr, tout), _ = tepoch.make_dual_evaluator(tm, tll)(tbatch, tbatch)
    for name in names:
        np.testing.assert_allclose(float(tm_tr[name]["reco"]), float(jm_tr[name]["reco"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(tm_tr[name]["sum"]), float(jm_tr[name]["sum"]), rtol=2e-5)
    np.testing.assert_allclose(tout["reco"].numpy(), np.asarray(jout["reco"]), atol=1e-5)


# --------------------------------------------------------------------------
# the torch epoch and train()
# --------------------------------------------------------------------------

def jax_perms(shuffle, key, epochs, nb, batch):
    if not shuffle or nb == 1:
        return None
    n = nb * batch if shuffle is True else nb
    keys = [key] if epochs == 1 else list(jax.random.split(key, epochs))
    return np.stack([np.asarray(jax_permutation(k, n)) for k in keys])


@pytest.mark.parametrize("S,batch,opt,shuffle,model_kw", [
    (40, None, ("adam", 0.01), False, {}),
    (40, None, ("sgd", 0.05), True, {}),       # one batch: nothing to shuffle
    (50, 16, ("adam", 0.01), False, {}),       # minibatched sites, ragged last batch
    (50, 16, ("adam", 0.01), True, {}),
    (50, 16, ("sgd", 0.05), "batches", {}),
    (50, 16, ("adam", 0.01), True, {"share_nn": False}),
    (40, None, ("sgd", 0.05), False, {"share_nn": False, "norm": "static"}),
    (50, 16, ("sgd", 0.05), False, {"norm": True}),   # per-site trainable BatchNorm
], ids=str)
def test_torch_epoch_matches_the_jax_epoch(S, batch, opt, shuffle, model_kw):
    epochs = 3
    jm, params, state, tm = pair(S, spread=False, **model_kw)
    data = et.gen_multisite_arrays(S, 6, seed=0, nan_frac=0.1)
    jt = jax.tree.map(jnp.asarray, jax_epoch_tensors(as_jax(data), batch or S))
    tt = tepoch.epoch_tensors_to(et.build_epoch_tensors(data, batch or S), "cpu")
    jll = eh.LoggingLoss(training_loss="mse", loss_types=("mse",))
    tll = et.LoggingLoss(training_loss="mse", loss_types=("mse",))
    joptim = optax.adam(opt[1]) if opt[0] == "adam" else optax.sgd(opt[1])
    key = jax.random.PRNGKey(7)
    jfn = jax_train_epoch(jm, jll, joptim, shuffle=shuffle, epochs_per_call=epochs)
    jp, _, js, jloss = jfn(jax.tree.map(jnp.array, params), joptim.init(params),
                           jax.tree.map(jnp.array, state), jt, key)
    toptim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(tm, tll, toptim, shuffle=shuffle, epochs_per_call=epochs)
    nb, sb = tt.weight.shape
    tstate, tloss = tfn(toptim.init(dict(tm.named_parameters())), tt,
                        perm=jax_perms(shuffle, key, epochs, nb, sb))
    got_p, got_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(js)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-4)
    assert int(tstate["count"]) == epochs * nb
    if batch is not None and opt[0] == "adam":
        # every site moved, also in the steps whose batch did not hold it
        moved = np.abs(got_p["globals"]["Q10"] - np.asarray(params["globals"]["Q10"]))
        assert (moved > 0).all()


def test_an_all_masked_site_batch_changes_nothing():
    S, batch = 32, 16
    *_, tm = pair(S, spread=False)
    data = et.gen_multisite_arrays(S, 5, seed=1)
    data.y["reco"][:batch] = np.nan
    tt = tepoch.epoch_tensors_to(et.build_epoch_tensors(data, batch), "cpu")
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    optim = resolve_optimizer(("adam", 0.01))
    first = tepoch.EpochTensors(
        x=tt.x[:1], forcing={k: v[:1] for k, v in tt.forcing.items()},
        y={k: v[:1] for k, v in tt.y.items()}, mask={k: v[:1] for k, v in tt.mask.items()},
        weight=tt.weight[:1], n_samples=tt.n_samples)
    fn = tepoch.make_train_epoch(tm, et.LoggingLoss(), optim, shuffle=False)
    state, loss = fn(optim.init(dict(tm.named_parameters())), first)
    assert int(state["count"]) == 0 and float(loss) == 0.0
    for k, v in tm.named_parameters():
        assert torch.equal(v, before[k])


def test_train_matches_jax_train_end_to_end():
    """The whole slice: the same table, the same initial parameters
    (``train_from``), full-site batches: histories, per-site parameters and
    validation predictions agree between the two packages."""
    import pandas as pd

    S, N = 10, 30
    frames = [pd.DataFrame({**{k: v for k, v in et.rbq10_columns(N, seed=20 + s, true_q10=1.5 + 0.1 * s).items()
                               if k in ("sw_pot", "dsw_pot", "ta", "reco")},
                            "site": np.full(N, s)}) for s in range(S)]
    table = pd.concat(frames, ignore_index=True)
    jm, params, state, tm = pair(S, norm="static", spread=False)
    jdata = jax_prepare_multisite(jm.base, table, "site")
    tdata = et.prepare_multisite_data(tm.base, {c: table[c].to_numpy() for c in table}, "site")
    assert_data_equal(tdata, jdata)
    kw = dict(nepochs=6, batchsize=S, eval_every=2, optimizer=("adam", 0.01), split_data_at=0.8,
              shuffle_each_epoch=False, show_progress=False)
    start = (jax.tree.map(np.array, params), jax.tree.map(np.array, state))  # JAX donates its own
    jr = eh.train(jm, jdata, train_from=(params, state), use_pallas=False, **kw)
    tr = et.train(tm, tdata, train_from=start, use_kernel=False, **kw)
    assert tr.epoch_path == "torch" and tr.params["globals.Q10"].shape == (S, 1)
    np.testing.assert_allclose(tr.params["globals.Q10"].numpy(),
                               np.asarray(jr.params["globals"]["Q10"]), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(tr.best_loss, jr.best_loss, rtol=5e-4)
    assert len(tr.val_history) == len(jr.val_history) == 4  # the start and three blocks
    np.testing.assert_allclose([h["mse"]["sum"] for h in tr.val_history],
                               [h["mse"]["sum"] for h in jr.val_history], rtol=5e-4)
    got, want = tr.val_pred_columns["reco_pred"], np.asarray(jr.val_pred["reco_pred"])
    assert got.shape == want.shape == (2 * N,)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-4)
    np.testing.assert_array_equal(tr.val_obs_columns["reco"], np.asarray(jr.val_obs["reco"]))


def test_predict_on_a_multisite_model_keeps_the_torch_engine():
    """Chunks slice sites; ``_site_idx`` carries each chunk's sites."""
    S, N = 11, 5
    jm, params, state, tm = pair(S)
    data = et.gen_multisite_arrays(S, N, seed=6)
    want = eh.predict(jm, params, state, as_jax(data), batch_size=4)
    fn = et.make_inference_fn(tm, batch_size=4)
    assert fn.engine == "torch" and "MultiSiteHybridModel" in fn.engine_reason
    got = fn(data)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == np.asarray(v).shape
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-5, rtol=1e-5)
    assert got["reco"].shape == (S, N) and got["Q10"].shape == (S, 1)


def test_train_with_per_site_networks_runs_the_torch_engine():
    *_, tm = pair(8, share_nn=False, norm="static")
    data = et.gen_multisite_arrays(8, 12, seed=3, nan_frac=0.1)
    res = et.train(tm, data, nepochs=3, batchsize=4, split_data_at=0.75, show_progress=False,
                   use_kernel=True)
    assert res.epoch_path == "torch" and "share_nn=False" in res.engine_reason
    assert res.params["nn.layers.0.weight"].shape == (8, 8, 2) and np.isfinite(res.best_loss)
