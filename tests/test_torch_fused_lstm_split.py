"""Kernel 4 at every LSTM the JAX kernel trains: its two forms.

The one-block form at 32-step windows and the cluster-split form's plain
version (``fused_lstm_reference`` on the split plan, what the wrapper
computes on CPU tensors) against the JAX package's fused LSTM epoch kernel
in interpret mode; the routing of ``fused_engine`` by size and window; the
envelope over hidden sizes up to 256, up to 64 features, windows up to 32
steps and up to 8 outputs, under every loss and optimizer rule; the split
form's geometry against shared memory; ``train(sequence_kwargs=...)`` on the
split form and on the torch engine; the CUDA source's argument struct and
shared-memory layout against their Python mirrors; and the JAX parameters'
round trip at hidden sizes 72 and 256.

Tolerances, float32, as tests/test_torch_fused_lstm.py holds the one-block
form against the JAX kernel: parameters atol 5e-5, rtol 5e-4 and the loss
rtol 1e-4 (a window is a chain of ``T`` cells forward and ``T`` backward).
The same against the port's torch engine (autograd, where the plain version
writes the backward by hand): at hidden size 72 Adam's first steps move an
element whose gradient is at rounding level by a visible share of the
learning rate, which the one-block tests' LSTM(4) does not show. Without an
input norm the raw predictors (hundreds) saturate the gates, so those cases
take a small step (see tests/test_torch_fused_lstm.py)."""

import ctypes
import dataclasses
import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.data.loaders import build_epoch_tensors as jax_epoch_tensors
from easyhybrid_tpu.data.prepare import HybridData as JaxHybridData
from easyhybrid_tpu.ops.fused_epoch import init_fused_opt_state as jax_init_opt
from easyhybrid_tpu.ops.fused_epoch import make_fused_epoch as jax_fused_epoch
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.data.loaders import build_epoch_tensors
from easyhybrid_tpu_torch.data.prepare import HybridData
from easyhybrid_tpu_torch.data.sequences import split_into_sequences
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_epoch_lstm as fl
from easyhybrid_tpu_torch.ops import fused_lstm_split as fs
from easyhybrid_tpu_torch.training import epoch as tepoch
from test_torch_fused_epoch import RULES
from test_torch_fused_lstm import jax_perms

CU_SOURCE = Path(fs.__file__).resolve().parent.parent / "csrc" / "fused_lstm_split.cu"


def _names(features):
    return ["sw_pot", "dsw_pot"] + [f"p{i}" for i in range(features - 2)]


def _spec(hidden, features=2, norm="static", **kw):
    spec = dict(
        predictors=_names(features), forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm=norm,
    )
    spec.update(kw)
    return spec


def _rows(n, features, seed=21, nan_frac=0.1):
    """RbQ10 rows with ``features`` predictors: the two of the example and,
    beyond them, standard normal columns the target does not depend on."""
    cols = et.rbq10_columns(n, seed=seed, nan_frac=nan_frac)
    rng = np.random.default_rng(seed)
    extra = [rng.normal(size=n).astype(np.float32) for _ in range(features - 2)]
    return HybridData(x=np.stack([cols["sw_pot"], cols["dsw_pot"], *extra], -1),
                      forcing={"ta": cols["ta"]}, y={"reco": cols["reco"]})


def setup(hidden, features=2, norm="static", n=80, batch=16, steps=32, out_steps=1,
          nan_frac=0.1):
    """The same model in both packages from the JAX initial parameters, and
    the same windows (NaN targets kept) as epoch tensors of both."""
    spec = _spec(hidden, features, norm)
    jm = eh.construct_hybrid_model(**spec)
    tm = et.construct_hybrid_model(**spec, device="cpu")
    data = split_into_sequences(_rows(n, features, nan_frac=nan_frac), input_window=steps,
                                output_window=out_steps)
    jdata = JaxHybridData(x=data.x, forcing=data.forcing, y=data.y)
    params, state = jm.init(jax.random.PRNGKey(0))
    if norm == "static":
        state = jax_fit_input_norm(jm, state, jdata)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    et.load_jax_params(tm, np_tree(params), np_tree(state))
    jt = jax.device_put(jax_epoch_tensors(jdata, batch))
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, batch), "cpu")
    return jm, params, state, jt, tm, tt


def _loss_pair(loss):
    if loss == "pinball":
        return eh.pinball(0.9), et.pinball(0.9)
    return loss, loss


# (form, hidden, features, loss, optimizer, shuffle, epochs, norm, setup kwargs): every
# case is a 32-step window with NaN targets, the one-block form at hidden size 64 (the first
# kernel's rule took 16 steps), the split form past it and where one block cannot hold 64 features
CASES = [
    ("one_block", 64, 2, "mse", ("adam", 0.01), True, 1, "static", {}),
    ("one_block", 64, 16, "nseLoss", ("rmsprop", 0.001), "batches", 1, False, {}),
    ("split", 72, 2, "nseLoss", ("adam", 0.01), True, 2, "static", {}),
    ("split", 72, 16, "mae", ("sgd", 0.05), False, 1, "static", {"out_steps": 2}),
    ("split", 128, 2, "pinball", ("rmsprop", 0.001), "batches", 1, False, {"nan_frac": 0.3}),
    ("split", 128, 16, "mse", ("sgd", 0.05), True, 1, False, {}),
    ("split", 64, 64, "mse", ("adam", 0.01), "batches", 1, "static", {"nan_frac": 0.3}),
]


@pytest.mark.parametrize("form,hidden,features,loss,opt,shuffle,epochs,norm,kw", CASES, ids=str)
def test_both_forms_match_the_jax_fused_lstm_epoch_at_32_steps(form, hidden, features, loss, opt,
                                                               shuffle, epochs, norm, kw):
    jm, params, state, jt, tm, tt = setup(hidden, features, norm, **kw)
    assert fl.lstm_form(tm, *fl.window_of(tt)) == form
    key = jax.random.PRNGKey(5)
    jloss_spec, tloss_spec = _loss_pair(loss)
    jll = eh.LoggingLoss(training_loss=jloss_spec, loss_types=("mse",))
    jfn = jax_fused_epoch(jm, state, opt, jll, shuffle=shuffle, epochs_per_call=epochs)
    jp, jos, js, jloss = jfn(jax.tree.map(jnp.array, params), jax_init_opt(params, opt), state,
                             jt, key)

    engine = fe.fused_engine(tm, tt)
    assert engine.epoch_path == {"one_block": "cuda_fused_lstm",
                                 "split": "cuda_fused_lstm_split"}[form]
    ll = et.LoggingLoss(training_loss=tloss_spec, loss_types=("mse",))
    assert engine.unsupported_reason(tm, opt, ll, tt, shuffle=shuffle) is None
    fn = engine.make_epoch(tm, opt, ll, shuffle=shuffle, epochs_per_call=epochs)
    assert isinstance(fn.plan, fs.FusedLSTMSplitPlan) == (form == "split")
    nb, batch = tt.weight.shape
    _, os_, tloss = fn(tm, fe.init_fused_opt_state(fn.plan.pack(tm), opt), tt,
                       perms=jax_perms(shuffle, key, epochs, nb, batch))
    got_p, _ = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert int(os_["t"][0]) == int(jos["t"][0])


# the split form's plain version under the two-pass losses and the other rules, against the
# torch engine (the JAX kernel's agree with the torch engine: tests/test_torch_fused_lstm.py)
TORCH_CASES = [
    ("rmse", ("adam", 0.01), True, "static", 2),
    ("pearsonLoss", ("adam", 0.01), "batches", "static", 2),
    ("kgeLoss", ("rmsprop", 0.01), True, False, 3),
    ("pbkgeLoss", ("sgd", 0.05), False, "static", 2),
    *[("mse", opt, True, "static", 1) for opt in RULES],
]


@pytest.mark.parametrize("loss,opt,shuffle,norm,out_steps", TORCH_CASES, ids=str)
def test_the_split_plain_version_matches_the_torch_epoch(loss, opt, shuffle, norm, out_steps):
    tm = et.construct_hybrid_model(**_spec(72, 3, norm), device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    data = split_into_sequences(_rows(90, 3, nan_frac=0.2), input_window=6,
                                output_window=out_steps)
    et.fit_input_norm(tm, data)
    tt = tepoch.epoch_tensors_to(build_epoch_tensors(data, 20), "cpu")
    twin = et.construct_hybrid_model(**_spec(72, 3, norm), device="cpu")
    twin.load_state_dict(tm.state_dict())
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    perms = tepoch.perms_for_epochs(shuffle, tt, 2, generator=torch.Generator().manual_seed(1))
    fn = et.make_fused_lstm_split_epoch(tm, opt, ll, shuffle=shuffle, epochs_per_call=2)
    p0 = fn.plan.pack(tm)
    packed, os_, loss_f = fn(p0, fe.init_fused_opt_state(p0, opt), tt, perms=perms)
    from easyhybrid_tpu_torch.training.optimizers import resolve_optimizer

    optim = resolve_optimizer(opt)
    tfn = tepoch.make_train_epoch(twin, ll, optim, shuffle=shuffle, epochs_per_call=2)
    state, loss_t = tfn(optim.init(dict(twin.named_parameters())), tt, perm=perms)
    np.testing.assert_allclose(packed.params.numpy(), fn.plan.pack(twin).params.numpy(),
                               atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(float(loss_f), float(loss_t), rtol=1e-4, atol=1e-6)
    assert int(os_["t"][0]) == int(state["count"])


# --------------------------------------------------------------------------
# routing and the envelope
# --------------------------------------------------------------------------

def _ll(loss="mse"):
    return et.LoggingLoss(training_loss=loss, loss_types=("mse",))


def _outputs_model(hidden, features, outputs):
    """An LSTM hybrid with ``outputs`` network outputs: a mechanistic model
    of that many neural parameters, traced into the kernel form."""
    names = [f"n{i}" for i in range(outputs)]

    def mech(*, ta, **neural):
        return {"reco": sum(neural[k] for k in names) * torch.exp(0.01 * ta)}

    mech.__signature__ = inspect.Signature(
        [inspect.Parameter(k, inspect.Parameter.KEYWORD_ONLY) for k in ["ta", *names]])
    return et.construct_hybrid_model(
        predictors=_names(max(features, 2))[:features], forcing=["ta"], targets=["reco"],
        mechanistic_model=mech, parameters={k: (0.5, 0.0, 2.0) for k in names},
        neural_param_names=names, global_param_names=[], hidden_layers={"lstm": hidden},
        scale_nn_outputs=True, input_batchnorm="static", device="cpu")


@pytest.mark.parametrize("hidden", [1, 17, 64, 65, 72, 128, 200, 256])
def test_every_lstm_to_256_and_32_steps_goes_to_one_form_that_fits(hidden):
    """Every (hidden size <= 256, features <= 64, outputs <= 8, window <= 32)
    is admitted by exactly one form, the one ``lstm_form`` names, and that
    form's geometry fits shared memory at batches 1, 128 and 1,000."""
    for features in (1, 2, 16, 64):
        for outputs in (1, 7):
            tm = _outputs_model(hidden, features, outputs)
            for steps in (1, 10, 16, 32):
                for out_steps in sorted({1, steps}):
                    form = fl.lstm_form(tm, steps, out_steps)
                    tensors = SimpleNamespace(
                        x=torch.zeros((1, 1, steps, features)),
                        y={"reco": torch.zeros((1, 1, out_steps))})
                    one = fl.fused_epoch_lstm_unsupported_reason(tm, "adam", _ll(), tensors)
                    split = fs.fused_lstm_split_unsupported_reason(tm, "adam", _ll(), tensors)
                    assert (one is None, split is None) == (form == "one_block", form == "split")
                    if form == "one_block":
                        assert hidden <= 64
                        plan = fl.plan_fused_lstm(tm, "adam", _ll("kgeLoss"))
                        for batch in (1, 128, 1000):
                            g = plan.geometry(batch, steps, out_steps)
                            assert plan.sizes.smem_floats(steps, out_steps, g.windows,
                                                          g.lanes) * 4 <= fe.MAX_SMEM_BYTES
                    else:
                        plan = fs.plan_fused_lstm_split(tm, "adam", _ll("kgeLoss"))
                        for batch in (1, 128, 1000):
                            g = plan.geometry(batch, steps, out_steps)
                            assert g.tiles * g.windows >= batch > (g.tiles - 1) * g.windows
                            assert g.windows % 4 == 0 and g.units * g.cluster >= hidden
                            assert fs.split_smem_floats(
                                features, hidden, outputs, 0, 0, cluster=g.cluster,
                                windows=g.windows) * 4 <= fe.MAX_SMEM_BYTES


@pytest.mark.parametrize("loss", ["mse", "mae", "nseLoss", "rmse", "pearsonLoss", "kgeLoss",
                                  "pbkgeLoss", "pinball"])
def test_the_split_form_takes_every_loss_and_rule(loss):
    tm = et.construct_hybrid_model(**_spec(256, 64), device="cpu")
    tensors = SimpleNamespace(x=torch.zeros((1, 1, 32, 64)), y={"reco": torch.zeros((1, 1, 32))})
    spec = et.pinball(0.9) if loss == "pinball" else loss
    for opt in [("adam", 0.01), ("sgd", 0.05), *RULES]:
        assert fs.fused_lstm_split_unsupported_reason(tm, opt, _ll(spec), tensors) is None
    plan = fs.plan_fused_lstm_split(tm, "adam", _ll(spec))
    assert plan.loss == (fe.ELEMENTWISE if loss == "pinball" else loss)


def test_fused_engine_routes_by_size_and_window():
    def model(hidden, features=2):
        return et.construct_hybrid_model(**_spec(hidden, features), device="cpu")

    def windows(steps):
        return SimpleNamespace(x=torch.zeros((1, 1, steps, 2)), y={"reco": torch.zeros((1, 1, 1))})

    assert fe.fused_engine(model(16)).epoch_path == "cuda_fused_lstm"
    assert fe.fused_engine(model(16), windows(32)).epoch_path == "cuda_fused_lstm"
    assert fe.fused_engine(model(64), windows(32)).epoch_path == "cuda_fused_lstm"
    assert fe.fused_engine(model(64), windows(59)).epoch_path == "cuda_fused_lstm_split"
    assert fe.fused_engine(model(65)).epoch_path == "cuda_fused_lstm_split"
    assert fe.fused_engine(model(256)).epoch_path == "cuda_fused_lstm_split"
    assert fe.fused_engine(model(64, 64)).epoch_path == "cuda_fused_lstm_split"
    engine = fe.fused_engine(model(72))
    assert engine.envelope == "supports_fused_lstm_split"
    # the split form refuses what the one-block form takes, and past its caps
    assert "one-block form" in fs.fused_lstm_split_unsupported_reason(model(16), "adam", _ll())
    assert "cap of 32" in fs.fused_lstm_split_unsupported_reason(model(72), "adam", _ll(),
                                                                 windows(33))
    assert "hidden size 256" in fs.fused_lstm_split_unsupported_reason(model(257), "adam", _ll())
    assert "65 features" in fs.fused_lstm_split_unsupported_reason(model(72, 65), "adam", _ll())
    assert "shuffle" in engine.unsupported_reason(model(72), "adam", _ll(), shuffle="nope")


def test_the_geometry_of_the_main_shapes():
    """The main path's LSTM(256) over 128 windows: a cluster of 16 blocks of
    512 threads, 16 units each, 7 tiles of 20 windows; 64 features leave 8 a
    tile."""
    plan = fs.plan_fused_lstm_split(et.construct_hybrid_model(**_spec(256), device="cpu"),
                                    ("adam", 0.01), _ll("nseLoss"))
    assert plan.geometry(128, 32, 1) == fs.SplitGeometry(512, 16, 16, 20, 7)
    assert plan.geometry(1) == fs.SplitGeometry(512, 16, 16, 4, 1)
    assert plan.geometry(1000) == fs.SplitGeometry(512, 16, 16, 20, 50)
    wide = fs.plan_fused_lstm_split(et.construct_hybrid_model(**_spec(256, 64), device="cpu"),
                                    ("adam", 0.01), _ll())
    assert wide.geometry(128) == fs.SplitGeometry(512, 16, 16, 8, 16)
    small = fs.plan_fused_lstm_split(et.construct_hybrid_model(**_spec(72), device="cpu"),
                                     ("adam", 0.01), _ll())
    assert small.geometry(128) == fs.SplitGeometry(512, 16, 5, 64, 2)
    assert dataclasses.replace(small, cluster=4).geometry(33) == fs.SplitGeometry(512, 4, 18, 36, 1)
    # the workspace: h, c and the gates of every window and step, and each block's tile
    g = plan.geometry(128, 32, 1)
    assert fs.work_floats(plan, 128, 32, 1, g) == 128 * 32 * 6 * 256 + 16 * (20 * 3 + 128)


def test_train_on_windows_runs_the_split_form_and_the_torch_engine_alike():
    """``use_kernel=True`` on a CPU model runs the split form's plain version
    behind the gate; it follows the torch engine (same seed, same
    permutations)."""
    cols = et.rbq10_columns(260, seed=11)
    results = {}
    for use_kernel in (True, False):
        tm = et.construct_hybrid_model(**_spec(72), generator=torch.Generator().manual_seed(0),
                                       device="cpu")
        results[use_kernel] = et.train(
            tm, cols, nepochs=4, eval_every=2, batchsize=32, optimizer=("adam", 0.01),
            training_loss="nseLoss", loss_types=["nseLoss", "mse"], show_progress=False,
            sequence_kwargs=dict(input_window=6, output_window=2, lead_time=0),
            use_kernel=use_kernel)
    fused, plain = results[True], results[False]
    assert fused.epoch_path == "cuda_fused_lstm_split"
    assert "exactness gate passed" in fused.engine_reason
    assert plain.epoch_path == "torch"
    for k, v in plain.params.items():
        np.testing.assert_allclose(fused.params[k].numpy(), v.numpy(), atol=5e-5, rtol=5e-4)
    np.testing.assert_allclose(fused.best_loss, plain.best_loss, rtol=1e-4)
    assert np.isfinite(fused.val_pred_columns["reco_pred"]).all()


def test_a_population_of_split_models_runs_the_torch_engine():
    tm = et.construct_hybrid_model(**_spec(72), device="cpu")
    pop = et.population_train(tm, et.rbq10_columns(200, seed=2),
                              hyper={"learning_rate": [0.01, 0.02]}, optimizer="adam", nepochs=1,
                              batchsize=32, use_kernel=True,
                              sequence_kwargs=dict(input_window=5, output_window=1))
    assert pop.epoch_path == "population_vmap"
    assert "cuda_fused_lstm_split" in pop.engine_reason and "item 5" in pop.engine_reason


def test_cuda_tensors_never_take_the_plain_version():
    """On a CUDA tensor the wrapper launches the kernel or raises; here, with
    no card, a meta tensor stands for 'not the CPU'."""
    *_, tm, tt = setup(72, n=60, steps=5)
    fn = et.make_fused_lstm_split_epoch(tm, "adam", _ll())
    p0 = fn.plan.pack(tm)
    meta = tepoch.EpochTensors(
        x=tt.x.to("meta"), forcing={k: v.to("meta") for k, v in tt.forcing.items()},
        y={k: v.to("meta") for k, v in tt.y.items()},
        mask={k: v.to("meta") for k, v in tt.mask.items()}, weight=tt.weight.to("meta"),
        n_samples=tt.n_samples)
    with pytest.raises(ValueError):
        fn(p0, fe.init_fused_opt_state(p0), meta, perms=None)
    assert fs.launch_fused_lstm_split.launches == 0


# --------------------------------------------------------------------------
# the CUDA source and its mirrors
# --------------------------------------------------------------------------

def test_kernel_source_and_ctypes_mirror_agree():
    src = CU_SOURCE.read_text()
    assert '#include "eh_device.cuh"' in src and "--use_fast_math" in src  # only to disown it
    defines = dict(re.findall(r"#define (EHS_\w+) (\d+)", src))
    assert int(defines["EHS_MAX_OUT"]) == fl.MAX_LSTM_OUT
    assert int(defines["EHS_MAX_CLUSTER"]) == fs.MAX_CLUSTER
    assert int(defines["EHS_MAX_HIDDEN"]) == fl.MAX_HIDDEN
    assert int(defines["EHS_MAX_STEPS"]) == fs.MAX_STEPS
    assert int(defines["EHS_MAX_THREADS"]) == fs.THREADS
    body = re.search(r"struct EhLstmSplitArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]+\])?;", re.sub(r"//[^\n]*", "", body))
    assert fields == [name for name, _ in fs._SplitArgs._fields_]
    # the fields up to the halt word are the one-block form's
    halt = fields.index("halt") + 1
    assert fields[:halt] == [name for name, _ in fl._Args._fields_][:halt]
    assert fs._SplitArgs.work_floats.offset % 8 == 0 and ctypes.sizeof(fs._SplitArgs) % 8 == 0
    assert "atomicAdd" not in src and "cublas" not in src.lower()
    assert "eh_launch_cluster" in src and "cudaLaunchKernelEx" not in src


def _c_layout(body, names):
    """Evaluate the assignments of a C function body in order: ``s.x = e;``
    and ``const int x = e;``, a ternary as Python's."""
    env = dict(names)
    for stmt in re.sub(r"//[^\n]*", "", body).split(";"):
        stmt = " ".join(stmt.split())
        m = re.match(r"(?:const int )?([\w.]+) = (.*)$", stmt)
        if not m or stmt.startswith("EhsSmem"):
            continue
        for part in (m.group(0)[len("const int "):].split(", ") if stmt.startswith("const int ")
                     and "," in stmt and "?" not in stmt else [m.group(1) + " = " + m.group(2)]):
            name, expr = part.split(" = ", 1)
            expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2 if \1 else \3)", expr)
            env[name.replace("s.", "s_")] = eval(expr.replace("s.", "s_"),  # noqa: S307
                                                 {"__builtins__": {}}, env)
    return env


def test_smem_and_workspace_formulas_match_the_source():
    """``split_smem_floats`` and ``work_floats`` against ``ehs_smem`` and
    ``ehs_work_floats``, their statements parsed from the source and
    evaluated on the same numbers."""
    src = CU_SOURCE.read_text()
    smem = re.search(r"inline EhsSmem ehs_smem\(.*?\{(.*?)\n\}", src, re.S).group(1)
    work = re.search(r"inline int64_t ehs_block_work\(.*?\{(.*?)\n\}", src, re.S).group(1)
    rng = np.random.default_rng(0)
    for _ in range(60):
        f, h, p, g, k, t = (int(rng.integers(lo, hi)) for lo, hi in
                            ((1, 65), (1, 257), (1, 9), (0, 9), (0, 5), (1, 5)))
        cluster = int(rng.choice([1, 2, 4, 8, 16]))
        windows = 4 * int(rng.integers(1, 17))
        batch, steps = int(rng.integers(1, 1000)), int(rng.integers(1, 33))
        out_steps = int(rng.integers(1, steps + 1))
        a = SimpleNamespace(n_features=f, hidden=h, n_out=p, n_globals=g, n_fixed=k,
                            units=-(-h // cluster), windows=windows, cluster=cluster,
                            n_out_steps=out_steps, n_targets=t, batch=batch, n_steps=steps)
        names = dict(a=a, ehs_up4=lambda n: (n + 3) & ~3, EH_MAX_TARGETS=fe.MAX_TARGETS,
                     EH_MAX_LEAVES=fe.MAX_LEAVES, int64_t=int)
        env = _c_layout(smem, names)
        assert env["s_total"] == fs.split_smem_floats(f, h, p, g, k, cluster=cluster,
                                                      windows=windows)
        ret = " ".join(re.search(r"return (.*?);", work, re.S).group(1).split())
        block = eval(ret.replace("(int64_t)", ""),
                     {"__builtins__": {}}, dict(env, pairs=windows * out_steps))  # noqa: S307
        plan = SimpleNamespace(out_dim=p, global_names=("g",) * g, target_names=("y",) * t,
                               hidden=h)
        geo = fs.SplitGeometry(256, cluster, a.units, windows, 1)
        assert fs.work_floats(plan, batch, steps, out_steps, geo) == (
            batch * steps * 6 * h + cluster * block)


@pytest.mark.parametrize("hidden", [72, 256])
def test_jax_parameters_round_trip_at_any_hidden_size(hidden):
    """``load_jax_params`` / ``export_jax_params`` carry ``wi``, ``wh``,
    ``b`` and the head at hidden sizes past 64, and the loaded model's
    forward is the JAX model's."""
    spec = _spec(hidden, 3)
    jm = eh.construct_hybrid_model(**spec)
    tm = et.construct_hybrid_model(**spec, device="cpu")
    params, state = jm.init(jax.random.PRNGKey(4))
    data = split_into_sequences(_rows(60, 3), input_window=8, output_window=1)
    state = jax_fit_input_norm(jm, state, JaxHybridData(x=data.x, forcing=data.forcing,
                                                        y=data.y))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    et.load_jax_params(tm, np_tree(params), np_tree(state))
    assert tuple(tm.nn.wh.shape) == (4 * hidden, hidden)
    back_p, back_s = et.export_jax_params(tm)
    for a, b in zip(jax.tree.leaves(back_p), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(back_s), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, np.asarray(b))
    want, _ = jm.apply(params, state, (jnp.asarray(data.x), {k: jnp.asarray(v) for k, v in
                                                             data.forcing.items()}),
                       training=False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.as_tensor(data.x), {k: torch.as_tensor(v) for k, v in data.forcing.items()})
    np.testing.assert_allclose(got["reco"].numpy(), np.asarray(want["reco"]), atol=1e-5,
                               rtol=1e-4)
