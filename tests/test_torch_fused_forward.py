"""The port's fused forward: its plain PyTorch version against the JAX
Pallas kernel (interpret mode on CPU, as tests/test_fused.py runs it) and
against the JAX model's apply; the envelope and its reasons; the kernel-form
probe check; and the build's refusal without nvcc. Tolerance rtol=1e-5,
atol=1e-6 (float32). The CUDA kernel itself is tested on a GPU by
tests/test_torch_cuda.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu.ops.fused_forward import make_fused_forward as jax_make_fused_forward
from easyhybrid_tpu.training.train import fit_input_norm as jax_fit_input_norm
from easyhybrid_tpu_torch.ops import _build
from easyhybrid_tpu_torch.ops import fused_forward as ff

RTOL, ATOL = 1e-5, 1e-6
PARAMS = {"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)}
CU_SOURCE = Path(ff.__file__).resolve().parent.parent / "csrc" / "fused_forward.cu"


@et.kernel_form("rbq10")
def rbq10(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def rbq10_untagged(*, ta, rb, Q10, tref=15.0):
    return {"reco": rb * Q10 ** (0.1 * (ta - tref))}


def rbq10_branching(*, ta, rb, Q10, tref=15.0):
    if ta > tref:  # control flow on a value: the tracer refuses it
        return {"reco": rb * Q10}
    return {"reco": rb}


def _spec(**kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=rbq10, parameters=PARAMS,
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=[16, 16], activation="swish",
        scale_nn_outputs=True, input_batchnorm="static",
    )
    spec.update(kw)
    return spec


def _pair(spec, df, seed=0):
    jm = eh.construct_hybrid_model(**spec)
    data = eh.prepare_data(jm, df)
    params, state = jm.init(jax.random.PRNGKey(seed))
    state = jax_fit_input_norm(jm, state, data)
    tm = et.construct_hybrid_model(**spec)
    et.load_jax_params(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jm, params, state, tm, data


def _inputs(data):
    return torch.tensor(data.x), {k: torch.tensor(v) for k, v in data.forcing.items()}


def test_reference_matches_jax_pallas_kernel():
    """The setup of tests/test_fused.py::test_fused_forward_matches_apply."""
    spec = _spec(hidden_layers=[8])
    jm, params, state, tm, _ = _pair(spec, eh.gen_rbq10_data(512, seed=0))
    data = eh.prepare_data(jm, eh.gen_rbq10_data(256, seed=5))
    jfwd = jax_make_fused_forward(jm, params, state, batch_size=128, interpret=True)
    want = jfwd(jnp.asarray(data.x), {k: jnp.asarray(v) for k, v in data.forcing.items()})
    fn = et.make_fused_forward(tm, batch_size=128)
    got = fn(*_inputs(data))
    np.testing.assert_allclose(got["reco"].numpy(), np.asarray(want["reco"]),
                               rtol=RTOL, atol=ATOL)
    # the port's kernel also writes the scaled neural parameter
    ref, _ = jm.apply(params, state, (data.x, data.forcing))
    np.testing.assert_allclose(got["rb"].numpy(), np.asarray(ref["parameters"]["rb"]),
                               rtol=RTOL, atol=ATOL)
    assert list(got) == ["reco", "rb"]


@pytest.mark.parametrize("norm", [False, "static"])
@pytest.mark.parametrize("act", sorted(et.ACTIVATIONS))
def test_reference_matches_jax_apply(act, norm):
    spec = _spec(hidden_layers=[12, 5], activation=act, input_batchnorm=norm)
    df = eh.gen_rbq10_data(300, seed=11)
    df.loc[[3, 17], "dsw_pot"] = np.nan  # NaN predictor rows propagate
    jm, params, state, tm, _ = _pair(spec, df)
    data = eh.prepare_data(jm, df, drop_missing_rows=False)
    want, _ = jm.apply(params, state, (data.x, data.forcing))
    got = et.make_fused_forward(tm, batch_size=64)(*_inputs(data))
    np.testing.assert_allclose(got["reco"].numpy(), np.asarray(want["reco"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["rb"].numpy(), np.asarray(want["parameters"]["rb"]),
                               rtol=RTOL, atol=ATOL)
    assert np.isnan(got["reco"].numpy()[[3, 17]]).all()


def test_form_arguments_map_to_any_source():
    """rb as a global, Q10 from the network, tref a fixed parameter."""
    spec = _spec(parameters={**PARAMS, "tref": (12.0, 0.0, 30.0)},
                 neural_param_names=["Q10"], global_param_names=["rb"])
    jm, params, state, tm, data = _pair(spec, eh.gen_rbq10_data(200, seed=2))
    plan = ff.plan_fused_forward(tm)
    assert [s for s, _, _ in plan.arg_sources] == [
        ff._SRC_SCALAR, ff._SRC_NEURAL, ff._SRC_FORCING, ff._SRC_SCALAR]
    want, _ = jm.apply(params, state, (data.x, data.forcing))
    got = et.make_fused_forward(tm)(*_inputs(data))
    np.testing.assert_allclose(got["reco"].numpy(), np.asarray(want["reco"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["Q10"].numpy(), np.asarray(want["parameters"]["Q10"]),
                               rtol=RTOL, atol=ATOL)


def test_tref_comes_from_the_keyword_default():
    @et.kernel_form("rbq10")
    def rbq10_t10(*, ta, rb, Q10, tref=10.0):
        return {"reco": rb * Q10 ** (0.1 * (ta - tref))}

    tm = et.construct_hybrid_model(**_spec(mechanistic_model=rbq10_t10))
    plan = ff.plan_fused_forward(tm)
    assert plan.arg_sources[3] == (ff._SRC_CONST, 0, 10.0)


def test_cpu_call_runs_the_plain_version_without_launching():
    tm = et.construct_hybrid_model(**_spec(), generator=torch.Generator().manual_seed(0))
    data = et.prepare_data(tm, et.rbq10_columns(50, seed=1))
    fn = et.make_fused_forward(tm, batch_size=16)
    before = ff.launch_fused_forward.launches
    x, forcing = _inputs(data)
    got = fn(x, forcing)
    assert ff.launch_fused_forward.launches == before
    ref = fn.reference(x, forcing)
    for k in ref:
        assert torch.equal(got[k], ref[k])
    with pytest.raises(ValueError, match="float32"):
        fn(x.double(), forcing)
    with pytest.raises(KeyError, match="ta"):
        fn(x, {})
    with pytest.raises(ValueError, match="batch_size"):
        et.make_fused_forward(tm, batch_size=0)


def _no_activation(x):
    return x


@pytest.mark.parametrize("overrides,reason", [
    (dict(input_batchnorm=True), "trainable input BatchNorm"),
    (dict(mechanistic_model=rbq10_branching), "no kernel form: control flow on a traced value"),
    (dict(activation=_no_activation), "not one of the kernel's"),
    (dict(hidden_layers=[65]), "exceed the kernel's cap of 64"),
    (dict(hidden_layers=[4] * 8), "layers exceed"),
    (dict(compute_dtype=torch.float16), "compute_dtype=torch.float16 (the kernels take bfloat16 only"),
    (dict(predictors=[], neural_param_names=[], global_param_names=["rb", "Q10"]),
     "no neural network"),
])
def test_envelope_reasons(overrides, reason):
    tm = et.construct_hybrid_model(**_spec(**overrides))
    assert not et.supports_fused_forward(tm)
    assert reason in ff.fused_forward_unsupported_reason(tm)
    with pytest.raises(ValueError, match="not supported"):
        et.make_fused_forward(tm)


def test_envelope_accepts_the_quick_start_model():
    tm = et.construct_hybrid_model(**_spec())
    assert et.supports_fused_forward(tm)
    assert et.supports_fused_forward(et.construct_hybrid_model(
        **_spec(mechanistic_model=rbq10_untagged)))  # traced
    assert ff.fused_forward_unsupported_reason(tm) is None
    assert et.supports_fused_forward(et.construct_hybrid_model(**_spec(hidden_layers=[64, 64])))
    assert not et.supports_fused_forward(tm.double())


def test_unresolved_form_argument_is_a_reason():
    @et.kernel_form("rbq10")
    def rbq10_no_tref(*, ta, rb, Q10):
        return {"reco": rb * Q10 ** (0.1 * (ta - 15.0))}

    tm = et.construct_hybrid_model(**_spec(mechanistic_model=rbq10_no_tref))
    assert "'tref'" in ff.fused_forward_unsupported_reason(tm)


def test_probe_check_rejects_a_wrongly_tagged_function():
    @et.kernel_form("rbq10")
    def q5(*, ta, rb, Q10, tref=15.0):
        return {"reco": rb * Q10 ** ((ta - tref) / 5.0)}

    @et.kernel_form("rbq10")
    def two_outputs(*, ta, rb, Q10, tref=15.0):
        return {"reco": rb * Q10 ** (0.1 * (ta - tref)), "rb2": rb * 2}

    tm = et.construct_hybrid_model(**_spec(mechanistic_model=q5))
    assert et.supports_fused_forward(tm)  # the envelope cannot see the body
    with pytest.raises(ValueError, match="disagrees with the form"):
        et.make_fused_forward(tm)
    tm = et.construct_hybrid_model(**_spec(mechanistic_model=two_outputs))
    with pytest.raises(ValueError, match="returns 2 outputs"):
        et.make_fused_forward(tm)
    with pytest.raises(ValueError, match="unknown kernel form"):
        et.kernel_form("arrhenius")


def test_kernel_source_and_ctypes_mirror_agree():
    """The caps and the argument struct of the CUDA source match the
    wrapper's constants and its ctypes mirror, field by field."""
    src = CU_SOURCE.read_text()
    header = CU_SOURCE.with_name("eh_device.cuh").read_text()
    assert '#include "eh_device.cuh"' in src  # the shared formulas, caps and enums
    defines = dict(re.findall(r"#define (EH_MAX_\w+) (\d+)", src + header))
    for name in ("WIDTH", "LAYERS", "FORCING", "OUTPUTS", "ARGS", "SCALARS"):
        assert int(defines[f"EH_MAX_{name}"]) == getattr(ff, f"MAX_{name}")
    body = re.search(r"struct EhFusedForwardArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]+\])?;", body)
    assert fields == [name for name, _ in ff._Args._fields_]
    for name, act_id in ff._ACT_IDS.items():
        assert name in et.ACTIVATIONS and 0 <= act_id <= 9
    assert sorted(ff._ACT_IDS) == sorted(et.ACTIVATIONS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: a clear error, and no library is left behind."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_kernel_arguments_pack_the_plan():
    """What the kernel reads, packed on the CPU: the blob's length is the
    layout's, and the static arguments carry the plan."""
    tm = et.construct_hybrid_model(**_spec(parameters={**PARAMS, "tref": (15.0, 0.0, 30.0)}))
    plan = ff.plan_fused_forward(tm)
    assert plan.blob.numel() == ff._blob_floats(tm) == 4 * 2 + 3 * 16 + 17 * 16 + 17 + 2 + 3 + 1
    a = ff._Args.from_buffer_copy(plan.args_bytes)
    assert a.n_layers == 3 and list(a.dims[:4]) == [2, 16, 16, 1]
    assert list(a.acts[:3]) == [ff._ACT_IDS["swish"]] * 2 + [ff._ACT_IDS["identity"]]
    assert (a.has_norm, a.n_globals, a.n_fixed, a.n_args, a.n_out) == (1, 1, 1, 4, 1)
    assert list(a.arg_src[:4]) == [ff._SRC_NEURAL, ff._SRC_SCALAR, ff._SRC_FORCING, ff._SRC_SCALAR]
    assert a.arg_idx[3] == 1  # tref: the first fixed scalar, after the one global
    padded, pp_w, pp_b, tail = plan.kernel_blob  # the kernel's padded copy of the blob
    assert a.blob == padded.data_ptr() and a.x is None and a.blob_floats == padded.numel()
    assert list(a.pp_off_w[:3]) == pp_w == [8, 8 + 16 * 4 + 16, 8 + 16 * 4 + 16 + 16 * 17]
    assert list(a.pp_off_b[:3]) == pp_b and a.tail_off == tail == pp_b[2] + 1
    assert padded.numel() == -(-(tail + 2 + 3 + 1) // 4) * 4  # bounds, globals, fixed; to 4
    assert abs(a.norm_eps - 1e-5) < 1e-12 and plan.width == 16


@pytest.mark.parametrize("batch_size", [256, 1, 1000, 4096])
def test_serving_path_matches_the_jax_pallas_kernel(batch_size):
    """``FusedForward.table`` (the fused engine's serving path, through the
    plain version on the CPU) against the JAX Pallas forward in interpret
    mode on the same rows padded to whole chunks: 1,000 rows with NaN
    predictor rows, within 1e-5 * max(1, |ref|), the same NaN rows."""
    df = eh.gen_rbq10_data(1000, seed=31)
    spec = _spec()
    jm, params, state, tm, data = _pair(spec, df)
    data = eh.prepare_data(jm, df, drop_missing_rows=False)
    x = np.asarray(data.x).copy()
    x[np.random.default_rng(31).choice(1000, 11, replace=False), 0] = np.nan
    forcing = {k: np.asarray(v) for k, v in data.forcing.items()}
    padded = -(-1000 // batch_size) * batch_size
    jfwd = jax_make_fused_forward(jm, params, state, batch_size=batch_size, interpret=True)
    want = jfwd(jnp.asarray(np.pad(x, ((0, padded - 1000), (0, 0)))),
                {k: jnp.asarray(np.pad(v, (0, padded - 1000))) for k, v in forcing.items()})
    want = np.asarray(want["reco"])[:1000]
    got = et.make_fused_forward(tm, batch_size=batch_size).table(x, forcing)
    assert sorted(got) == ["rb", "reco"] and got["reco"].shape == (1000,)
    nan = np.isnan(want)
    assert nan.sum() == 11
    np.testing.assert_array_equal(np.isnan(got["reco"]), nan)
    assert np.all(np.abs(got["reco"][~nan] - want[~nan])
                  <= 1e-5 * np.maximum(1.0, np.abs(want[~nan])))


def test_padded_blob_holds_the_blob():
    """The kernel's copy of the parameters: the same values at the padded
    offsets, zeros in the padding, every layer from a multiple of 4."""
    tm = et.construct_hybrid_model(**_spec(hidden_layers=[5, 7]),
                                   generator=torch.Generator().manual_seed(3))
    plan = ff.plan_fused_forward(tm)
    padded, pp_w, pp_b, tail = plan.kernel_blob
    dims, blob = plan.dims, plan.blob
    assert torch.equal(padded[:8], blob[:8]) and all(o % 4 == 0 for o in pp_w)
    src = 8
    for (din, dout), w0, b0 in zip(zip(dims[:-1], dims[1:]), pp_w, pp_b):
        din4 = -(-din // 4) * 4
        w = padded[w0 : w0 + dout * din4].view(dout, din4)
        assert torch.equal(w[:, :din].reshape(-1), blob[src : src + dout * din])
        assert not w[:, din:].any() and b0 == w0 + dout * din4
        src += dout * din
        assert torch.equal(padded[b0 : b0 + dout], blob[src : src + dout])
        src += dout
    assert torch.equal(padded[tail : tail + blob.numel() - src], blob[src:])
    assert padded.numel() % 4 == 0 and not padded[tail + blob.numel() - src :].any()
