"""The CUDA fused forward kernel on a GPU, against its plain PyTorch version.

Imports no JAX, so it runs where only PyTorch with CUDA is installed. On a
machine without a GPU every test skips. On a GPU, without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: max |kernel - plain| <= 1e-5 * max(1, |plain|), float32: the
kernel uses CUDA's expf / powf / tanhf / rsqrtf and its own summation order,
against torch's transcendentals and GEMM.
"""

import numpy as np
import pytest
import torch

import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import fused_forward as ff

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cols, device, seed=0, **kw):
    spec = dict(
        predictors=["sw_pot", "dsw_pot"], forcing=["ta"], targets=["reco"],
        mechanistic_model=et.rbq10, parameters={"rb": (3.0, 0.0, 13.0), "Q10": (2.0, 1.0, 4.0)},
        neural_param_names=["rb"], global_param_names=["Q10"],
        hidden_layers=[16, 16], activation="swish",
        scale_nn_outputs=True, input_batchnorm="static",
    )
    spec.update(kw)
    m = et.construct_hybrid_model(**spec, generator=torch.Generator().manual_seed(seed))
    et.fit_input_norm(m, et.prepare_data(m, cols))
    m.to(device)
    data = et.prepare_data(m, cols, drop_missing_rows=False)
    x = torch.tensor(data.x, device=device)
    forcing = {k: torch.tensor(v, device=device) for k, v in data.forcing.items()}
    return m, x, forcing


def _assert_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k].cpu(), ref[k].cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(r)), k
        fin = ~torch.isnan(r)
        assert bool(((g[fin] - r[fin]).abs() <= TOL * r[fin].abs().clamp_min(1)).all()), k


def test_quick_start_kernel_matches_plain(cuda):
    cols = et.rbq10_columns(5000, seed=3)
    cols["sw_pot"][::97] = np.nan  # NaN predictor rows
    m, x, forcing = _model(cols, cuda)
    fn = et.make_fused_forward(m, batch_size=1024)
    before = ff.launch_fused_forward.launches
    got = fn(x, forcing)
    torch.cuda.synchronize()
    assert ff.launch_fused_forward.launches - before == 5  # ragged tail: 4 full + 1
    _assert_close(got, fn.reference(x, forcing))
    assert torch.isnan(got["reco"][::97].cpu()).all()


@pytest.mark.parametrize("act", sorted(et.ACTIVATIONS))
@pytest.mark.parametrize("norm", [False, "static"])
def test_activations_match_plain(cuda, act, norm):
    m, x, forcing = _model(et.rbq10_columns(777, seed=2), cuda, hidden_layers=[12, 5],
                           activation=act, input_batchnorm=norm)
    fn = et.make_fused_forward(m, batch_size=256)
    _assert_close(fn(x, forcing), fn.reference(x, forcing))


@pytest.mark.parametrize("hidden,width", [([8], 16), ([24, 32], 32), ([64, 48, 20], 64)])
def test_each_compiled_width_matches_plain(cuda, hidden, width):
    m, x, forcing = _model(et.rbq10_columns(1000, seed=4), cuda, hidden_layers=hidden,
                           activation="tanh")
    fn = et.make_fused_forward(m)
    assert fn.plan.width == width
    _assert_close(fn(x, forcing), fn.reference(x, forcing))


def test_predict_takes_the_kernel(cuda):
    cols = et.rbq10_columns(3000, seed=5)
    m, x, forcing = _model(cols, cuda)
    fn = et.make_inference_fn(m, batch_size=1024)
    assert fn.engine == "cuda_fused_forward"
    before = ff.launch_fused_forward.launches
    out = fn(cols)
    assert ff.launch_fused_forward.launches - before == 3
    m.eval()
    with torch.no_grad():
        plain = m(x, forcing)
    _assert_close({k: torch.from_numpy(v) for k, v in out.items()},
                  {"reco": plain["reco"], "rb": plain["parameters"]["rb"]})


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    m, x, forcing = _model(et.rbq10_columns(100, seed=6), cuda)
    fn = et.make_fused_forward(m)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.cat([x, x], 1)[:, ::2], forcing)
    with pytest.raises(ValueError, match="ta"):
        fn(x, {"ta": forcing["ta"].cpu()})
    cpu_model, _, _ = _model(et.rbq10_columns(100, seed=6), "cpu")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        et.make_fused_forward(cpu_model)(x, forcing)
