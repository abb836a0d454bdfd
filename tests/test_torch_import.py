"""The port imports torch and numpy only: importing easyhybrid_tpu_torch,
and training and predicting on a dict of columns, loads no JAX and no
pandas (checked in a fresh interpreter, because this test process already
imported JAX), and no module of the package names JAX in an import."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "easyhybrid_tpu_torch"


def test_import_loads_no_jax_and_no_pandas():
    code = (
        "import json, sys; import easyhybrid_tpu_torch, easyhybrid_tpu_torch.ops._build; "
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'pandas', 'easyhybrid_tpu', 'triton'))))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO).as_posix() for p in PACKAGE.rglob("*.py"))
)
def test_module_does_not_import_jax(path):
    src = (REPO / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import easyhybrid_tpu\b|from easyhybrid_tpu\b)",
                         src, re.M)


def test_train_and_predict_on_columns_load_no_jax_and_no_pandas():
    code = (
        "import json, sys\n"
        "import easyhybrid_tpu_torch as et\n"
        "cols = et.rbq10_columns(300, seed=1)\n"
        "m = et.construct_hybrid_model(predictors=['sw_pot', 'dsw_pot'], forcing=['ta'], "
        "targets=['reco'], mechanistic_model=et.rbq10, "
        "parameters={'rb': (3.0, 0.0, 13.0), 'Q10': (2.0, 1.0, 4.0)}, "
        "neural_param_names=['rb'], global_param_names=['Q10'], hidden_layers=[8], "
        "scale_nn_outputs=True, input_batchnorm=True)\n"
        "r = et.train(m, cols, nepochs=2, batchsize=64, show_progress=False, use_kernel=True)\n"
        "et.predict(m, cols)\n"
        "assert r.epoch_path == 'cuda_fused_epoch' and isinstance(r.val_obs_columns, dict)\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'pandas', 'easyhybrid_tpu', 'triton'))))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
