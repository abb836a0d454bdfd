"""The port imports torch and numpy only: importing easyhybrid_tpu_torch
loads no JAX and no pandas (checked in a fresh interpreter, because this
test process already imported JAX), and no module of the package names
JAX in an import."""

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
