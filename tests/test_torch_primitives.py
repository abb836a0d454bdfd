"""The multi-site primitives' plain versions (what the wrappers compute on
CPU tensors) at row widths around the lane groups of the CUDA kernels: 1, 3,
63, 64, 65 and 1,000 observations a site, against float64 numpy; and the C
interface of ``csrc/multisite_primitives.cu`` against the argument types
``ops/_build.py`` declares. Tolerance: float32 sums of ``n`` values in
[0, 1), ``1e-6 * n``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from easyhybrid_tpu_torch.ops import multisite_primitives as mp

CU_SOURCE = Path(mp.__file__).resolve().parent.parent / "csrc" / "multisite_primitives.cu"
WIDTHS = [1, 3, 63, 64, 65, 1000]


def _inputs(n_obs, seed=0, n_sites=400, n_slots=301):
    rng = np.random.default_rng(seed + n_obs)
    vals = rng.random(n_sites, dtype=np.float32)
    index = rng.permutation(n_sites)[:n_slots].astype(np.int32)
    index[::7] = -1  # padding slots
    x = rng.random((n_slots, n_obs), dtype=np.float32)
    return vals, index, x


@pytest.mark.parametrize("n_obs", WIDTHS)
def test_site_reduce_plain_version(n_obs):
    _, _, x = _inputs(n_obs)
    got = mp.site_reduce(torch.from_numpy(x))
    assert got.shape == (x.shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64).sum(1), rtol=0, atol=1e-6 * n_obs)
    mask = (x > 0.3).astype(np.float32)  # counts of whole numbers are exact in any order
    assert np.array_equal(mp.site_reduce(torch.from_numpy(mask)).numpy(), mask.sum(1))


@pytest.mark.parametrize("n_obs", WIDTHS)
def test_site_chain_plain_version(n_obs):
    vals, index, x = _inputs(n_obs, seed=1)
    acc = torch.ones(vals.shape[0])
    mp.site_chain(torch.from_numpy(vals), torch.from_numpy(index), torch.from_numpy(x), acc)
    want = np.ones(vals.shape[0], np.float64)
    live = index >= 0
    want[index[live]] += vals[index[live]].astype(np.float64) * x[live].astype(np.float64).sum(1)
    np.testing.assert_allclose(acc.numpy(), want, rtol=0, atol=1e-6 * n_obs)
    untouched = np.setdiff1d(np.arange(vals.shape[0]), index[live])
    assert np.array_equal(acc.numpy()[untouched], np.ones(untouched.size, np.float32))


@pytest.mark.parametrize("n_obs", [1, 64, 65])
def test_site_gather_and_update_plain_versions_are_exact(n_obs):
    vals, index, _ = _inputs(n_obs, seed=2)
    got = mp.site_gather(torch.from_numpy(vals), torch.from_numpy(index), n_obs).numpy()
    want = np.where(index >= 0, vals[np.maximum(index, 0)], 0.0)[:, None].repeat(n_obs, 1)
    assert np.array_equal(got, want.astype(np.float32))
    fresh = np.random.default_rng(3).random(index.shape[0], dtype=np.float32)
    out = torch.from_numpy(vals.copy())
    mp.site_update(out, torch.from_numpy(index), torch.from_numpy(fresh))
    ref = vals.copy()
    ref[index[index >= 0]] = fresh[index >= 0]
    assert np.array_equal(out.numpy(), ref)


def test_c_interface_matches_the_declared_argument_types():
    src = CU_SOURCE.read_text()
    sigs = dict(re.findall(r'extern "C" int (eh_prim_\w+)\(([^)]*)\)', src))
    assert set(sigs) == {"eh_prim_site_gather", "eh_prim_site_reduce", "eh_prim_site_update",
                         "eh_prim_site_chain", "eh_prim_block_sum"}
    counts = {name: len(args.split(",")) for name, args in sigs.items()}
    assert counts == {"eh_prim_site_gather": 6, "eh_prim_site_reduce": 5, "eh_prim_site_update": 5,
                      "eh_prim_site_chain": 7, "eh_prim_block_sum": 5}
    # the row sums share one helper with kernel 5 (eh_device.cuh): a group of
    # lanes per row, a fixed shuffle tree
    header = CU_SOURCE.with_name("eh_device.cuh").read_text()
    helper = re.search(r"float eh_group_sum\(.*?\n\}", header, re.S).group(0)
    assert src.count("eh_group_sum(") == 2 and "__shfl_xor_sync" in helper and "atomic" not in src
    assert "eh_group_sum(" in CU_SOURCE.with_name("fused_multisite.cu").read_text()


def test_wrappers_refuse_other_devices_and_layouts():
    x = torch.rand(4, 6)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mp.site_reduce(x.to("meta"))
    assert mp.launch_primitive.launches == 0 or isinstance(mp.launch_primitive.launches, int)
    assert torch.equal(mp.block_sum(x), x.sum(0))
