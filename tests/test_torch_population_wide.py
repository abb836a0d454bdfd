"""Populations of a wide MLP hybrid in the port: kernel 3's member axis
(``FusedWideEpoch.members``, behind the gate and the member self-check in
``population_train`` and ``population_cross_validate``) against the JAX
package on the CPU, and its plumbing.

The member axis's plain version (the port's fused path on CPU tensors,
``fused_wide_members_reference``) is held against the JAX package's
populations of the same model, the JAX inits carried across, on unshuffled
runs of its XLA engine, which the JAX package runs on a backend that is not
a TPU (``_fused_backend_blocked``). Tolerance ``1e-4 * max(1, |ref|)``
(``assert_population_matches``): the engines sum in other orders and the
differences compound over the steps.
"""

import numpy as np
import pytest
import torch

import easyhybrid_tpu as eh
import easyhybrid_tpu_torch as et
from easyhybrid_tpu_torch.ops import fused_epoch as fe
from easyhybrid_tpu_torch.ops import fused_wide as fw
from easyhybrid_tpu_torch.training import epoch as tepoch
from easyhybrid_tpu_torch.training import population as pop
from test_torch_population import _carry_jax_inits, _pair, assert_population_matches

HIDDEN = [72]  # wider than kernel 2's 64: kernel 3's model
KW = dict(nepochs=4, batchsize=64, eval_every=2, seed=3, data_seed=0, shuffle_each_epoch=False)

XLA_CASES = {
    "lr sweep, a duplicate member": dict(hyper={"learning_rate": [0.01, 0.003, 0.01]}),
    "seed ensemble, trainable norm, agg mean": dict(hyper={"learning_rate": [0.01]},
                                                    seeds=[0, 1], agg="mean", norm=True),
}


@pytest.mark.parametrize("case", list(XLA_CASES), ids=str)
def test_member_axis_plain_version_matches_the_jax_population(monkeypatch, case):
    kw = dict(XLA_CASES[case])
    jm, tm = _pair(hidden=HIDDEN, norm=kw.pop("norm", "static"))
    _carry_jax_inits(monkeypatch, jm)
    want = eh.population_train(jm, eh.gen_rbq10_data(300, seed=5), **KW, **kw)
    got = et.population_train(tm, et.rbq10_columns(300, seed=5), **KW, **kw, use_kernel=True)
    assert want.epoch_path == "population_vmap"
    assert got.epoch_path == "population_vmap_fused", got.engine_reason
    assert_population_matches(tm, got, want)
    if "duplicate" in case:
        assert all(torch.equal(v[0], v[2]) for v in got.params.values())


def test_member_axis_cross_validation_matches_the_jax_population(monkeypatch):
    jm, tm = _pair(hidden=HIDDEN)
    _carry_jax_inits(monkeypatch, jm)
    kw = dict(k=3, optimizer=("adam", 0.01), **{k: v for k, v in KW.items() if k != "seed"},
              seed=2)
    want = eh.population_cross_validate(jm, eh.gen_rbq10_data(300, seed=9), **kw)
    got = et.population_cross_validate(tm, et.rbq10_columns(300, seed=9), **kw, use_kernel=True)
    assert want.epoch_path == "population_vmap_cv"
    assert got.epoch_path == "population_vmap_cv_fused", got.engine_reason
    assert_population_matches(tm, got, want)


# ---------------------------------------------------------------------------
# the member call and its self-check, without a card
# ---------------------------------------------------------------------------

def _member_call(kind, k=3):
    """A kernel-3 member call on CPU tensors: k members of MLP [72] at 400
    rows (10% NaN targets), batch 64, 2 epochs; a learning-rate sweep with
    one permutation, a seed ensemble with a permutation each and a trainable
    norm, or folds with a fold's rows and norm each."""
    _, tm = _pair(hidden=HIDDEN, norm=True if kind == "ensemble" else "static")
    cols = et.rbq10_columns(400, seed=4, nan_frac=0.1)
    loss = {"sweep": "mse", "ensemble": "nseLoss", "folds": "kgeLoss"}[kind]
    ll = et.LoggingLoss(training_loss=loss, loss_types=(loss,))
    fn = et.make_fused_wide_epoch(tm, ("adam", 0.01), ll, shuffle=True, epochs_per_call=2)
    folds = kind == "folds"
    prepared = et.prepare_data(tm, cols)
    splits = ([prepared.take(np.arange(i, prepared.n_samples, k)[: prepared.n_samples // k])
               for i in range(k)] if folds else [et.split_data(cols, tm)[0]])
    inits = [pop.init_member_params(tm, 0 if kind == "sweep" else s) for s in range(k)]
    params = {n: torch.stack([i[n] for i in inits]) for n in inits[0]}
    buffers = []
    for i in range(k):
        et.fit_input_norm(tm, splits[i % len(splits)])
        buffers.append({n: b.detach().clone() for n, b in tm.named_buffers()})
    buffers = {n: torch.stack([b[n] for b in buffers]) for n in buffers[0]}
    packed = pop._pack_members(fn.plan, pop._norm_buffer_names(tm), params, buffers)
    opt = pop._stacked_opt_state(packed, ("adam", 0.01), k)
    tensors = [tepoch.epoch_tensors_to(et.build_epoch_tensors(s, 64), "cpu") for s in splits]
    data = fn.member_data(tensors if folds else tensors[0])
    rows = fn.member_rows(data, k, per_member_data=folds, generator=torch.Generator().manual_seed(1),
                          shared_perms=kind == "sweep")
    specs = ([("adam", {"learning_rate": lr}) for lr in (0.003, 0.03, 0.003)]
             if kind == "sweep" else None)
    return fn, packed, opt, tensors, data, rows, specs


@pytest.mark.parametrize("kind", ["sweep", "ensemble", "folds"])
def test_members_equal_their_calls_alone(kind):
    """Each member of a member call (``fused_wide_members_reference``) equals
    its call alone (K = 1, its spec, rows and data, its own running
    statistics) bit for bit, and the member self-check passes."""
    fn, packed, opt, tensors, data, rows, specs = _member_call(kind)
    got = fn.members(packed, opt, data, rows, specs=specs)
    ref = fw.fused_wide_members_reference(fn.plan, packed, opt, data, rows, specs=specs)
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    assert got[0].params.shape == packed.params.shape and got[2].shape == (3,)
    for i in range(3):
        p, o, loss = fn.alone(fe.FusedParams(packed.params[i], packed.bn[i]),
                              {k: v[i] for k, v in opt.items()}, data,
                              rows[i] if rows.dim() == 3 else rows,
                              None if specs is None else specs[i])
        assert torch.equal(p.params, got[0].params[i]) and torch.equal(p.bn, got[0].bn[i])
        assert all(torch.equal(o[k], got[1][k][i]) for k in o)
        assert torch.equal(loss[0], got[2][i])
    assert not torch.equal(got[0].params[0], got[0].params[1])
    if kind == "ensemble":  # each member's own running statistics moved
        assert not torch.equal(got[0].bn[0], packed.bn[0])
        assert not torch.equal(got[0].bn[0], got[0].bn[1])
    if kind == "sweep":
        assert torch.equal(got[0].params[0], got[0].params[2])  # the duplicate
    assert pop.member_selfcheck(fn, packed, opt, tensors if kind == "folds" else tensors[0],
                                specs=specs, per_member_data=kind == "folds",
                                shared_perms=kind == "sweep") is None


def test_the_call_arguments_carry_the_member_axis():
    """Kernel 3's argument struct for a member call: the member count, the
    row index's member stride, the members' optimizer rows, a workspace and
    partial sums a member, each member's loss scales from its own rows (the
    numbers of its call alone), a fold's rows after the folds before it;
    shapes the kernels do not read raise."""
    fn, packed, opt, tensors, data, rows, _ = _member_call("folds")
    plan = fn.plan
    n = tensors[0].weight.numel()
    assert data.x.shape == (3 * n, 2) and rows.shape == (3, 2, n)
    assert int(rows[2].min()) >= 2 * n and int(rows[0].max()) < n
    member_opt = fe.member_opt_rows(plan, [("adam", {"learning_rate": lr})
                                           for lr in (0.01, 0.02, 0.03)])
    call = fw.wide_launch_args(plan, packed, opt, data, rows, 3, member_opt=member_opt)
    a, lay = call.args, plan.layout(data.batch)
    assert (a.n_members, a.n_epochs, a.perm_stride) == (3, 2, 2 * n)
    assert (a.ws_stride, a.part_stride) == (lay.ws_floats, lay.part_floats)
    assert a.member_opt == member_opt.data_ptr() and a.params == packed.params.data_ptr()
    assert a.l2_parts is None and a.l2_leaves == 0
    scale, valid = call.scratch[:2]
    for i in range(3):
        s_i, v_i = fw.batch_scales(plan, data, rows[i])
        assert torch.equal(scale[i], s_i) and torch.equal(valid[i], v_i)
    assert call.tcount.shape == (3, 2 * tensors[0].weight.shape[0])
    one = fw.wide_launch_args(plan, fe.FusedParams(packed.params[0], packed.bn[0]),
                              {k: v[0] for k, v in opt.items()}, data, rows[0], 1).args
    assert (one.n_members, one.perm_stride, one.member_opt) == (1, 0, None)
    with pytest.raises(ValueError, match="row index"):
        fw.launch_fused_wide(plan, packed, opt, data, rows[:2], torch.zeros(3))
    with pytest.raises(ValueError, match="loss"):
        fw.launch_fused_wide(plan, packed, opt, data, rows, torch.zeros(1))


def test_the_workspace_check_counts_every_member():
    """A population whose members' workspaces exceed the card's share runs
    the torch engine with a reason naming kernel 3's member axis."""
    _, tm = _pair(hidden=HIDDEN)
    tensors = tepoch.epoch_tensors_to(
        et.build_epoch_tensors(et.split_data(et.rbq10_columns(300, seed=2), tm)[0], 64), "cpu")
    ll = et.LoggingLoss()
    need = fw.wide_layout((2, 72, 1), True, 64).nbytes
    memory = int(need / fw.WORKSPACE_SHARE) + 1
    assert fw.fused_wide_unsupported_reason(tm, "adam", ll, tensors, memory_bytes=memory) is None
    got = fw.fused_wide_unsupported_reason(tm, "adam", ll, tensors, memory_bytes=memory, members=2)
    assert got.startswith(f"2 members' steps activations and partial sums take {2 * need} bytes")


def test_population_train_reaches_kernel_3s_member_axis(monkeypatch):
    """``population_train`` on a wide model takes the member axis (its plain
    version on the CPU under ``use_kernel=True``, as for kernel 2), one call
    a block; ``use_kernel=False`` keeps the torch engine."""
    calls = []
    real = fw.FusedWideEpoch.members

    def counted(self, *a, **k):
        calls.append(self.plan.dims)
        return real(self, *a, **k)

    monkeypatch.setattr(fw.FusedWideEpoch, "members", counted)
    _, tm = _pair(hidden=HIDDEN)
    cols = et.rbq10_columns(300, seed=2)
    r = et.population_train(tm, cols, hyper={"learning_rate": [0.01, 0.003]}, nepochs=4,
                            batchsize=64, eval_every=2, use_kernel=True)
    assert r.epoch_path == "population_vmap_fused"
    assert r.engine_reason.startswith("exactness gate (max grad diff")
    assert calls[-2:] == [(2, 72, 1)] * 2  # a call a block
    off = et.population_train(tm, cols, hyper={"learning_rate": [0.01]}, nepochs=2, batchsize=64,
                              eval_every=2, use_kernel=False)
    assert off.epoch_path == "population_vmap" and off.engine_reason.startswith("use_kernel")
