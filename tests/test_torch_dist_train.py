"""The sharded train step against the one-device step, on gloo CPU ranks.

Two steps (``microbatches=2``, AdamW at lr 1e-3 with float32 moments) of
deepseek-moe ``reduced()`` (capacity factor 16: no drops) and
recurrentgemma ``reduced()`` on a (data 2, model 2) mesh and on a
(pod 2, data 1, model 2) mesh (4 ranks, ``launch.mesh.spawn``) from the
same weights and batch as the one-device ``make_train_step`` of the port,
which ``tests/test_torch_train_loop.py`` holds against the reference's
single-device step. The losses and gradient norms within rtol 1e-5, every
weight and moment within 1e-4 of its leaf's largest value (the bound of
``tests/test_torch_train_loop.py``: float32 sums in other orders,
through Adam), and every rank's replicas equal. EP routes each shard's
tokens on their own, so the MoE's load-balance term is the mean of
per-shard terms (the reference's ``pmean``): the one-device step for
deepseek-moe runs the same per-shard routing
(``models.moe.per_shard_layer``), and its plain step differs by that
term.
Planted faults must fail: the MoE output's all-gather with a summing
backward (the gradient times tp), and a loss that averages per-shard
means where the shards' masks differ (ragged masks).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_mod

ARCH_NAMES = ["deepseek-moe-16b", "recurrentgemma-2b"]
MESHES = {"data2-model2": (2, 2, 0), "pod2-data1-model2": (1, 2, 2)}
B, S, STEPS = 8, 16, 2
RTOL = 1e-5
LEAF_TOL = 1e-4
OPT = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, moment_dtype="float32")


# Batches the (pod, data) axes do not divide (ROADMAP C.2): batch 1 on
# (data 2, model 2) is kept whole on every rank, batch 2 on (pod 2,
# data 2) is split over data alone. Each runs one microbatch; the MoE's
# oracle routes the distinct shards (dp) of tp sequence slices each.
FALLBACKS = {"b1-data2-model2": ((2, 2, 0), 1, 1, 2),
             "b2-pod2-data2": ((2, 1, 2), 2, 2, 1)}


def cfg_of(name, micro=2):
    cfg = ARCHS[name].reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return dataclasses.replace(cfg, microbatches=micro)


def batch_of(cfg, step, ragged=False, b=B):
    rng = np.random.default_rng(step)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, S + 1)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if ragged:
        # Rows of the first shard of each microbatch keep every token,
        # the others a few: the shards' mask counts differ.
        mask = torch.zeros(B, S)
        mask[:, :2] = 1.0
        mask[0:2] = 1.0
        mask[4:6] = 1.0
        batch["mask"] = mask
    return batch


def _model(cfg, mesh=None):
    gen = torch.Generator().manual_seed(0)
    return tfm.init_model(cfg, gen, dtype=cfg.activation_dtype, mesh=mesh)


def _train(cfg, mesh, ragged=False, steps_n=STEPS, b=B):
    model = _model(cfg, mesh)
    opt = opt_mod.init_opt_state(model, OPT)
    step = steps.make_train_step(cfg, OPT, mesh=mesh)
    metrics = []
    for i in range(steps_n):
        opt, m = step(model, opt, batch_of(cfg, i, ragged, b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, convert.to_reference(cfg, model), \
        convert.to_reference(cfg, opt.mu)


def one_device(name, dp=2, tp=2, ragged=False, steps_n=STEPS, b=B,
               micro=2):
    cfg = cfg_of(name, micro)
    saved = moe_mod.moe_layer
    if cfg.moe:
        moe_mod.moe_layer = moe_mod.per_shard_layer(dp, tp)
    try:
        return _train(cfg, None, ragged, steps_n, b)
    finally:
        moe_mod.moe_layer = saved


class _GatherSum(torch.autograd.Function):
    """The planted fault: an all-gather whose backward sums the ranks'
    gradients (a reduce-scatter), as if each rank's loss were its own."""
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        from repro_torch.core import shard_map as sm
        ctx.args = (dim, mesh, axis)
        return sm._all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core import shard_map as sm
        dim, mesh, axis = ctx.args
        return sm._reduce_scatter(g, dim, mesh, axis), None, None, None


def _per_shard_mean(nll, mask, mesh=None):
    from repro_torch.core import shard_map as sm
    local = torch.sum(nll * mask) / torch.sum(mask).clamp_min(1.0)
    return sm.reduce_out(local, mesh, sm.dp_axes(mesh)) / sm.dp_size(mesh)


def rank_main() -> dict:
    from repro_torch.core import shard_map as sm
    from repro_torch.launch import mesh as mesh_mod
    out = {}
    for key, (data, model, pod) in MESHES.items():
        mesh = mesh_mod.make_local_mesh(data, model, pod,
                                        device_type="cpu")
        for name in ARCH_NAMES:
            out[key, name] = _train(cfg_of(name), mesh)
    for key, ((data, model, pod), b, _, _) in FALLBACKS.items():
        mesh = mesh_mod.make_local_mesh(data, model, pod,
                                        device_type="cpu")
        for name in ARCH_NAMES:
            out[key, name] = _train(cfg_of(name, 1), mesh, b=b)
    mesh = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
    cfg = cfg_of("deepseek-moe-16b")
    saved = sm.gather
    sm.gather = _GatherSum.apply
    try:
        out["fault_tp"] = _train(cfg, mesh, steps_n=1)
    finally:
        sm.gather = saved
    out["ragged"] = _train(cfg, mesh, ragged=True, steps_n=1)
    saved = tfm.masked_mean
    tfm.masked_mean = _per_shard_mean
    try:
        out["fault_mean"] = _train(cfg, mesh, ragged=True, steps_n=1)
    finally:
        tfm.masked_mean = saved
    if torch.distributed.get_rank() != 0:
        # Replicas must agree: the other ranks report a checksum only.
        out = {k: (v[0], _checksum(v[1]), _checksum(v[2]))
               for k, v in out.items()}
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _checksum(tree) -> list:
    return [(k, hashlib.sha1(v.tobytes()).hexdigest())
            for k, v in _leaves(tree)]


def _close(got, want, what):
    for (k, a), (_, b) in zip(_leaves(got), _leaves(want)):
        tol = LEAF_TOL * max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= tol, (what, k,
                                            float(np.abs(a - b).max()), tol)


@pytest.fixture(scope="module")
def results():
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.spawn(rank_main, 4, backend="gloo", device="cpu",
                          timeout=300)


@pytest.fixture(scope="module")
def oracle():
    return {name: one_device(name) for name in ARCH_NAMES}


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_equals_one_device(results, oracle, mesh, name):
    metrics, params, mu = results[0][mesh, name]
    want_metrics, want_params, want_mu = oracle[name]
    for (l, g), (wl, wg) in zip(metrics, want_metrics):
        assert l == pytest.approx(wl, rel=RTOL)
        assert g == pytest.approx(wg, rel=RTOL)
    _close(params, want_params, "params")
    _close(mu, want_mu, "mu")


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_replicas_agree(results, mesh, name):
    first = _checksum(results[0][mesh, name][1])
    for r in results[1:]:
        assert r[mesh, name][0] == results[0][mesh, name][0]
        assert r[mesh, name][1] == first


def test_plain_one_device_step_differs_by_the_aux_term_only(oracle):
    """Without the per-shard routing the one-device loss differs by the
    aux term's weight times the terms' difference, and no more."""
    plain = _train(cfg_of("deepseek-moe-16b"), None, steps_n=1)
    cfg = cfg_of("deepseek-moe-16b")
    gap = abs(plain[0][0][0] - oracle["deepseek-moe-16b"][0][0][0])
    assert 0 < gap < cfg.moe.router_aux_weight * 3 * cfg.num_layers


def test_times_tp_gradient_fails(results, oracle):
    metrics, params, _ = results[0]["fault_tp"]
    want_metrics, want_params, _ = oracle["deepseek-moe-16b"]
    assert abs(metrics[0][1] / want_metrics[0][1] - 1) > 1e-3
    with pytest.raises(AssertionError):
        _close(params, one_device("deepseek-moe-16b", steps_n=1)[1],
               "params")


def test_ragged_masks_global_mean(results):
    want = one_device("deepseek-moe-16b", ragged=True, steps_n=1)
    metrics, params, _ = results[0]["ragged"]
    assert metrics[0][0] == pytest.approx(want[0][0][0], rel=RTOL)
    _close(params, want[1], "params")
    bad = results[0]["fault_mean"][0][0][0]
    assert abs(bad - want[0][0][0]) > 1e-3 * abs(want[0][0][0])


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_batch_split_equals_one_device(results, case, name):
    """A batch the (pod, data) axes do not divide runs as the reference
    runs it: split over data alone, or kept whole; the losses, gradient
    norms, weights and moments are the one-device step's, and every
    rank's replicas agree."""
    _, b, dp, tp = FALLBACKS[case]
    metrics, params, mu = results[0][case, name]
    want_metrics, want_params, want_mu = one_device(name, dp, tp, b=b,
                                                    micro=1)
    for (l, g), (wl, wg) in zip(metrics, want_metrics):
        assert l == pytest.approx(wl, rel=RTOL)
        assert g == pytest.approx(wg, rel=RTOL)
    _close(params, want_params, "params")
    _close(mu, want_mu, "mu")
    first = _checksum(params)
    for r in results[1:]:
        assert r[case, name][1] == first
