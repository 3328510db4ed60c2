"""Activation tensor parallelism on ``"model"`` against the one-device
port, on gloo CPU ranks.

Every layer kind, ``reduced()`` and float32: ``attn`` with GQA
(internlm2: 4 heads, 2 KV heads, so the KV heads split), ``local`` +
``rec`` (recurrentgemma: 4 heads and 1 KV head, so the KV weights stay
whole and the window cache splits over its slots; LRU width 64), ``rwkv``
(4 heads of 16) and ``moe`` + ``dense0`` (deepseek-moe at capacity
factor 16: no drops). Four ranks (``launch.mesh.spawn``) run, on
(data 2, model 2) and (pod 2, data 1, model 2) under the reference's
``ACT_RULES`` (the steps' default: heads, KV heads, ff and vocab on
``"model"``), and on (data 2, model 2) under the hillclimb's
``ZERO16_ACT_RULES`` (vocab only), its ``FSDP_ACT_RULES`` (the batch
over ``(data, model)``, no TP: the MoE's EP path under ROADMAP C.6) and
a rule dict with ``heads``, ``kv_heads``, ``ff`` and ``vocab`` set to
None (the layout with no TP):

* two train steps (8 x 16 tokens, 2 microbatches, AdamW at lr 1e-3,
  float32 moments), each against the one-device step from the same
  state (step 2 from the mesh's state after step 1: see
  ``test_train_steps_equal_one_device``): the losses and gradient norms
  within rtol 1e-5, the first moments after each step and the weights
  after step 2 within 1e-4 of their leaf's largest value, every rank's
  replicas equal;
* a prefill of 4 x 16 tokens and 4 decode steps (cache 20 slots: the
  recurrentgemma window cache of 16 wraps past its size): the logits
  within 1e-5 of their largest value;
* each rank's cache leaves of the local shapes ``steps.cache_shardings``
  gives.

The one-device port step is held against the reference's by
``tests/test_torch_train_loop.py`` (the reference's own sharded tests
fail, ROADMAP C.1). DeepSeekMoE's one-device oracle routes as the EP
path's shards do (``models.moe.per_shard_layer(2, 2)``: each data shard's
sequence halves, each with its own capacity). ``FlopCounterMode``
counts each rank's matmul FLOPs of one prefill: under ``ACT_RULES`` they
are the no-TP layout's over tp = 2, but for the parts that stay whole on
every model rank (the replicated KV projections, RWKV's decay LoRA
input, the MoE router and its routed experts, which EP splits in both
layouts). Planted faults must fail: the row-parallel outputs without
their sum over ``"model"``, recurrentgemma's ``wk``/``wv`` gradients
averaged over ``"model"`` instead of summed, and the slot-split decode
merged without its log-sum-exp rescaling. ``convert.from_reference``
gives every rank the shards ``init_model`` gives it.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.launch import steps
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import convert
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.sharding import rules as shrules
from repro_torch.train import optimizer as opt_mod
from reference_source import module_values

REPO = Path(__file__).resolve().parents[1]
ARCH_NAMES = ["internlm2-1.8b", "recurrentgemma-2b", "rwkv6-1.6b",
              "deepseek-moe-16b"]
MESHES = {"data2-model2": (2, 2, 0), "pod2-data1-model2": (1, 2, 2)}
FSDP_ACT_RULES = shrules.FSDP_ACT_RULES
ZERO16_ACT_RULES = shrules.ZERO16_ACT_RULES
NO_TP = shrules.NO_TP_ACT_RULES
RULES = {"act": None, "zero16": ZERO16_ACT_RULES, "fsdp": FSDP_ACT_RULES,
         "no_tp": NO_TP}
CASES = [("data2-model2", "act"), ("pod2-data1-model2", "act"),
         ("data2-model2", "zero16"), ("data2-model2", "fsdp"),
         ("data2-model2", "no_tp")]
B, S, STEPS = 8, 16, 2
SERVE_B, DECODE = 4, 4
CACHE_LEN = S + DECODE
RTOL = 1e-5
LEAF_TOL = 1e-4
LOGIT_TOL = 1e-5
OPT = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, moment_dtype="float32")


def cfg_of(name):
    cfg = ARCHS[name].reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return dataclasses.replace(cfg, microbatches=2)


def batch_of(cfg, step):
    rng = np.random.default_rng(step)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def serve_tokens(cfg):
    rng = np.random.default_rng(100)
    toks = rng.integers(0, cfg.vocab_size, (SERVE_B, S + DECODE))
    return torch.from_numpy(toks.astype(np.int64))


def _model(cfg, mesh=None):
    gen = torch.Generator().manual_seed(0)
    return tfm.init_model(cfg, gen, dtype=cfg.activation_dtype, mesh=mesh)


def _train(cfg, mesh, act_rules):
    """(metrics, weights, first moments) after the steps, and the state
    after step 1 (weights and both moments)."""
    model = _model(cfg, mesh)
    opt = opt_mod.init_opt_state(model, OPT)
    step = steps.make_train_step(cfg, OPT, mesh=mesh, act_rules=act_rules)
    metrics, first = [], None
    for i in range(STEPS):
        opt, m = step(model, opt, batch_of(cfg, i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            # Copies: a leaf to_reference leaves on the host may share
            # the live tensor's memory.
            first = tuple(_copy(convert.to_reference(cfg, t))
                          for t in (model, opt.mu, opt.nu))
    return metrics, convert.to_reference(cfg, model), \
        convert.to_reference(cfg, opt.mu), first


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return np.array(tree, copy=True)


def _step_from(cfg, state, i):
    """The one-device step ``i`` from a state (reference trees of the
    weights and both moments, after ``i`` steps): its metrics, weights
    and first moments."""
    params, mu, nu = state

    def flat(tree):
        return {k: v.detach() for k, v in convert.from_reference(
            cfg, tree, device="cpu").named_parameters()}
    model = convert.from_reference(cfg, params, device="cpu")
    opt = opt_mod.OptState(torch.tensor(i, dtype=torch.int32), flat(mu),
                           flat(nu))
    step = steps.make_train_step(cfg, OPT)
    opt, m = step(model, opt, batch_of(cfg, i))
    return (float(m["loss"]), float(m["grad_norm"])), \
        convert.to_reference(cfg, model), convert.to_reference(cfg, opt.mu)


def _rows(t, mesh, axes):
    """The global batch from the ranks' rows (split over ``axes``)."""
    from repro_torch.core import shard_map as sm
    for a in reversed(axes):
        t = sm.gather(t, 0, mesh, a)
    return t


def _shapes(caches):
    return [[tuple(t.shape) for t in c if isinstance(t, torch.Tensor)]
            for c in caches]


def _serve(cfg, mesh, act_rules):
    """Prefill logits, each decode step's logits (whole batch) and the
    caches' shapes after the prefill and after the last step."""
    model = _model(cfg, mesh)
    toks = serve_tokens(cfg)
    prefill = steps.make_prefill_step(cfg, CACHE_LEN, mesh=mesh,
                                      act_rules=act_rules)
    decode = steps.make_decode_step(cfg, SERVE_B, mesh=mesh,
                                    act_rules=act_rules)
    axes = decode.batch_axes
    logits, caches = prefill(model, {"tokens": toks[:, :S]})
    out = [_rows(logits, mesh, axes) if mesh is not None else logits]
    shapes = [_shapes(caches)]
    for t in range(DECODE):
        logits, caches = decode(model, toks[:, S + t:S + t + 1], caches,
                                S + t)
        out.append(_rows(logits, mesh, axes) if mesh is not None
                   else logits)
    shapes.append(_shapes(caches))
    return [o.numpy() for o in out], shapes


def _want_shapes(cfg, mesh, act_rules):
    """Each cache leaf's local shape by ``steps.cache_shardings``."""
    whole = tfm.init_cache(cfg, SERVE_B, CACHE_LEN, torch.float32,
                           device="cpu")
    specs = steps.cache_shardings(whole, mesh, act_rules)
    out = []
    for c, spec in zip(whole, specs):
        out.append([steps.local_shape(t.shape, sp, mesh)
                    for t, sp in zip(c, spec)
                    if isinstance(t, torch.Tensor)])
    return out, [[sp for t, sp in zip(c, spec)
                  if isinstance(t, torch.Tensor)]
                 for c, spec in zip(whole, specs)]


def _prefill_flops(cfg, mesh, act_rules) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    model = _model(cfg, mesh)
    prefill = steps.make_prefill_step(cfg, CACHE_LEN, mesh=mesh,
                                      act_rules=act_rules)
    toks = serve_tokens(cfg)[:, :S]
    with FlopCounterMode(display=False) as counter:
        prefill(model, {"tokens": toks})
    return counter.get_total_flops()


def _same_shards(cfg, mesh) -> bool:
    """``convert.from_reference(mesh=...)`` gives the rank the shards
    ``init_model(mesh=...)`` gives it (the parameters' layout does not
    change with the activation rules)."""
    sharded = dict(_model(cfg, mesh).named_parameters())
    whole = convert.to_reference(cfg, _model(cfg))
    converted = dict(convert.from_reference(cfg, whole, device="cpu",
                                            mesh=mesh).named_parameters())
    return sorted(sharded) == sorted(converted) and all(
        sharded[k].placements == converted[k].placements
        and torch.equal(sharded[k].to_local(), converted[k].to_local())
        for k in sharded)


def _naive_merge(m, l, acc, mesh):
    """The planted fault: the partials summed without rescaling each to
    the global max."""
    from repro_torch.core import shard_map as sm
    return sm.all_reduce(acc, mesh, "model") / \
        sm.all_reduce(l, mesh, "model")[..., None]


def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, saved)


def rank_main() -> dict:
    from repro_torch.launch import mesh as mesh_mod
    out = {}
    meshes = {key: mesh_mod.make_local_mesh(d, m, p, device_type="cpu")
              for key, (d, m, p) in MESHES.items()}
    for key, rules in CASES:
        mesh = meshes[key]
        for name in ARCH_NAMES:
            cfg = cfg_of(name)
            out["train", key, rules, name] = _train(cfg, mesh, RULES[rules])
            logits, shapes = _serve(cfg, mesh, RULES[rules])
            want, specs = _want_shapes(cfg, mesh, RULES[rules])
            out["serve", key, rules, name] = logits, shapes, want, specs
    mesh = meshes["data2-model2"]
    for name in ARCH_NAMES:
        cfg = cfg_of(name)
        out["flops", name] = (_prefill_flops(cfg, mesh, None),
                              _prefill_flops(cfg, mesh, NO_TP))
        out["convert", name] = _same_shards(cfg, mesh)
    # Planted faults.
    cfg = cfg_of("internlm2-1.8b")
    restore = _patched(common, "leave_tp", lambda y: y)
    try:
        out["fault_reduce"] = _serve(cfg, mesh, None)[0]
    finally:
        restore()
    cfg = cfg_of("recurrentgemma-2b")
    restore = _patched(attn_mod, "_kv_grad", lambda lay: "mean")
    try:
        out["fault_kv_grad"] = _train(cfg, mesh, None)
    finally:
        restore()
    restore = _patched(attn_mod, "_merge_partials", _naive_merge)
    try:
        out["fault_merge"] = _serve(cfg, mesh, None)[0]
    finally:
        restore()
    if torch.distributed.get_rank() != 0:
        # Replicas must agree: the other ranks report checksums of the
        # trained weights.
        out = {k: ((v[0], _checksum(v[1]), _checksum(v[2]), None)
                   if k[0] == "train" else v)
               for k, v in out.items() if isinstance(k, tuple)}
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


def _logits_close(got, want):
    for step, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (step, a.shape, b.shape)
        tol = LOGIT_TOL * float(np.abs(b).max())
        assert np.abs(a - b).max() <= tol, (step,
                                            float(np.abs(a - b).max()), tol)


def _one_device(fn, name):
    cfg = cfg_of(name)
    saved = moe_mod.moe_layer
    if cfg.moe:
        moe_mod.moe_layer = moe_mod.per_shard_layer(2, 2)
    try:
        return fn(cfg, None, None)
    finally:
        moe_mod.moe_layer = saved


@pytest.fixture(scope="module")
def results():
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.spawn(rank_main, 4, backend="gloo", device="cpu",
                          timeout=400)


@pytest.fixture(scope="module")
def oracle():
    return {name: (_one_device(_train, name), _one_device(_serve, name))
            for name in ARCH_NAMES}


CASE_IDS = [f"{k}-{r}" for k, r in CASES]


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_train_steps_equal_one_device(results, oracle, case, name):
    """Each step against the one-device step from the same state: step 1
    from the same initial weights (its loss, gradient norm and first
    moments, a tenth of its gradients), step 2 from the mesh's state
    after step 1 (its loss, gradient norm, weights and first moments).
    The two runs' weights after step 1 differ by rounding that Adam's
    first update scales up: a weight whose gradient lies near Adam's
    epsilon moves by a share of the learning rate that float32 rounding
    sets, and the next step starts from there."""
    metrics, params, mu, first = results[0][("train",) + case + (name,)]
    (want_metrics, _, _, want_first), _ = oracle[name]
    (l, g), = metrics[:1]
    assert l == pytest.approx(want_metrics[0][0], rel=RTOL)
    assert g == pytest.approx(want_metrics[0][1], rel=RTOL)
    _close(first[1], want_first[1], "mu after step 1")
    (wl, wg), want_params, want_mu = _one_device(
        lambda cfg, *_: _step_from(cfg, first, 1), name)
    assert metrics[1][0] == pytest.approx(wl, rel=RTOL)
    assert metrics[1][1] == pytest.approx(wg, rel=RTOL)
    _close(params, want_params, "params")
    _close(mu, want_mu, "mu")
    checksum = _checksum(params)
    for r in results[1:]:
        assert r[("train",) + case + (name,)][0] == metrics
        assert r[("train",) + case + (name,)][1] == checksum


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_prefill_and_decode_equal_one_device(results, oracle, case, name):
    _, (want, _) = oracle[name]
    for r in results:
        logits, _, _, _ = r[("serve",) + case + (name,)]
        _logits_close(logits, want)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_cache_leaves_take_cache_shardings_layout(results, case, name):
    for r in results:
        _, shapes, want, _ = r[("serve",) + case + (name,)]
        assert shapes[0] == want and shapes[1] == want


def test_act_rules_split_what_the_reference_splits(results):
    """Under ``ACT_RULES`` internlm2's KV heads, recurrentgemma's window
    slots and LRU width, and RWKV's heads lie over ``"model"``; the
    no-TP rules keep every cache whole over it."""
    specs = {name: results[0][("serve", "data2-model2", "act", name)][3]
             for name in ARCH_NAMES}
    kinds = {name: tfm.layer_kinds(cfg_of(name)) for name in ARCH_NAMES}
    for name, layer_specs in specs.items():
        for kind, spec in zip(kinds[name], layer_specs):
            if kind in ("attn", "moe", "dense0"):
                assert spec[0] == ("data", None, "model", None), (name, spec)
            elif kind == "local":
                assert spec[0] == ("data", "model", None, None), (name, spec)
            elif kind == "rwkv":
                assert spec[0] == ("data", "model", None, None), (name, spec)
            else:
                assert spec == [("data", "model"), ("data", None, "model")]
    for name in ARCH_NAMES:
        for spec in results[0][("serve", "data2-model2", "no_tp", name)][3]:
            assert all("model" not in s for s in spec), (name, spec)
    # The rolling window wraps in the decode steps.
    assert S + DECODE > cfg_of("recurrentgemma-2b").window


def test_tp_divides_matmul_flops(results):
    """A rank's prefill matmul FLOPs under ``ACT_RULES`` are the no-TP
    layout's over tp, but for the parts every model rank computes whole
    (reckoned from the configs)."""
    tp, rows = 2, SERVE_B // 2 * S            # a rank's (data shard) tokens
    for name in ARCH_NAMES:
        cfg = cfg_of(name)
        tp_flops, whole_flops = results[0][("flops", name)]
        d, kinds = cfg.d_model, tfm.layer_kinds(cfg)
        kept = 0
        for kind in kinds:
            if kind in ("attn", "local", "moe", "dense0") and \
                    cfg.num_kv_heads % tp:
                kept += 2 * 2 * rows * d * cfg.num_kv_heads * cfg.head_dim
            if kind == "rwkv":
                kept += 2 * rows * d * 64                  # decay_a
            if kind == "moe":
                mo = cfg.moe
                cap = moe_mod._capacity(rows // tp, mo)
                kept += 2 * rows // tp * d * mo.num_experts  # the router
                kept += 6 * mo.num_experts * cap * d * mo.expert_d_ff
        want = (whole_flops - kept) / tp + kept
        assert tp_flops == pytest.approx(want, rel=1e-9), (name, tp_flops,
                                                           whole_flops, kept)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_converted_weights_take_init_model_shards(results, name):
    assert all(r[("convert", name)] for r in results)


def test_row_parallel_without_reduce_fails(results, oracle):
    with pytest.raises(AssertionError):
        _logits_close(results[0]["fault_reduce"], oracle["internlm2-1.8b"][1][0])


def test_kv_gradient_averaged_fails(results, oracle):
    metrics, params, mu, _ = results[0]["fault_kv_grad"]
    (want_metrics, _, want_mu, _), _ = oracle["recurrentgemma-2b"]
    assert abs(metrics[0][1] / want_metrics[0][1] - 1) > 1e-4
    with pytest.raises(AssertionError):
        _close(mu, want_mu, "mu")


def test_merge_without_log_sum_exp_fails(results, oracle):
    got = results[0]["fault_merge"]
    want = oracle["recurrentgemma-2b"][1][0]
    _logits_close(got[:1], want[:1])          # the prefill is unaffected
    with pytest.raises(AssertionError):
        _logits_close(got, want)


def test_rule_sets_equal_the_reference():
    # Read from the source: importing repro.launch.hillclimb would set
    # XLA_FLAGS to 512 host devices for every later test of the worker.
    hillclimb = types.SimpleNamespace(**module_values(
        "repro.launch.hillclimb", "FSDP_ACT_RULES", "ZERO16_ACT_RULES"))
    assert FSDP_ACT_RULES == hillclimb.FSDP_ACT_RULES
    assert ZERO16_ACT_RULES == hillclimb.ZERO16_ACT_RULES


def test_rule_set_test_leaves_jax_one_device():
    """The test above, run through pytest in a fresh process, leaves
    ``XLA_FLAGS`` unset and JAX on one device for what runs after it."""
    code = textwrap.dedent("""
        import os, sys
        import pytest
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                          "-p", "no:randomly", sys.argv[1]])
        import jax
        print("RESULT", int(rc), os.environ.get("XLA_FLAGS"),
              jax.device_count())
    """)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", code, f"{Path(__file__).name}::"
         "test_rule_sets_equal_the_reference"], cwd=Path(__file__).parent,
        capture_output=True, text=True, env=env, timeout=300)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, out.stdout[-2000:] + out.stderr[-2000:]
    assert line[-1].split()[1:] == ["0", "None", "1"], line[-1]


@pytest.mark.parametrize("heads,kv_heads", [(10, 1), (8, 2), (12, 3)])
def test_local_kv_pairs_each_query_head_with_its_kv_head(heads, kv_heads):
    """Under split query heads and whole KV heads each rank's heads
    attend with the KV heads the whole layer pairs them with: one shared
    KV head (10, 1), whole groups (8, 2) and groups that straddle the
    ranks (12, 3: 6 heads a rank, groups of 4)."""
    tp = 2
    cfg = dataclasses.replace(ARCHS["internlm2-1.8b"].reduced(),
                              num_heads=heads, num_kv_heads=kv_heads)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 8, heads, 16), generator=gen)
    k = torch.randn((2, 8, kv_heads, 16), generator=gen)
    v = torch.randn((2, 8, kv_heads, 16), generator=gen)
    whole = attn_mod._sdpa(q, k, v, causal=True)
    hl = heads // tp
    for rank in range(tp):
        lay = attn_mod.Layout(True, False, tp, rank)
        part = attn_mod._sdpa(q[:, :, rank * hl:(rank + 1) * hl],
                              *attn_mod._local_kv(k, v, cfg, lay),
                              causal=True)
        torch.testing.assert_close(part,
                                   whole[:, :, rank * hl:(rank + 1) * hl])
