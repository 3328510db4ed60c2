"""The port's LLM serving slice against the JAX reference, on the CPU.

``forward_prefill`` (both routes: ``impl="reference"``, and the kernel
route with the kernels' plain versions, which is ``impl="flash"`` and,
for DeepSeekMoE, ``impl="flash_moe"``: the grouped-matmul kernel with the
flash-attention kernel) and eight greedy ``forward_decode`` steps of
``recurrentgemma-2b``, ``internlm2-1.8b``, ``rwkv6-1.6b`` and
``deepseek-moe-16b`` in their ``reduced()`` configs, with the reference's
weights loaded through ``models.convert``: last-token logits and every
layer's cache within 1e-4 (float32, a few layers of differently ordered
sums), greedy tokens identical. ``qwen3-moe-235b-a22b`` (renormalized
top-k gates) gets the prefill check. Then ``ServingEngine(device="cpu")``
against a hand-driven JAX loop that copies ``repro.serve.engine``'s
``serve`` (completions identical) and its ``cost_report`` arithmetic
(equal). Prompts of 24 tokens exceed the reduced window of 16, so the
rolling window cache is exercised; the reduced RWKV-6 chunk of 8 splits
them into three chunks; the reduced MoE capacity (15 slots an expert at
48 tokens, 1 at decode) drops tokens.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import transformer as jtfm
from repro.models.common import split_tree
from repro.serve import engine as jengine
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.launch import serve as tserve_launch
from repro_torch.models import convert
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import KVCache
from repro_torch.models.rwkv6 import RwkvState
from repro_torch.serve.engine import Request, ServingEngine
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH_IDS = ["recurrentgemma-2b", "internlm2-1.8b", "rwkv6-1.6b",
            "deepseek-moe-16b"]
B, S, CACHE_LEN, DECODE_STEPS = 2, 24, 40, 8
TOL = 1e-4
# The kernel route of each architecture, where it is not "flash".
KERNEL_ROUTE = {"deepseek-moe-16b": "flash_moe",
                "qwen3-moe-235b-a22b": "flash_moe"}

_JAX_STEPS: dict = {}


def _route(arch, impl):
    """``impl`` of a test ("reference" or "flash") as the route to run."""
    return KERNEL_ROUTE.get(arch, impl) if impl == "flash" else impl


def _jax_steps(arch):
    """Jitted reference prefill (each route) and decode for ``arch``."""
    if arch not in _JAX_STEPS:
        cfg = JARCHS[arch].reduced()
        _JAX_STEPS[arch] = {
            impl: jax.jit(lambda p, b, impl=impl: jtfm.forward_prefill(
                p, cfg, b, CACHE_LEN, impl=impl))
            for impl in ("reference", "flash", "flash_moe")}
        _JAX_STEPS[arch]["decode"] = jax.jit(
            lambda p, t, c, pos: jtfm.forward_decode(p, cfg, t, c, pos))
    return _JAX_STEPS[arch]


@pytest.fixture(scope="module", params=ARCH_IDS)
def models(request):
    arch = request.param
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    params, _ = split_tree(jtfm.init_model(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(np.asarray, params)
    model = convert.from_reference(tcfg, params, device="cpu")
    return types.SimpleNamespace(arch=arch, jcfg=jcfg, tcfg=tcfg,
                                 params=params, model=model)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=tol, atol=tol)


def _assert_caches_match(cfg, tcaches, jcaches):
    jlayers = list(convert.unstack_segments(
        cfg, jax.tree.map(np.asarray, jcaches)))
    assert len(jlayers) == len(tcaches)
    for (kind, jc), tc in zip(jlayers, tcaches):
        if isinstance(tc, KVCache):
            assert kind in ("attn", "local", "moe", "dense0")
            _close(tc.k, jc.k)
            _close(tc.v, jc.v)
            assert tc.length == int(jc.length)
        elif isinstance(tc, RwkvState):
            assert kind == "rwkv"
            _close(tc.wkv, jc.wkv)
            _close(tc.x_prev_t, jc.x_prev_t)
            _close(tc.x_prev_c, jc.x_prev_c)
        else:
            assert kind == "rec"
            _close(tc.h, jc.h)
            _close(tc.conv, jc.conv)


def test_converter_keeps_layers_and_parameters(models):
    n_ref = sum(a.size for a in jax.tree.leaves(models.params))
    assert ttfm.param_count(models.model) == n_ref
    assert [layer.kind for layer in models.model.layers] \
        == ttfm.layer_kinds(models.tcfg)
    kinds = models.tcfg.layer_kinds()
    dense = models.tcfg.moe.first_k_dense if models.tcfg.moe else 0
    assert ttfm.layer_kinds(models.tcfg) == ["dense0"] * dense \
        + kinds[dense:]
    assert ttfm.compute_segments(models.tcfg) \
        == jtfm.compute_segments(models.jcfg)
    # Empty decode caches: the reference's, unstacked, shape for shape.
    jcaches = jtfm.init_cache(models.jcfg, B, CACHE_LEN, jnp.float32)
    tcaches = ttfm.init_cache(models.tcfg, B, CACHE_LEN, torch.float32,
                               device="cpu")
    for (_, jc), tc in zip(convert.unstack_segments(
            models.jcfg, jax.tree.map(np.asarray, jcaches)), tcaches):
        for jt, tt in zip(jc, tc):
            if isinstance(tt, torch.Tensor):
                assert tuple(tt.shape) == jt.shape
                assert not tt.any()
            else:
                assert tt == int(jt) == 0


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_prefill_and_greedy_decode_match_reference(models, impl):
    impl = _route(models.arch, impl)
    steps = _jax_steps(models.arch)
    toks = _tokens()
    jlogits, jcaches = steps[impl](models.params,
                                   {"tokens": jnp.asarray(toks)})
    tlogits, tcaches = ttfm.forward_prefill(
        models.model, models.tcfg, {"tokens": torch.from_numpy(toks)},
        CACHE_LEN, impl=impl)
    assert tlogits.shape == (B, models.tcfg.vocab_size)
    assert tlogits.dtype == torch.float32
    _close(tlogits, jlogits)
    _assert_caches_match(models.jcfg, tcaches, jcaches)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, -1).to(torch.int32)
    for t in range(DECODE_STEPS):
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcaches = steps["decode"](models.params, jtok[:, None],
                                           jcaches,
                                           jnp.asarray(S + t, jnp.int32))
        tlogits, tcaches = ttfm.forward_decode(models.model, models.tcfg,
                                               ttok[:, None], tcaches, S + t)
        _close(tlogits, jlogits)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, -1).to(torch.int32)
    _assert_caches_match(models.jcfg, tcaches, jcaches)


def _jax_serve(arch, params, cfg, requests, batch_size, max_prompt):
    """The reference's ``ServingEngine.serve`` loop, driven by hand with
    the single-device forward (its mesh-bound steps fail under jax 0.9)."""
    steps = _jax_steps(arch)
    done = []
    queue = list(requests)
    while queue:
        batch, queue = queue[:batch_size], queue[batch_size:]
        toks = np.zeros((batch_size, max_prompt), np.int32)
        for i, r in enumerate(batch):
            p = r.prompt[-max_prompt:]
            toks[i, :len(p)] = p
        logits, caches = steps["reference"](params,
                                            {"tokens": jnp.asarray(toks)})
        outs = [list() for _ in batch]
        next_tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        max_new = max(r.max_new_tokens for r in batch)
        for t in range(max_new):
            for i in range(len(batch)):
                outs[i].append(int(next_tok[i]))
            logits, caches = steps["decode"](
                params, next_tok[:, None], caches,
                jnp.asarray(max_prompt + t, jnp.int32))
            next_tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        for i, r in enumerate(batch):
            done.append(np.asarray(outs[i][: r.max_new_tokens]))
    return done


def _requests(vocab):
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate([(24, 4), (9, 6), (30, 3)])]


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_serving_engine_matches_hand_driven_reference(models, impl):
    impl = _route(models.arch, impl)
    eng = ServingEngine(models.tcfg, batch_size=B, max_prompt=S,
                        max_len=CACHE_LEN, impl=impl, device="cpu")
    eng.model = models.model               # the reference's weights
    want = _jax_serve(models.arch, models.params, models.jcfg,
                      _requests(models.tcfg.vocab_size), B, S)
    done = eng.serve(_requests(models.tcfg.vocab_size))
    assert [r.request_id for r in done] == [0, 1, 2]
    for r, w in zip(done, want):
        assert r.completion.tolist() == w.tolist()
        assert r.latency_s > 0
    assert eng.step_count == 6 + 3


def test_cost_report_matches_reference_arithmetic():
    cfg = TARCHS["internlm2-1.8b"].reduced()
    eng = ServingEngine(cfg, batch_size=2, max_prompt=8, max_len=16,
                        device="cpu")
    ref_self = types.SimpleNamespace(
        mesh=types.SimpleNamespace(devices=np.empty((1, 1), object)))
    for wall, n in ((1.0, 3), (12.5, 8), (0.25, 0)):
        assert eng.cost_report(wall, n) \
            == jengine.ServingEngine.cost_report(ref_self, wall, n)


def test_serving_engine_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TARCHS["recurrentgemma-2b"].reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, batch_size=2, max_prompt=8, max_len=16)


def test_converter_and_cache_default_device_needs_a_card(models,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_reference(models.tcfg, models.params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttfm.init_cache(models.tcfg, B, CACHE_LEN, torch.float32)


@pytest.mark.parametrize("impl", ["reference", "flash_moe"])
def test_qwen3_moe_prefill_matches_reference(impl):
    """Renormalized top-k gates (``norm_topk``), 4:1 GQA, no shared
    experts: last-token logits and caches within 1e-4."""
    arch = "qwen3-moe-235b-a22b"
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    assert tcfg.moe.norm_topk
    params, _ = split_tree(jtfm.init_model(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(np.asarray, params)
    model = convert.from_reference(tcfg, params, device="cpu")
    toks = _tokens()
    jlogits, jcaches = _jax_steps(arch)[impl](params,
                                              {"tokens": jnp.asarray(toks)})
    tlogits, tcaches = ttfm.forward_prefill(
        model, tcfg, {"tokens": torch.from_numpy(toks)}, CACHE_LEN,
        impl=impl)
    _close(tlogits, jlogits)
    _assert_caches_match(jcfg, tcaches, jcaches)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b"])
def test_serving_engine_serves_new_layer_kinds_on_cpu(arch):
    """The full engine on its own random weights: bf16 activations, as on
    the card, every route; completions in the vocabulary."""
    cfg = dataclasses.replace(TARCHS[arch].reduced(), dtype="bfloat16")
    for impl in ("reference", _route(arch, "flash")):
        eng = ServingEngine(cfg, batch_size=2, max_prompt=8, max_len=16,
                            impl=impl, device="cpu")
        done = eng.serve(_requests(cfg.vocab_size)[:2])
        for r in done:
            assert r.completion.shape == (r.max_new_tokens,)
            assert 0 <= r.completion.min() and r.completion.max() < 256


def test_serve_launcher_on_cpu(capsys):
    tserve_launch.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                        "--requests", "3", "--max-new-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:3]] == ["req 0", "req 1",
                                                    "req 2"]
    assert "'chips': 1" in out[-1]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "deepseek-moe-16b"])
def test_serve_launcher_serves_new_layer_kinds_on_cpu(arch, capsys):
    tserve_launch.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                        "--max-new-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:2]] == ["req 0", "req 1"]
    assert "'chips': 1" in out[-1]
