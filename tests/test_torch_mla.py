"""Multi-head latent attention (``repro_torch.models.mla``) on the CPU:
YaRN against the published formula, the absorbed decode against the
decompressed attention of the same step, the zero-filled values against
attention at the value width, one flash call a layer in the prefill, the
``mla.*`` spans and the ``mla.cache_bytes`` counter under the profiler,
the latent cache's layout, and the training forward through autograd.
On a CUDA card also the wgmma flash kernel at the prefill's launch (D =
192, the YaRN scale, values zero-filled from 128); without a card that
test skips. No JAX here: run the file on the card with ``python -m pytest
-q tests/test_torch_mla.py``. (The port against the plain reference,
prefill and decode steps: ``chipbench/tests/test_chipbench_mla.py``.)"""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import ARCHS
from repro_torch.core import tracing
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import mla
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServingEngine

FULL = ARCHS["deepseek-v2-lite"]
SMALL = FULL.reduced()


@pytest.fixture(autouse=True)
def empty():
    tracing.clear()
    yield
    tracing.clear()


def _published_freqs(dim, base, factor, orig, beta_fast, beta_slow):
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies, its float32
    operations as the published modeling code writes them."""
    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(
        0, dim, 2, dtype=torch.float32) / dim))
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def _published_mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def test_yarn_freqs_and_scale_are_the_published():
    want = _published_freqs(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    got = common.rotary_freqs(FULL, 64)
    # The same float32 operations in the same order: equal to the bit.
    assert torch.equal(got, want)
    # The ramp: the fastest pairs extrapolated, the slowest divided by 40.
    assert float(want[0]) == 1.0
    assert float(want[-1]) == pytest.approx(10000.0 ** (-62 / 64) / 40,
                                            rel=1e-6)
    m = _published_mscale(40.0, 0.707)
    assert m ** 2 == pytest.approx(1.58963, abs=1e-5)
    assert mla.softmax_scale(FULL) == pytest.approx(192 ** -0.5 * m * m,
                                                    rel=1e-12)
    # mscale == mscale_all_dim: cos and sin unscaled.
    assert common.rotary_mscale(FULL) == 1.0


@pytest.mark.parametrize("pos", [4095, 4097, 10000, 32767, 163839])
def test_pair_rotary_past_the_original_window(pos):
    """Past the original 4,096 positions, as the published code turns q_pe
    and k_pe: the adjacent pairs permuted into split halves
    (``view(..., d // 2, 2).transpose``), then ``rotate_half`` by the
    float32 angles of ``torch.outer(t, inv_freq)``."""
    g = torch.Generator().manual_seed(pos)
    x = torch.randn(1, 1, 2, 64, generator=g)
    got = common.apply_rope_pairs(x, torch.tensor([[pos]]), FULL)
    freqs = torch.outer(torch.tensor([float(pos)]),
                        _published_freqs(64, 10000.0, 40.0, 4096, 32.0, 1.0))
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    xp = x.view(1, 1, 2, 32, 2).transpose(4, 3).reshape(1, 1, 2, 64)
    half = torch.cat([-xp[..., 32:], xp[..., :32]], -1)
    want = xp * cos + half * sin
    # The same float32 angles, cos and sin; products summed in one order
    # or the other: a float32 rounding of |x| up to ~4.
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    values, _ = common.split_tree(mla.init_mla(g, cfg))
    # A norm weight other than ones, so the norm's weight counts.
    values["kv_norm"] = 1 + 0.1 * torch.randn(cfg.kv_lora_rank, generator=g)
    return values


def test_absorbed_decode_is_the_decompressed_attention():
    cfg = SMALL
    p = _params(cfg, 1)
    g = torch.Generator().manual_seed(2)
    b, size, length = 3, 20, 13
    cache = mla.MLACache(torch.randn(b, size, cfg.kv_lora_rank, generator=g),
                         torch.randn(b, size, cfg.qk_rope_head_dim,
                                     generator=g), length)
    x = torch.randn(b, 1, cfg.d_model, generator=g)
    ckv0, kpe0 = cache.ckv.clone(), cache.kpe.clone()
    y, new = mla.mla_decode(p, x, cfg, length, cache)
    assert new.length == length + 1
    # Decompressed: every slot's per-head keys and values, then softmax
    # attention of the new token's query over the first length + 1 slots.
    pos = torch.full((b, 1), length)
    q_nope, q_pe = mla._query(p, x, cfg, pos)
    c, k_pe = mla._latent(p, x, cfg, pos)
    ckv, kpe = ckv0.clone(), kpe0.clone()
    ckv[:, length], kpe[:, length] = c[:, 0], k_pe[:, 0]
    n = length + 1
    kv = torch.einsum("bsc,chk->bshk", ckv[:, :n], p["w_kv_b"])
    k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], -1)
    k = torch.cat([k_nope, kpe[:, :n, None].expand(
        -1, -1, cfg.num_heads, -1)], -1)
    q = torch.cat([q_nope, q_pe], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * mla.softmax_scale(cfg)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    want = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    # float32 sums in another order (w_kv_b applied before or after the
    # attention): 1e-5 of the output's scale.
    tol = 1e-5 * float(want.abs().max())
    assert float((y - want).abs().max()) < tol
    # The new slot was written in place; the others were left.
    assert torch.equal(new.ckv[:, length], c[:, 0])
    assert torch.equal(new.ckv[:, :length], ckv0[:, :length])
    # A decode whose scores left out the latent's part (q_pe k_pe only)
    # is far outside that tolerance: the comparison can see a fault.
    rope_only = torch.einsum("bqhr,bkr->bhqk", q_pe, kpe[:, :n]) \
        * mla.softmax_scale(cfg)
    wrong = torch.einsum("bshk,hkd->bsd", torch.einsum(
        "bhqk,bkhd->bqhd", rope_only.softmax(-1), v), p["wo"])
    assert float((wrong - want).abs().max()) > 100 * tol


@pytest.mark.parametrize("dtype, tol", [
    # float32: the zero columns add exact zeros; the rest is the same sum.
    (torch.float32, 1e-6),
    # bf16 inputs, float32 arithmetic and one rounding of the output.
    (torch.bfloat16, 0.0)])
def test_zero_filled_values_give_the_value_width_attention(dtype, tol):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 24, 4, 192, generator=g).to(dtype)
    k = torch.randn(2, 24, 4, 192, generator=g).to(dtype)
    v = torch.randn(2, 24, 4, 128, generator=g).to(dtype)
    scale = mla.softmax_scale(FULL)
    got = mla._core(q, k, v, scale, "flash_moe")
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=scale)
    assert got.shape == want.shape == (2, 24, 4, 128)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("s", [1024, 333])
def test_flash_kernel_at_the_mla_shape_on_the_card(s):
    """The wgmma kernel at D = 192 with the YaRN scale and V zero-filled
    from 128, as the prefill launches it: one launch on the tensor-core
    route, the zero columns exactly 0, the rest within 2e-2 (one bf16
    rounding of the output, as the port's bf16 kernel tests hold) of the
    plain version at the value width; at its default scale (the YaRN
    mscale dropped) it must miss that bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wgmma flash kernel runs only "
                    "on an H100")
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k = (torch.randn((2, s, 16, 192), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    v = torch.randn((2, s, 16, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    scale = mla.softmax_scale(FULL)
    tc0 = fa.FLASH_ATTENTION_TC_LAUNCHES
    got = fa.flash_attention(q, k, F.pad(v, (0, 64)), causal=True,
                             scale=scale)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION_TC_LAUNCHES == tc0 + 1
    assert not got[..., 128:].any()
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(got[..., :128].float(), want.float(),
                               rtol=2e-2, atol=2e-2)
    unscaled = fa.flash_attention(q, k, F.pad(v, (0, 64)), causal=True)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(unscaled[..., :128].float(),
                                   want.float(), rtol=2e-2, atol=2e-2)


def test_prefill_is_one_flash_call_a_layer_and_no_sdpa(monkeypatch):
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return real(q, k, v, **kw)

    def refuse(*a, **k):
        raise AssertionError("_sdpa in an MLA prefill")
    monkeypatch.setattr(fa, "flash_attention", spy)
    monkeypatch.setattr(attn_mod, "_sdpa", refuse)
    cfg = SMALL
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 10))
    _, caches = tfm.forward_prefill(model, cfg, {"tokens": toks}, 12,
                                    impl="flash_moe")
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert len(calls) == cfg.num_layers
    # At the published width the card takes the wgmma kernel.
    assert fa._route(torch.bfloat16, 128 + 64) == "tc"
    for qs, ks, vs, kw in calls:
        assert qs == ks == vs == (2, 10, cfg.num_heads, dqk)
        assert kw == {"causal": True, "scale": mla.softmax_scale(cfg)}
    for c in caches:
        assert isinstance(c, mla.MLACache) and c.length == 10
        assert c.ckv.shape == (2, 12, cfg.kv_lora_rank)
        assert c.kpe.shape == (2, 12, cfg.qk_rope_head_dim)
        assert not c.ckv[:, 10:].any() and c.ckv[:, :10].any()


def test_spans_and_cache_bytes_under_the_profiler():
    # The published latent and rotary widths (576 values a token a layer)
    # in bf16, everything else small.
    cfg = dataclasses.replace(SMALL, dtype="bfloat16", kv_lora_rank=512,
                              qk_rope_head_dim=64, head_dim=80)
    b, s, new = 2, 12, 3
    engine = ServingEngine(cfg, b, s, s + new, impl="flash_moe",
                           device="cpu")
    reqs = [Request(i, np.arange(s, dtype=np.int32) + i, max_new_tokens=new)
            for i in range(b)]
    with profile(activities=[ProfilerActivity.CPU]):
        engine.serve(reqs)
    rows, got = tracing.records(), tracing.counters()
    layers = cfg.num_layers
    steps = {}
    for (step, name), n in got.items():
        if name == "mla.cache_bytes":
            steps.setdefault(rows[step].name, []).append(n)
    assert steps["serve.prefill"] == [b * s * 576 * 2 * layers]
    assert steps["serve.decode"] == [b * 1 * 576 * 2 * layers] * new
    by_step = {}
    for r in rows:
        if r.name.startswith("mla."):
            assert rows[r.parent].name == "model.attention", r.name
            by_step.setdefault(rows[r.step].name, []).append(r.name)
    pre, dec = by_step["serve.prefill"], by_step["serve.decode"]
    for name in ("mla.kv_down", "mla.kv_up", "mla.core"):
        assert pre.count(name) == layers
    assert "mla.absorb" not in pre and "mla.kv_up" not in dec
    assert dec.count("mla.core") == layers * new
    assert dec.count("mla.absorb") == 2 * layers * new
    assert dec.count("mla.kv_down") == layers * new


def test_init_cache_and_layouts_are_latent():
    cfg = SMALL
    caches = tfm.init_cache(cfg, 3, 40, torch.bfloat16, device="cpu")
    assert len(caches) == cfg.num_layers
    for c in caches:
        assert isinstance(c, mla.MLACache) and c.length == 0
        assert c.ckv.shape == (3, 40, cfg.kv_lora_rank)
        assert c.kpe.shape == (3, 40, cfg.qk_rope_head_dim)
        assert c.ckv.dtype == torch.bfloat16
    axes = tfm.param_axes(cfg)
    assert axes["layers.0.attn.wq"] == ("embed", "heads", "head_dim")
    assert axes["layers.0.attn.w_kv_a"] == ("embed", None)
    assert axes["layers.0.attn.kv_norm"] == (None,)
    assert axes["layers.0.attn.w_kv_b"] == (None, "heads", "head_dim")
    assert axes["layers.0.attn.wo"] == ("heads", "head_dim", "embed")
    assert not any(".wk" in k or ".wv" in k for k in axes)


def test_cache_layout_on_a_mesh_splits_only_the_batch():
    from repro_torch.launch import steps

    class FakeMesh:
        axis_names = ("data", "model")

        class devices:
            shape = (2, 4)
    caches = tfm.init_cache(SMALL, 8, 16, torch.float32, device="cpu")
    specs = steps.cache_shardings(caches, FakeMesh())
    assert specs[0] == mla.MLACache(("data", None, None),
                                    ("data", None, None), ())


def test_training_forward_runs_through_autograd():
    cfg = SMALL
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    for prm in model.parameters():
        prm.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = tfm.forward_train(model, cfg, batch)
    loss.backward()
    grads = dict(model.named_parameters())
    for name in ("attn.wq", "attn.w_kv_a", "attn.kv_norm", "attn.w_kv_b",
                 "attn.wo"):
        grad = grads[f"layers.1.{name}"].grad
        assert grad is not None and torch.isfinite(grad).all() \
            and grad.abs().sum() > 0, name
    # Training runs the prefill's function: one layer in either mode.
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    pos = torch.arange(8)[None].expand(2, 8)
    with torch.no_grad():
        train, _, _ = tfm._apply_layer(model.layers[1], x, cfg, pos,
                                       impl="reference", mode="train")
        prefill, _, _ = tfm._apply_layer(model.layers[1], x, cfg, pos,
                                         impl="reference", mode="prefill",
                                         cache_len=8)
    assert torch.equal(train, prefill)
