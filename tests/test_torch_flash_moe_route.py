"""The attention of ``impl="flash_moe"``: the flash-attention kernel.

``attention`` and ``attention_prefill`` under ``impl="flash_moe"`` (the
MoE models' kernel route) call ``kernels.flash_attention.flash_attention``
once each, as ``impl="flash"`` does (a spy counts the calls), and agree
with the reference route, ``_sdpa``: at DeepSeekMoE-16B's head layout
(as many KV heads as query heads, head dim 128) and at Qwen3-MoE's
grouping (16 query heads a KV head), causal, at ragged lengths. On the
CPU the wrapper runs its plain version. Tolerances: float32 1e-5,
bfloat16 2e-2 (one bf16 rounding of the output, as the port's bf16
kernel tests hold).

On a CUDA card, the kernel itself at DeepSeekMoE's layout in bf16 against
``_sdpa``, each call one launch on the tensor-core route; without a card
that test skips. No JAX here: run the file on the card with
``python -m pytest -q tests/test_torch_flash_moe_route.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models.common import split_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (query heads, KV heads), head dim 128: DeepSeekMoE-16B's MHA and
# Qwen3-MoE-235B's grouping of 64 query heads over 4 KV heads.
LAYOUTS = {"deepseek_mha": (4, 4), "qwen3_gqa": (32, 2)}
B, D_MODEL, HEAD_DIM, CACHE_LEN = 2, 64, 128, 80


def _inputs(layout, s, dtype):
    h, hkv = LAYOUTS[layout]
    cfg = dataclasses.replace(ARCHS["deepseek-moe-16b"].reduced(),
                              d_model=D_MODEL, num_heads=h, num_kv_heads=hkv,
                              head_dim=HEAD_DIM)
    gen = torch.Generator().manual_seed(s)
    params, _ = split_tree(tattn.init_attention(gen, cfg))
    params = {k: v.to(dtype) for k, v in params.items()}
    x = torch.randn((B, s, D_MODEL), generator=gen).to(dtype)
    positions = torch.arange(s, dtype=torch.int32).expand(B, s)
    return cfg, params, x, positions


@pytest.fixture
def flash_calls(monkeypatch):
    """The calls that reach ``flash_attention``: (q's shape, keywords)."""
    calls, real = [], tfa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("s", [37, 64])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("fn", ["attention", "attention_prefill"])
def test_flash_moe_attention_runs_the_flash_kernel(flash_calls, fn, layout,
                                                   s, dtype):
    cfg, params, x, positions = _inputs(layout, s, dtype)
    kw = {"cache_len": CACHE_LEN} if fn == "attention_prefill" else {}
    run = getattr(tattn, fn)
    got = run(params, x, cfg, positions, impl="flash_moe", **kw)
    h, _ = LAYOUTS[layout]
    assert flash_calls == [((B, s, h, HEAD_DIM),
                            {"causal": True, "window": 0})]
    want = run(params, x, cfg, positions, impl="reference", **kw)
    assert len(flash_calls) == 1          # the reference route is _sdpa
    if fn == "attention_prefill":
        (got, got_cache), (want, want_cache) = got, want
        assert got_cache.length == want_cache.length == s
        assert torch.equal(got_cache.k, want_cache.k)
        assert torch.equal(got_cache.v, want_cache.v)
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("s", [1024, 333])
def test_flash_kernel_at_deepseek_layout_on_the_card(s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wgmma flash kernel runs only "
                    "on an H100")
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn((2, s, 16, 128), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    assert tfa._route(q.dtype, q.shape[-1]) == "tc"
    n0, tc0 = tfa.FLASH_ATTENTION_LAUNCHES, tfa.FLASH_ATTENTION_TC_LAUNCHES
    got = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.FLASH_ATTENTION_LAUNCHES == n0 + 1
    assert tfa.FLASH_ATTENTION_TC_LAUNCHES == tc0 + 1
    want = tattn._sdpa(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
