"""The tensor-core flash-attention kernel's arithmetic, on the CPU.

``csrc/flash_attention_wgmma.cu`` runs only on an H100, so this file holds
a plain-PyTorch emulation of its arithmetic: 128-row query blocks in two
64-row warpgroups, 64-key tiles over the block's band (tiles wholly
outside a warpgroup's band skipped), the online softmax in float32 in
base 2 (unscaled scores, the scale folded into the exponent's FMA), P
split into bf16 hi and lo halves for the two P V products, the
row sum from the unrounded p, and one rounding of the output to bf16.
It is held against the JAX package's float32 oracle
(``repro.kernels.ref.flash_attention_ref``) and, for fully masked rows,
the Pallas kernel in interpret mode.

Tolerance: the bf16 result within one bf16 rounding of the float32 result
(2^-8 of its size) plus 1e-4, the bound ``chip_smoke.check_flash_f32``
holds the kernel to on the card. Rounding P once to bf16 instead must
break that bound: that is why the kernel splits P.

``_route`` (which of the three kernels a call takes on the card) is a
pure function of dtype and head dim, tested here too. Inputs are made with numpy from a
seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_hmajor
from repro_torch.kernels import flash_attention as tfa

torch.backends.cuda.matmul.allow_tf32 = False

BQ, WG_ROWS, BK = 128, 64, 64           # the kernel's block and tiles
NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634
BF16_ROUND = 2.0 ** -8
F32_ATTN_TOL = 1e-4


def _fma(x, scale, mu):
    """x * scale - mu rounded once to float32, as the kernel's FFMA."""
    return (x.double() * scale.double() - mu.double()).float()


def emulate(q, k, v, *, causal, window, split=True):
    """The tensor-core kernel's arithmetic on bf16 q (B, Sq, H, D), k and v
    (B, Skv, Hkv, D); bf16 out. ``split`` False rounds P once to bf16."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.zeros((b, sq, h, d), dtype=torch.bfloat16)
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, :, hi // group].float(), v[bi, :, hi // group].float()
            for q0 in range(0, sq, BQ):
                q_last = min(q0 + BQ, sq) - 1
                k_end = min(skv, q_last + 1) if causal else skv
                k_first = (max(0, q0 - window + 1) if window > 0 else 0) \
                    // BK * BK
                for qa in (q0, q0 + WG_ROWS):
                    rows = torch.arange(qa, qa + WG_ROWS)
                    qt = torch.zeros((WG_ROWS, d))
                    n = max(0, min(sq, qa + WG_ROWS) - qa)
                    qt[:n] = q[bi, qa:qa + n, hi].float()
                    m = torch.full((WG_ROWS,), NEG_INF)
                    l = torch.zeros(WG_ROWS)
                    acc = torch.zeros((WG_ROWS, d))
                    for k0 in range(k_first, k_end, BK):
                        if (causal and k0 > qa + WG_ROWS - 1) or (
                                window > 0 and k0 + BK - 1 <= qa - window):
                            continue            # wholly outside the band
                        kt = torch.zeros((BK, d))
                        vt = torch.zeros((BK, d))
                        nk = min(skv, k0 + BK) - k0
                        kt[:nk], vt[:nk] = kh[k0:k0 + nk], vh[k0:k0 + nk]
                        s = qt @ kt.T           # unscaled, as the kernel
                        keys = torch.arange(k0, k0 + BK)[None, :]
                        ok = keys < skv
                        if causal:
                            ok = ok & (keys <= rows[:, None])
                        if window > 0:
                            ok = ok & (keys > rows[:, None] - window)
                        s = torch.where(ok, s, torch.tensor(NEG_INF))
                        mx = torch.maximum(m, s.max(dim=1).values)
                        # The guard: where no key of the row is in the
                        # band yet, subtracting -NEG_INF gives exp2 -> 0.
                        mu = torch.where(mx > NEG_INF * 0.5, mx * scale_log2,
                                         torch.tensor(-NEG_INF))
                        alpha = torch.exp2(_fma(m, scale_log2, mu))
                        p = torch.exp2(_fma(s, scale_log2, mu[:, None]))
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None]
                        p_hi = p.to(torch.bfloat16).float()
                        acc = acc + p_hi @ vt
                        if split:
                            p_lo = (p - p_hi).to(torch.bfloat16).float()
                            acc = acc + p_lo @ vt
                        m = mx
                    o = acc / l.clamp_min(1e-20)[:, None]
                    out[bi, qa:qa + n, hi] = o[:n].to(torch.bfloat16)
    return out


def _qkv(rng, b, sq, skv, h, hkv, d):
    """bf16 tensors for the emulation and their exact float32 values."""
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return t, [x.float().numpy() for x in t]


def _excess(got, want):
    """How far |got - want| goes beyond one bf16 rounding of ``want``."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    return float((err - BF16_ROUND * np.abs(want)).max())


# (B, S, H, Hkv, D, causal, window): a RecurrentGemma-like layer (GQA 4:1,
# D = 256, a sliding window) cut to a few hundred positions, and a ragged
# causal case (no tile multiple) at D = 128.
CASES = {"recurrentgemma_like": (1, 384, 4, 1, 256, True, 160),
         "ragged_causal": (1, 300, 4, 2, 128, True, 0)}


def _reference(case, rng):
    b, s, h, hkv, d, causal, window = CASES[case]
    (q, k, v), (nq, nk, nv) = _qkv(rng, b, s, s, h, hkv, d)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(nq), jnp.asarray(nk), jnp.asarray(nv), causal=causal,
        window=window))
    return (q, k, v, causal, window), want


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_p_within_one_bf16_rounding(rng, case):
    (q, k, v, causal, window), want = _reference(case, rng)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _excess(got, want) <= F32_ATTN_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_p_rounded_once_breaks_the_bound(rng, case):
    """One rounding of P to bf16 (as FlashAttention-2/3 do) leaves the
    output beyond the bound the split keeps."""
    (q, k, v, causal, window), want = _reference(case, rng)
    once = emulate(q, k, v, causal=causal, window=window, split=False)
    assert _excess(once, want) > F32_ATTN_TOL


def test_fully_masked_rows_give_zero(rng):
    """Queries 40..63 see no key (a window of 8 past the last of 32 keys):
    0 there, as the Pallas kernel's guard and denominator floor give."""
    (q, k, v), (nq, nk, nv) = _qkv(rng, 1, 64, 32, 4, 2, 64)
    want = np.asarray(flash_attention_hmajor(
        jnp.asarray(nq).transpose(0, 2, 1, 3),
        jnp.asarray(nk).transpose(0, 2, 1, 3),
        jnp.asarray(nv).transpose(0, 2, 1, 3), causal=False, window=8,
        block_q=32, block_k=32, interpret=True).transpose(0, 2, 1, 3))
    got = emulate(q, k, v, causal=False, window=8)
    assert not got[:, 40:].float().any()
    assert bool(got[:, :39].float().abs().amax(dim=-1).gt(0).all())
    assert _excess(got, want) <= F32_ATTN_TOL


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 80, "mma"),       # StableLM-3B: the mma.sync route
    (torch.bfloat16, 32, "mma"), (torch.bfloat16, 6, "mma"),
    (torch.bfloat16, 36, "mma"), (torch.bfloat16, 96, "mma"),
    (torch.bfloat16, 320, "fma"),      # over 256: the CUDA-core route
    (torch.float32, 80, "fma")])
def test_route_by_dtype_and_head_dim(dtype, d, route):
    assert tfa._route(dtype, d) == route
