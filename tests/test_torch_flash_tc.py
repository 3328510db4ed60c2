"""The tensor-core flash-attention kernel's arithmetic, on the CPU.

``csrc/flash_attention_wgmma.cu`` runs only on an H100, so this file holds
a plain-PyTorch emulation of its arithmetic: 128-row query blocks in two
64-row warpgroups, 64-key tiles over the block's band (tiles wholly
outside a warpgroup's band skipped), the head dim in 64-column chunks
with its tail past a multiple of 64 zero-filled (S summing the tail's
16-column k-steps of real columns only), the online softmax in float32
in base 2 (unscaled scores, the scale folded into the exponent's FMA), P
split into bf16 hi and lo halves for the two P V products, the row sum
from the unrounded p, and one rounding of the output to bf16. It is held
against the JAX package's float32 oracle
(``repro.kernels.ref.flash_attention_ref``) and the Pallas kernel in
interpret mode, at D = 16, 48, 80, 96 and 208 (tails of 16, 48, 16, 32
and 16 columns) beside 128 and 256: MHA and GQA, causal, windowed and
full, ragged Skv, Sq != Skv.

Tolerance: the bf16 result within one bf16 rounding of the float32 result
(2^-8 of its size) plus 1e-4, the bound ``chip_smoke.check_flash_f32``
holds the kernel to on the card. Rounding P once to bf16 instead must
break that bound: that is why the kernel splits P; so must S without the
tail's last k-step.

``_route`` (which of the three kernels a call takes on the card) is a
pure function of dtype and head dim, tested here too. Inputs are made with numpy from a
seed.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_hmajor
from repro_torch.kernels import flash_attention as tfa

torch.backends.cuda.matmul.allow_tf32 = False

SOURCE = (pathlib.Path(tfa.__file__).resolve().parents[1] / "csrc"
          / "flash_attention_wgmma.cu").read_text()
# The head dims the kernel has an instance for.
INSTANCES = [int(x) for x in re.findall(r"REPRO_FLASH_WGMMA\((\d+)\)",
                                        SOURCE)]
BQ, WG_ROWS, BK = 128, 64, 64           # the kernel's block and tiles
CHUNK, K_STEP = 64, 16                  # D columns a chunk and an S k-step
NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634
BF16_ROUND = 2.0 ** -8
F32_ATTN_TOL = 1e-4


def _fma(x, scale, mu):
    """x * scale - mu rounded once to float32, as the kernel's FFMA."""
    return (x.double() * scale.double() - mu.double()).float()


def s_columns(d: int, drop_tail_step: bool = False) -> torch.Tensor:
    """The head-dim columns S sums over: every real one (the tail chunk's
    k-steps cover its real columns, the zeros past D none). With
    ``drop_tail_step``, the tail's last 16-column k-step left out."""
    keep = torch.ones(d, dtype=torch.bool)
    if drop_tail_step:
        assert d % CHUNK, "no tail"
        keep[d - K_STEP:] = False
    return keep


def emulate(q, k, v, *, causal, window, split=True, drop_tail_step=False,
            scale=None):
    """The tensor-core kernel's arithmetic on bf16 q (B, Sq, H, D), k and v
    (B, Skv, Hkv, D); bf16 out. ``split`` False rounds P once to bf16;
    ``drop_tail_step`` runs S without the tail's last k-step; ``scale``
    multiplies the scores (1/sqrt(D) by default), rounded to float32 and
    times log2(e) in float32 as the kernel's host wrapper does."""
    b, sq, h, d = q.shape
    assert d in INSTANCES
    dp = -(-d // CHUNK) * CHUNK        # the padded width of Q and K tiles
    cols = torch.zeros(dp, dtype=torch.bool)
    cols[:d] = s_columns(d, drop_tail_step)
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale_log2 = torch.tensor(1.0 / math.sqrt(d) if scale is None
                              else scale, dtype=torch.float32) \
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
                    # Q and K tiles dp wide, zero past D (TMA's fill).
                    qt = torch.zeros((WG_ROWS, dp))
                    n = max(0, min(sq, qa + WG_ROWS) - qa)
                    qt[:n, :d] = q[bi, qa:qa + n, hi].float()
                    m = torch.full((WG_ROWS,), NEG_INF)
                    l = torch.zeros(WG_ROWS)
                    acc = torch.zeros((WG_ROWS, d))
                    for k0 in range(k_first, k_end, BK):
                        if (causal and k0 > qa + WG_ROWS - 1) or (
                                window > 0 and k0 + BK - 1 <= qa - window):
                            continue            # wholly outside the band
                        kt = torch.zeros((BK, dp))
                        vt = torch.zeros((BK, d))
                        nk = min(skv, k0 + BK) - k0
                        kt[:nk, :d] = kh[k0:k0 + nk]
                        vt[:nk] = vh[k0:k0 + nk]
                        # Unscaled, as the kernel; its k-steps' columns.
                        s = qt[:, cols] @ kt[:, cols].T
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


def _pallas(nq, nk, nv, causal, window):
    """The Pallas kernel in interpret mode, one block over each axis (it
    needs Sq and Skv to be whole numbers of its blocks)."""
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    return np.asarray(flash_attention_hmajor(
        tr(nq), tr(nk), tr(nv), causal=causal, window=window,
        block_q=nq.shape[1], block_k=nk.shape[1],
        interpret=True).transpose(0, 2, 1, 3))


# (B, Sq, Skv, H, Hkv, D, causal, window): a RecurrentGemma-like layer
# (GQA 4:1, D = 256, a sliding window) cut to a few hundred positions, a
# ragged causal case (no tile multiple) at D = 128, and head dims with a
# tail past a multiple of 64 (16, 48, 80 = StableLM-3B's, 96, 208), MHA
# and GQA, causal, windowed and full, Skv ragged and unequal to Sq.
CASES = {"recurrentgemma_like": (1, 384, 384, 4, 1, 256, True, 160),
         "ragged_causal": (1, 300, 300, 4, 2, 128, True, 0),
         "d16_gqa_causal": (1, 130, 130, 4, 2, 16, True, 0),
         "d48_mha_window_skv_long": (1, 150, 171, 3, 3, 48, True, 40),
         "d80_mha_causal": (1, 200, 200, 4, 4, 80, True, 0),
         "d80_gqa_window_ragged": (1, 90, 121, 4, 1, 80, True, 33),
         "d96_gqa_full_ragged": (2, 70, 90, 4, 2, 96, False, 0),
         "d208_gqa_window_skv_short": (1, 160, 139, 4, 2, 208, False, 50)}
# The cases where one rounding of P must show (a few hundred keys).
ROUNDED_ONCE = ("ragged_causal", "recurrentgemma_like")


def _reference(case, rng):
    b, sq, skv, h, hkv, d, causal, window = CASES[case]
    (q, k, v), (nq, nk, nv) = _qkv(rng, b, sq, skv, h, hkv, d)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(nq), jnp.asarray(nk), jnp.asarray(nv), causal=causal,
        window=window))
    return (q, k, v, causal, window), want, (nq, nk, nv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_p_within_one_bf16_rounding(rng, case):
    (q, k, v, causal, window), want, _ = _reference(case, rng)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _excess(got, want) <= F32_ATTN_TOL


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c not in ROUNDED_ONCE))
def test_tail_within_one_bf16_rounding_of_pallas(rng, case):
    """The head dims with a tail against the Pallas kernel in interpret
    mode, on the bf16 inputs' exact float32 values."""
    (q, k, v, causal, window), _, (nq, nk, nv) = _reference(case, rng)
    want = _pallas(nq, nk, nv, causal, window)
    got = emulate(q, k, v, causal=causal, window=window)
    assert _excess(got, want) <= F32_ATTN_TOL


@pytest.mark.parametrize("case", ["d80_mha_causal", "d48_mha_window_skv_long",
                                  "d208_gqa_window_skv_short"])
def test_tail_step_dropped_breaks_the_bound(rng, case):
    """S without the tail's last 16-column k-step (a kernel that ran only
    the full chunks' steps, at D = 80 and 208) leaves the output beyond
    the bound."""
    (q, k, v, causal, window), want, _ = _reference(case, rng)
    got = emulate(q, k, v, causal=causal, window=window,
                  drop_tail_step=True)
    assert _excess(got, want) > F32_ATTN_TOL


def test_mla_shape_with_its_scale_and_zero_filled_values(rng):
    """DeepSeek-V2-Lite's prefill launch cut to 160 positions and 4
    heads: q and k of 192 dims, v of 128 zero-filled to 192, the YaRN
    softmax scale. Within one bf16 rounding of the float32 oracle (run on
    q times scale * sqrt(192), which its 1/sqrt(192) turns into the
    scale); the zero-filled columns exactly 0; the default scale (the
    YaRN mscale dropped) beyond the bound."""
    from repro_torch.models import mla
    from repro_torch.configs.registry import ARCHS
    scale = mla.softmax_scale(ARCHS["deepseek-v2-lite"])
    (q, k, v), (nq, nk, nv) = _qkv(rng, 1, 160, 160, 4, 4, 192)
    v[..., 128:] = 0
    nv = v.float().numpy()
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(nq * np.float32(scale * math.sqrt(192))),
        jnp.asarray(nk), jnp.asarray(nv), causal=True))
    got = emulate(q, k, v, causal=True, window=0, scale=scale)
    assert not got[..., 128:].float().any()
    assert _excess(got, want) <= F32_ATTN_TOL
    unscaled = emulate(q, k, v, causal=True, window=0)
    assert _excess(unscaled, want) > F32_ATTN_TOL


def test_instances_cover_every_multiple_of_16():
    """One instance for every bf16 head dim the tc route takes."""
    assert INSTANCES == list(range(16, tfa.TC_MAX_HEAD_DIM + 1, 16))
    assert [d for d in range(1, 400) if tfa._route(torch.bfloat16, d)
            == "tc"] == INSTANCES


@pytest.mark.parametrize("case", ROUNDED_ONCE)
def test_p_rounded_once_breaks_the_bound(rng, case):
    """One rounding of P to bf16 (as FlashAttention-2/3 do) leaves the
    output beyond the bound the split keeps."""
    (q, k, v, causal, window), want, _ = _reference(case, rng)
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
    (torch.bfloat16, 80, "tc"),        # StableLM-3B: a 16-column tail
    (torch.bfloat16, 32, "tc"), (torch.bfloat16, 6, "mma"),
    (torch.bfloat16, 36, "mma"), (torch.bfloat16, 96, "tc"),
    (torch.bfloat16, 37, "mma"),       # no multiple of 16: mma.sync
    (torch.bfloat16, 200, "mma"),
    (torch.bfloat16, 320, "fma"),      # over 256: the CUDA-core route
    (torch.float32, 80, "fma")])
def test_route_by_dtype_and_head_dim(dtype, d, route):
    assert tfa._route(dtype, d) == route
