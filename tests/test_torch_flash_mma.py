"""The mma.sync flash-attention kernel's arithmetic, on the CPU.

``csrc/flash_attention_mma.cu`` (bf16 at head dims up to 256 that are no
multiple of 16; the others take the wgmma kernel, but this one still
takes them when named) runs only on an H100, so this file holds a
plain-PyTorch emulation of its arithmetic: the head dim zero-filled to
the kernel's padded width DP, 64-row query blocks of four 16-row warps,
KV tiles of 64 keys (16 above DP = 192) over the block's band (tiles
wholly outside a warp's band skipped), the online softmax in float32 in
base 2 (unscaled scores, the scale folded into the exponent's FMA), P
split into bf16 hi and lo halves for the two P V products, the row sum
from the unrounded p, and one rounding of the output to bf16. DP and the tile width are
read out of the ``.cu``. The emulation is held against the Pallas kernel
in interpret mode (``flash_attention_hmajor``, on the bf16 inputs' exact
float32 values) at D = 16, 36, 80 and 96, causal and windowed, GQA and
MHA, with ragged Sq and Skv.

Tolerance: the bf16 result within one bf16 rounding of the float32 result
(2^-8 of its size) plus 1e-4, the bound ``chip_smoke.check_flash_f32``
holds the kernel to on the card (as for the wgmma kernel,
``tests/test_torch_flash_tc.py``). The wrapper's card path (route,
copy width, the checks that raise) is tested here too. Inputs are made
with numpy from a seed.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention import flash_attention_hmajor
from repro_torch.kernels import flash_attention as tfa

torch.backends.cuda.matmul.allow_tf32 = False

SOURCE = (pathlib.Path(tfa.__file__).resolve().parents[1] / "csrc"
          / "flash_attention_mma.cu").read_text()
BQ, WARP_ROWS = 64, 16                  # the kernel's block and warp rows
NEG_INF = -2.3819763e38
LOG2E = 1.4426950408889634
BF16_ROUND = 2.0 ** -8
F32_ATTN_TOL = 1e-4

# The padded widths the kernel has an instance for, and its tile width.
DPS = [int(x) for x in re.findall(r"REPRO_FLASH_MMA\((\d+)\)", SOURCE)]
_BK = re.search(r"kBK = DP > (\d+) \? (\d+) : (\d+);", SOURCE)


def padded(d: int) -> int:
    """DP: the smallest instance's width that holds ``d`` columns."""
    return min(dp for dp in DPS if dp >= d)


def tile_keys(dp: int) -> int:
    return int(_BK[2]) if dp > int(_BK[1]) else int(_BK[3])


def _fma(x, scale, mu):
    """x * scale - mu rounded once to float32, as the kernel's FFMA."""
    return (x.double() * scale.double() - mu.double()).float()


def emulate(q, k, v, *, causal, window, split=True):
    """The mma.sync kernel's arithmetic on bf16 q (B, Sq, H, D), k and v
    (B, Skv, Hkv, D); bf16 out. ``split`` False rounds P once to bf16."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    dp = padded(d)
    bk = tile_keys(dp)
    # The zero-filled tail of the head dim, as in shared memory.
    qf, kf, vf = (F.pad(t.float(), (0, dp - d)) for t in (q, k, v))
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.zeros((b, sq, h, d), dtype=torch.bfloat16)
    for bi in range(b):
        for hi in range(h):
            kh, vh = kf[bi, :, hi // group], vf[bi, :, hi // group]
            for q0 in range(0, sq, BQ):
                q_last = min(q0 + BQ, sq) - 1
                k_end = min(skv, q_last + 1) if causal else skv
                k_first = (max(0, q0 - window + 1) if window > 0 else 0) \
                    // bk * bk
                for qa in range(q0, min(q0 + BQ, sq), WARP_ROWS):
                    rows = torch.arange(qa, qa + WARP_ROWS)
                    n = min(sq, qa + WARP_ROWS) - qa
                    qt = torch.zeros((WARP_ROWS, dp))
                    qt[:n] = qf[bi, qa:qa + n, hi]
                    m = torch.full((WARP_ROWS,), NEG_INF)
                    l = torch.zeros(WARP_ROWS)
                    acc = torch.zeros((WARP_ROWS, dp))
                    for k0 in range(k_first, k_end, bk):
                        if (causal and k0 > qa + WARP_ROWS - 1) or (
                                window > 0 and k0 + bk - 1 <= qa - window):
                            continue            # wholly outside the band
                        kt = torch.zeros((bk, dp))
                        vt = torch.zeros((bk, dp))
                        nk = min(skv, k0 + bk) - k0
                        kt[:nk], vt[:nk] = kh[k0:k0 + nk], vh[k0:k0 + nk]
                        s = qt @ kt.T           # unscaled, as the kernel
                        keys = torch.arange(k0, k0 + bk)[None, :]
                        ok = keys < skv
                        if causal:
                            ok = ok & (keys <= rows[:, None])
                        if window > 0:
                            ok = ok & (keys > rows[:, None] - window)
                        s = torch.where(ok, s, torch.tensor(NEG_INF))
                        mx = torch.maximum(m, s.max(dim=1).values)
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
                    out[bi, qa:qa + n, hi] = o[:n, :d].to(torch.bfloat16)
    return out


def _qkv(rng, b, sq, skv, h, hkv, d):
    """bf16 tensors for the emulation and their exact float32 values."""
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return t, [x.float().numpy() for x in t]


def _pallas(nq, nk, nv, causal, window):
    """The Pallas kernel in interpret mode, one block over each axis (it
    needs Sq and Skv to be whole numbers of its blocks)."""
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    return np.asarray(flash_attention_hmajor(
        tr(nq), tr(nk), tr(nv), causal=causal, window=window,
        block_q=nq.shape[1], block_k=nk.shape[1],
        interpret=True).transpose(0, 2, 1, 3))


def _excess(got, want):
    """How far |got - want| goes beyond one bf16 rounding of ``want``."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    return float((err - BF16_ROUND * np.abs(want)).max())


# (B, Sq, Skv, H, Hkv, D, causal, window): StableLM's MHA head dim 80,
# GQA and MHA at 16, 36 and 96, causal and windowed; Sq and Skv no
# multiple of the kernel's tiles, and unequal.
CASES = {
    "d16_gqa_causal": (1, 100, 100, 4, 2, 16, True, 0),
    "d36_mha_window": (1, 150, 150, 3, 3, 36, True, 40),
    "d80_mha_causal": (1, 130, 130, 4, 4, 80, True, 0),
    "d80_gqa_window_ragged": (1, 90, 121, 4, 1, 80, True, 33),
    "d96_gqa_full_ragged": (2, 70, 90, 4, 2, 96, False, 0),
    "d96_mha_window_skv_short": (1, 97, 66, 2, 2, 96, False, 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_within_one_bf16_rounding_of_pallas(rng, case):
    b, sq, skv, h, hkv, d, causal, window = CASES[case]
    (q, k, v), (nq, nk, nv) = _qkv(rng, b, sq, skv, h, hkv, d)
    want = _pallas(nq, nk, nv, causal, window)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _excess(got, want) <= F32_ATTN_TOL


def test_fully_masked_rows_give_zero(rng):
    """Queries 40..63 see no key (a window of 8 past the last of 32 keys):
    0 there, as the Pallas kernel's guard and denominator floor give."""
    (q, k, v), (nq, nk, nv) = _qkv(rng, 1, 64, 32, 4, 2, 36)
    want = _pallas(nq, nk, nv, False, 8)
    got = emulate(q, k, v, causal=False, window=8)
    assert not got[:, 40:].float().any()
    assert bool(got[:, :39].float().abs().amax(dim=-1).gt(0).all())
    assert _excess(got, want) <= F32_ATTN_TOL


def test_p_rounded_once_breaks_the_bound(rng):
    """One rounding of P to bf16 leaves the output beyond the bound the
    split keeps, at StableLM's head dim over a few hundred keys."""
    (q, k, v), (nq, nk, nv) = _qkv(rng, 1, 384, 384, 2, 2, 80)
    want = _pallas(nq, nk, nv, True, 0)
    assert _excess(emulate(q, k, v, causal=True, window=0), want) \
        <= F32_ATTN_TOL
    once = emulate(q, k, v, causal=True, window=0, split=False)
    assert _excess(once, want) > F32_ATTN_TOL


def test_padded_widths_cover_every_head_dim():
    """An instance for every head dim up to 256, at most 31 columns of
    zeros, and 64-key tiles up to DP = 192 (16 above)."""
    assert DPS == sorted(DPS) and DPS[-1] == tfa.MMA_MAX_HEAD_DIM
    assert all(dp % 16 == 0 for dp in DPS)
    for d in range(1, tfa.MMA_MAX_HEAD_DIM + 1):
        assert 0 <= padded(d) - d < 32
    assert padded(80) == 80 and tile_keys(80) == 64
    assert tile_keys(256) == 16


@pytest.mark.parametrize("d,want", [(80, 16), (36, 8), (6, 4), (37, 2),
                                    (200, 16)])
def test_copy_width_follows_the_rows(d, want):
    t = torch.zeros((1, 5, 2, d), dtype=torch.bfloat16)
    assert tfa._copy_bytes(d, (t, t, t)) == want


def test_copy_width_follows_strides_and_bases():
    """Views of a (B, S, 3, H, D) qkv tensor: rows 3 H D apart; a view one
    element in gives 2-byte copies."""
    qkv = torch.zeros((1, 8, 3, 4, 80), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert tfa._copy_bytes(80, (q, k, v)) == 16
    flat = torch.zeros(1 + 8 * 4 * 80, dtype=torch.bfloat16)
    off = flat[1:].view(1, 8, 4, 80)
    assert tfa._copy_bytes(80, (off, k, v)) == 2


@pytest.mark.parametrize("d", [6, 36, 37, 200])
def test_card_path_takes_bf16_head_dims_on_the_mma_route(d):
    """The route by dtype and D (bf16 head dims that are no multiple of
    16), and the card path's layout checks of a contiguous tensor (an
    empty query reaches no launch); naming another route that does not
    take the inputs raises."""
    assert tfa._route(torch.bfloat16, d) == "mma"
    assert tfa._route(torch.float32, d) == "fma"
    q = torch.zeros((1, 0, 2, d), dtype=torch.bfloat16)
    kv = torch.zeros((1, 5, 1, d), dtype=torch.bfloat16)
    assert tfa._flash_cuda(q, kv, kv, True, 0).shape == (1, 0, 2, d)
    assert tfa._flash_cuda(q, kv, kv, True, 0, route="fma").shape \
        == (1, 0, 2, d)
    with pytest.raises(ValueError, match="tc flash kernel does not take"):
        tfa._flash_cuda(q, kv, kv, True, 0, route="tc")
    with pytest.raises(ValueError, match="mma flash kernel does not take"):
        tfa._flash_cuda(q.float(), kv.float(), kv.float(), True, 0,
                        route="mma")


@pytest.mark.parametrize("d", [80, 96])
def test_card_path_takes_bf16_multiples_of_16_on_the_tc_route(d):
    """bf16 head dims that are multiples of 16 take the wgmma route, and
    pass its layout checks; the mma.sync and CUDA-core kernels can still
    be named for them (to time the route beside them); float32 takes the
    CUDA-core route."""
    assert tfa._route(torch.bfloat16, d) == "tc"
    assert tfa._route(torch.float32, d) == "fma"
    q = torch.zeros((1, 0, 2, d), dtype=torch.bfloat16)
    kv = torch.zeros((1, 5, 1, d), dtype=torch.bfloat16)
    for route in (None, "mma", "fma"):
        assert tfa._flash_cuda(q, kv, kv, True, 0, route=route).shape \
            == (1, 0, 2, d)
    with pytest.raises(ValueError, match="tc flash kernel does not take"):
        tfa._flash_cuda(q.float(), kv.float(), kv.float(), True, 0,
                        route="tc")
