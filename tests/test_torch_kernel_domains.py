"""Inputs the Pallas kernels take and the port's kernels once refused on
the card: segment ids in any order (``-1`` anywhere) for the segmented
reduction, RWKV-6 heads over 64, and flash attention at any head dim.

On the CPU each wrapper runs its kernel's plain PyTorch version, held here
against the JAX package: the segmented reduction against
``segment_reduce_np`` in float64 (sums and counts within rtol 1e-6 on
same-sign values, min and max exact) and the Pallas kernel in interpret
mode; the RWKV-6 scan against ``rwkv6_scan_hmajor`` in interpret mode and
the step oracle ``rwkv6_step_ref`` within 2e-4 (the reference's own scan
tolerance); flash attention against ``flash_attention_hmajor`` in
interpret mode within 2e-5 (its float32 tolerance). The radix sort of
``csrc/segment_reduce.cu`` is emulated in numpy, with its tile and round
sizes read out of the source, and held to a stable argsort. Inputs are
made with numpy from a seed.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import segment_reduce as jsr
from repro.kernels.flash_attention import flash_attention_hmajor
from repro.kernels.rwkv6_scan import rwkv6_scan_hmajor
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.kernels import segment_reduce as tsr

SCAN_TOL = 2e-4
ATTN_TOL = 2e-5
MODES = ("sum", "count", "min", "max")

SOURCE = (pathlib.Path(tsr.__file__).resolve().parents[1] / "csrc"
          / "segment_reduce.cu").read_text()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


# -- the segmented reduction over ids in any order ---------------------------

def _unsorted(n, s, c, seed, pad_frac=0.0):
    """``n`` ids in ``[0, s)`` in random order with about ``pad_frac`` of
    them ``-1``, and ``c`` same-sign value columns (the rtol contract is
    about accumulation error, not cancellation)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s, n).astype(np.int32)
    ids[rng.random(n) < pad_frac] = -1
    vals = np.round(rng.uniform(1.0, 1000.0, (c, n)), 2).astype(np.float32)
    return ids, vals


def _oracle(vals, ids, s, mode):
    valid = ids >= 0
    return np.stack([jsr.segment_reduce_np(v[valid].astype(np.float64),
                                           ids[valid], s, mode)
                     for v in vals])


def _hold(got, want, mode):
    if mode in ("min", "max"):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


# (n, S, C, seed, share of -1): a permutation, -1 scattered, one row,
# one segment, and S across one, two and three radix passes.
CASES = {
    "permuted": (6000, 6, 5, 1, 0.0),
    "pad_scattered": (5000, 6, 3, 2, 0.2),
    "one_row": (1, 3, 2, 3, 0.0),
    "one_segment": (3000, 1, 4, 4, 0.3),
    "two_passes": (8000, 300, 2, 5, 0.1),
    "three_passes": (3000, 70_000, 1, 6, 0.1),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_unsorted_ids_match_reference(case, mode):
    n, s, c, seed, pad = CASES[case]
    ids, vals = _unsorted(n, s, c, seed, pad)
    got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=s,
                             mode=mode).numpy()
    assert got.shape == (c, s) and got.dtype == np.float32
    _hold(got, _oracle(vals, ids, s, mode), mode)
    pallas = np.asarray(jsr.segment_reduce(vals, ids, num_segments=s,
                                           mode=mode, interpret=True))
    _hold(got, pallas, mode)


@pytest.mark.parametrize("ids,want", [
    ([0, 2, 1], [1.0, 4.0, 2.0]),     # a descending id
    ([0, -1, 1], [1.0, 4.0, 0.0]),    # a -1 before a valid id
])
def test_small_unsorted_ids_are_accepted(ids, want):
    ids = np.asarray(ids, np.int32)
    vals = np.asarray([1.0, 2.0, 4.0], np.float32)
    got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=3).numpy()
    np.testing.assert_array_equal(got, np.float32(want))
    pallas = np.asarray(jsr.segment_reduce(vals, ids, num_segments=3,
                                           interpret=True))
    np.testing.assert_array_equal(got, pallas)
    _hold(got[None], _oracle(vals[None], ids, 3, "sum"), "sum")


@pytest.mark.parametrize("mode", MODES)
def test_all_ids_padding_give_identity(mode):
    vals = np.ones((2, 40), np.float32)
    got = tsr.segment_reduce(_t(vals), _t(np.full(40, -1, np.int32)),
                             num_segments=4, mode=mode).numpy()
    pallas = np.asarray(jsr.segment_reduce(vals, np.full(40, -1, np.int32),
                                           num_segments=4, mode=mode,
                                           interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, np.full((2, 4), jsr._INIT[mode],
                                               np.float32))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("mode", MODES)
def test_unsorted_plain_equals_presorted_bit_for_bit(c, mode):
    """The plain version on unsorted ids gives the bits of the same rows
    stably pre-sorted by id (``-1`` last), in every mode and column
    count: the sort keeps each segment's rows in their original order."""
    ids, vals = _unsorted(40_000, 7, c, seed=10 + c, pad_frac=0.1)
    key = np.where(ids == -1, 7, ids)
    order = np.argsort(key, kind="stable")
    got = tsr.segment_reduce_plain(_t(vals), _t(ids), 7, mode)
    want = tsr.segment_reduce_plain(_t(vals[:, order]), _t(ids[order]), 7,
                                    mode)
    assert torch.equal(got, want)
    assert torch.equal(tsr.segment_reduce(_t(vals), _t(ids), num_segments=7,
                                          mode=mode), got)


@pytest.mark.parametrize("ids", [[0, 2, 1], [1, -1, 0]])
def test_segment_offsets_keeps_its_sorted_contract(ids):
    """``segment_offsets`` is for sorted ids only: unsorted ones raise
    there, though ``segment_reduce`` takes them."""
    with pytest.raises(ValueError, match="sorted"):
        tsr.segment_offsets(_t(np.asarray(ids, np.int32)), 3)
    with pytest.raises(ValueError, match="must lie in"):
        tsr.segment_reduce_plain(torch.ones(1, 3),
                                 _t(np.asarray([2, 0, 3], np.int32)), 3,
                                 "sum")


@pytest.mark.parametrize("s,passes", [(1, 1), (6, 1), (255, 1), (256, 2),
                                      (300, 2), (65_535, 2), (65_536, 3),
                                      (70_000, 3)])
def test_radix_passes_cover_every_key(s, passes):
    """Keys run up to S (a -1 reads as S), 8 bits a pass."""
    assert tsr.radix_passes(s) == passes
    assert s < 256 ** passes


def _radix_pass(keys, shift):
    """One pass of the .cu's radix sort, emulated: per tile of kTile rows
    a 256-bin histogram (digit-major), its exclusive scan, and each row's
    position from its tile's base for its digit plus its rank among the
    equal digits before it: earlier rounds, earlier warps of its round
    (per-warp counts), lower lanes of its warp (a popcount of the
    match-any mask). Returns the permutation: ``out[pos] = row``."""
    threads, items, bins = (_const("kThreads"), _const("kSortItems"),
                            _const("kBins"))
    tile = threads * items
    assert tsr.SORT_TILE == tile
    n = len(keys)
    blocks = -(-n // tile)
    digits = (keys >> shift) & (bins - 1)
    hist = np.zeros((bins, blocks), np.int64)
    for b in range(blocks):
        hist[:, b] = np.bincount(digits[b * tile:(b + 1) * tile],
                                 minlength=bins)
    flat = hist.ravel()                       # digit-major
    scanned = (np.cumsum(flat) - flat).reshape(bins, blocks)
    out = np.full(n, -1, np.int64)
    for b in range(blocks):
        base = scanned[:, b].copy()
        for r in range(items):
            rows = b * tile + r * threads + np.arange(threads)
            rows = rows[rows < n]
            if not len(rows):
                break
            d = digits[rows]
            warp = (rows - rows[0]) // 32
            lane = (rows - rows[0]) % 32
            wcnt = np.zeros((threads // 32, bins), np.int64)
            np.add.at(wcnt, (warp, d), 1)
            for i, row in enumerate(rows):
                same = (warp == warp[i]) & (d == d[i])
                below = int((same & (lane < lane[i])).sum())
                pos = base[d[i]] + wcnt[:warp[i], d[i]].sum() + below
                out[pos] = row
            base += wcnt.sum(axis=0)
    assert (np.sort(out) == np.arange(n)).all()
    return out


@pytest.mark.parametrize("n,s,layout", [
    (5000, 6, "random"),            # one pass, a ragged last tile
    (9000, 300, "random"),          # two passes
    (4096 * 2 + 7, 70_000, "one_digit"),  # every row of a tile on one digit
])
def test_radix_emulation_equals_stable_argsort(n, s, layout):
    rng = np.random.default_rng(n)
    if layout == "random":
        ids = rng.integers(-1, s, n)
    else:
        ids = np.full(n, 5 * 256 + 3)        # one digit in every pass
        ids[4096:] = rng.integers(-1, s, n - 4096)
    keys = np.where(ids == -1, s, ids).astype(np.int64)
    order = np.arange(n)
    for p in range(tsr.radix_passes(s)):
        perm = _radix_pass(keys[order], 8 * p)
        order = order[perm]
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))


# -- RWKV-6 heads over 64 ----------------------------------------------------

def _rwkv_inputs(rng, b, s, h, k, v):
    """The reference's kernel-test distributions, as float32 numpy."""
    f = lambda shape, scale: (rng.standard_normal(shape)  # noqa: E731
                              * scale).astype(np.float32)
    r, kk = f((b, s, h, k), 0.5), f((b, s, h, k), 0.5)
    vv = f((b, s, h, v), 0.5)
    lw = (-np.exp(f((b, s, h, k), 0.5) - 2.0)).astype(np.float32)
    return r, kk, vv, lw, f((h, k), 0.3), f((b, h, k, v), 0.1)


@pytest.mark.parametrize("k,v", [(128, 128), (96, 160)])
def test_rwkv6_wide_heads_match_reference(rng, k, v):
    arrs = _rwkv_inputs(rng, 1, 64, 2, k, v)
    o, sf = trs.rwkv6_scan(*map(_t, arrs), chunk=32)
    assert o.shape == (1, 64, 2, v) and sf.shape == (1, 2, k, v)
    o_seq, s_seq = jref.rwkv6_step_ref(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_seq), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(s_seq), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    r, kk, vv, lw, u, s0 = arrs
    o_pal, s_pal = rwkv6_scan_hmajor(tr(r), tr(kk), tr(vv), tr(lw),
                                     jnp.asarray(u), jnp.asarray(s0),
                                     chunk=32, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(tr(o_pal)),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(s_pal), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    o_st, s_st = tref.rwkv6_step_ref(*map(_t, arrs))
    np.testing.assert_allclose(o_st.numpy(), np.asarray(o_seq),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_rwkv6_card_limit_is_a_function_of_the_head_dims():
    """What the card refuses depends on K and V alone, and the card path
    raises with it before it touches the card."""
    assert list(__import__("inspect").signature(trs.card_limit).parameters) \
        == ["k", "v"]
    for k, v in ((64, 64), (128, 128), (96, 160), (256, 1), (1, 4096),
                 (trs.SEQ_MAX_K, 65_535 * trs.SEQ_TILE_V)):
        assert trs.card_limit(k, v) is None
    for k, v in ((trs.SEQ_MAX_K + 1, 64), (64, 65_535 * trs.SEQ_TILE_V + 1)):
        limit = trs.card_limit(k, v)
        assert limit is not None and limit == trs.card_limit(k, v)
    arrs = [_t(a) for a in _rwkv_inputs(np.random.default_rng(0), 1, 2, 1,
                                        trs.SEQ_MAX_K + 1, 8)]
    with pytest.raises(ValueError, match=f"K up to {trs.SEQ_MAX_K}"):
        trs._scan_cuda(*arrs)


# -- flash attention at any head dim -----------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
@pytest.mark.parametrize("d", [6, 36, 320])
def test_flash_any_head_dim_matches_pallas(rng, d, causal, window):
    b, s, h, hkv = 1, 64, 2, 1
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    want = flash_attention_hmajor(tr(q), tr(k), tr(v), causal=causal,
                                  window=window, block_q=32, block_k=32,
                                  interpret=True).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("d", [6, 36, 320, tfa.MAX_HEAD_DIM])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_card_path_takes_any_head_dim(d, dtype):
    """Every head dim up to ``MAX_HEAD_DIM`` takes a route (bf16 up to
    ``MMA_MAX_HEAD_DIM`` the mma.sync kernel, the rest the CUDA-core
    kernel) and passes the card path's layout checks as a contiguous
    tensor (an empty query reaches no launch); a wider one raises, naming
    the limit."""
    mma = dtype == torch.bfloat16 and d <= tfa.MMA_MAX_HEAD_DIM
    assert tfa._route(dtype, d) == ("mma" if mma else "fma")
    q = torch.zeros((1, 0, 2, d), dtype=dtype)
    kv = torch.zeros((1, 5, 1, d), dtype=dtype)
    assert tfa._flash_cuda(q, kv, kv, True, 0).shape == (1, 0, 2, d)
    wide = torch.zeros((1, 0, 2, tfa.MAX_HEAD_DIM + 1), dtype=dtype)
    wkv = torch.zeros((1, 5, 1, tfa.MAX_HEAD_DIM + 1), dtype=dtype)
    with pytest.raises(ValueError, match=f"up to {tfa.MAX_HEAD_DIM}"):
        tfa._flash_cuda(wide, wkv, wkv, True, 0)
