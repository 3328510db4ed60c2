"""The port's kernel modules (``repro_torch.kernels``) against the JAX
reference: the bucketed sorted probe and range probe against the Pallas
kernels in interpret mode and the numpy oracles (exact), and the pairwise
segmented reduction against the Pallas kernel and ``segment_reduce_np``
(sums within rtol=1e-6 of float64, min/max exact). Inputs are made with
numpy from a seed; on the CPU each wrapper runs its kernel's plain
PyTorch version."""
import numpy as np
import pytest
import torch

from repro.kernels import hash_join as jhj
from repro.kernels import segment_reduce as jsr
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import hash_join as thj
from repro_torch.kernels import segment_reduce as tsr


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _probe_both(build, keys):
    pos, match = thj.sorted_probe(_t(build), _t(keys))
    jpos, jmatch = jhj.sorted_probe(build, keys, interpret=True)
    return pos.numpy(), match.numpy(), np.asarray(jpos), np.asarray(jmatch)


def _assert_probe_exact(build, keys):
    pos, match, jpos, jmatch = _probe_both(build, keys)
    ref_pos, ref_match = jhj.sorted_probe_np(build, keys)
    assert pos.dtype == np.int32 and match.dtype == bool
    np.testing.assert_array_equal(match, ref_match)
    np.testing.assert_array_equal(match, jmatch)
    np.testing.assert_array_equal(pos[ref_match], ref_pos[ref_match])
    np.testing.assert_array_equal(pos[ref_match], jpos[ref_match])


@pytest.mark.parametrize("n,s,lo,hi", [
    (1000, 400, 0, 600),          # partial match, dense keys
    (5000, 1, 0, 4),              # single-row build
    (257, 4096, -500, 9000),      # negative keys, probe wider than build
    (64, 1000, 10**6, 10**9),     # sparse keys, wide span
])
def test_sorted_probe_matches_reference(rng, n, s, lo, hi):
    build = np.sort(lo + rng.choice(hi - lo, size=s, replace=False)
                    ).astype(np.int32)
    keys = rng.integers(lo - 10, hi + 10, n).astype(np.int32)
    _assert_probe_exact(build, keys)


def test_sorted_probe_duplicate_build_keys_lower_bound(rng):
    build = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
    keys = np.arange(-5, 60, dtype=np.int32)
    _assert_probe_exact(build, keys)


def test_sorted_probe_full_int32_span():
    """Build keys spanning more than int31: the bucket offset wraps as
    uint32, so no key is misrouted."""
    build = np.asarray([-2**31, -5, 0, 7, 2**31 - 1], np.int32)
    keys = np.asarray([2**31 - 1, 7, -5, -2**31, 3, -2**31 + 1], np.int32)
    _assert_probe_exact(build, keys)
    pos, match = thj.sorted_probe(_t(build), _t(keys))
    assert match.tolist() == [True, True, True, True, False, False]
    assert pos[:4].tolist() == [4, 3, 1, 0]


@pytest.mark.parametrize("n,s,kmax,dup_frac", [
    (2000, 400, 600, 0.5),            # half the keys duplicated
    (500, 300, 50, 1.0),              # every build key duplicated, dense
    (257, 4096, 2**30, 0.1),          # sparse wide span, light dups
])
def test_sorted_probe_range_matches_reference(rng, n, s, kmax, dup_frac):
    base = rng.integers(0, kmax, s).astype(np.int32)
    dups = rng.choice(base, int(s * dup_frac))
    build = np.sort(np.concatenate([base, dups])).astype(np.int32)
    keys = rng.integers(-10, kmax + 10, n).astype(np.int32)
    lo, hi, match = (x.numpy() for x in
                     thj.sorted_probe_range(_t(build), _t(keys)))
    jlo, jhi, jmatch = (np.asarray(x) for x in
                        jhj.sorted_probe_range(build, keys, interpret=True))
    ref_lo, ref_hi, ref_match = jhj.sorted_probe_range_np(build, keys)
    np.testing.assert_array_equal(match, ref_match)
    np.testing.assert_array_equal(match, jmatch)
    for got, j, ref in ((lo, jlo, ref_lo), (hi, jhi, ref_hi)):
        np.testing.assert_array_equal(got[ref_match], ref[ref_match])
        np.testing.assert_array_equal(got[ref_match], j[ref_match])
    np.testing.assert_array_equal(hi - lo, np.where(ref_match,
                                                    ref_hi - ref_lo, 0))


def test_prepare_buckets_matches_reference_under_skew(rng):
    """The bucket table is the reference's (the search depth it also
    returned is gone: the device search stops when its slice is empty),
    and the probe stays exact under heavy key skew."""
    build = np.sort(np.concatenate([
        np.zeros(5000, np.int32),
        rng.integers(1, 2**30, 100).astype(np.int32)])).astype(np.int32)
    scal, starts = thj.prepare_buckets(build)
    jscal, jstarts, _ = jhj.prepare_buckets(build)
    np.testing.assert_array_equal(scal, jscal)
    np.testing.assert_array_equal(starts, jstarts)
    keys = np.concatenate([np.zeros(10, np.int32),
                           rng.integers(0, 2**30, 100).astype(np.int32)])
    table = thj.ProbeTable(_t(starts), int(scal[0]), int(scal[1]), -1)
    pos, match = thj.sorted_probe(_t(build), _t(keys), table=table)
    ref_pos, ref_match = jhj.sorted_probe_np(build, keys)
    np.testing.assert_array_equal(match.numpy(), ref_match)
    np.testing.assert_array_equal(pos.numpy()[ref_match], ref_pos[ref_match])


def test_probe_empty_sides():
    build = _t(np.asarray([1, 2, 3], np.int32))
    pos, match = thj.sorted_probe(build, _t(np.zeros(0, np.int32)))
    assert pos.shape == match.shape == (0,)
    lo, hi, match = thj.sorted_probe_range(_t(np.zeros(0, np.int32)),
                                           _t(np.asarray([4, 5], np.int32)))
    assert not match.any() and (hi - lo).tolist() == [0, 0]


def test_probe_rejects_wide_keys():
    with pytest.raises(ValueError, match="int32"):
        thj.sorted_probe(torch.arange(4), torch.arange(2))


def _dup_build(rng, s=600, kmax=900):
    base = rng.integers(0, kmax, s).astype(np.int32)
    return np.sort(np.concatenate([base, rng.choice(base, s // 2)])
                   ).astype(np.int32)


@pytest.mark.parametrize("kind", ["probe", "range"])
def test_probe_table_matches_oracle_and_tableless_call(rng, kind):
    """With a table made once (``probe_table``), both probes equal the
    numpy oracle and the call that builds its table itself."""
    build = _dup_build(rng)
    keys = rng.integers(-10, 910, 2000).astype(np.int32)
    table = thj.probe_table(build, "cpu")
    assert table.starts.dtype == torch.int32 and table.device_index == -1
    assert (table.bias, table.shift) == tuple(
        int(v) for v in thj.prepare_buckets(build)[0])
    if kind == "probe":
        got = thj.sorted_probe(_t(build), _t(keys), table=table)
        bare = thj.sorted_probe(_t(build), _t(keys))
        ref_pos, ref_match = jhj.sorted_probe_np(build, keys)
        np.testing.assert_array_equal(got[1].numpy(), ref_match)
        np.testing.assert_array_equal(got[0].numpy()[ref_match],
                                      ref_pos[ref_match])
    else:
        got = thj.sorted_probe_range(_t(build), _t(keys), table=table)
        bare = thj.sorted_probe_range(_t(build), _t(keys))
        ref_lo, ref_hi, ref_match = jhj.sorted_probe_range_np(build, keys)
        np.testing.assert_array_equal(got[2].numpy(), ref_match)
        for g, ref in zip(got[:2], (ref_lo, ref_hi)):
            np.testing.assert_array_equal(g.numpy()[ref_match],
                                          ref[ref_match])
    for g, b in zip(got, bare):
        assert g.dtype == b.dtype and torch.equal(g, b)


def test_probe_table_is_used_as_is(rng, monkeypatch):
    """A call handed a table never rebuilds it."""
    build = _dup_build(rng)
    keys = rng.integers(-10, 910, 500).astype(np.int32)
    table = thj.probe_table(build, "cpu")
    want = thj.sorted_probe_range(_t(build), _t(keys), table=table)

    def refuse(*args):
        raise AssertionError("prepare_buckets ran on a call given a table")
    monkeypatch.setattr(thj, "prepare_buckets", refuse)
    got = thj.sorted_probe_range(_t(build), _t(keys), table=table)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pos, match = thj.sorted_probe(_t(build), _t(keys), table=table)
    assert torch.equal(match, want[2])
    with pytest.raises(AssertionError, match="prepare_buckets"):
        thj.sorted_probe(_t(build), _t(keys))


def test_probe_table_on_another_device_raises(rng):
    build = _dup_build(rng)
    table = thj.probe_table(build, "cpu")._replace(device_index=0)
    with pytest.raises(ValueError, match="device"):
        thj.sorted_probe(_t(build), _t(build[:5].copy()), table=table)


# ---------------------------------------------------------------------------
# Segmented reduction
# ---------------------------------------------------------------------------

def _ids_vals(n, s, c, seed, pad=0):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, s, n)).astype(np.int32)
    ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
    # Same-sign values: the rtol contract is about accumulation error,
    # not cancellation.
    vals = np.round(rng.uniform(1.0, 1000.0, (c, n + pad)), 2
                    ).astype(np.float32)
    return ids, vals


@pytest.mark.parametrize("mode", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("n,s,c", [(1000, 6, 1), (4096, 1, 5),
                                   (10000, 300, 2), (5, 2, 3),
                                   (50_000, 4, 5)])
def test_segment_reduce_matches_reference(mode, n, s, c):
    ids, vals = _ids_vals(n, s, c, seed=n + s, pad=13)
    got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=s,
                             mode=mode).numpy()
    assert got.shape == (c, s) and got.dtype == np.float32
    want = np.stack([jsr.segment_reduce_np(vals[r, :n].astype(np.float64),
                                           ids[:n], s, mode)
                     for r in range(c)])
    jax_out = np.asarray(jsr.segment_reduce(vals, ids, num_segments=s,
                                            mode=mode, interpret=True))
    if mode in ("min", "max"):
        np.testing.assert_array_equal(got, want.astype(np.float32))
        np.testing.assert_array_equal(got, jax_out)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, jax_out, rtol=1e-6)


def test_segment_reduce_multi_pass_pairwise_precision():
    """A segment of 1.2M rows takes three passes (1024-row chunks, then
    chunks of chunk partials); the pairwise tree keeps the float32 sum
    within rtol=1e-6 of float64 where a sequential float32 sum drifts."""
    n = 1_200_000
    rng = np.random.default_rng(3)
    vals = rng.uniform(0.5, 1.5, n).astype(np.float32)
    ids = np.zeros(n, np.int32)
    assert len(tsr.reduction_passes(np.asarray([0, n]))) == 3
    got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=1).numpy()
    want = vals.astype(np.float64).sum()
    np.testing.assert_allclose(got, [want], rtol=1e-6)
    seq = np.float32(0)
    for chunk in np.array_split(vals, 64):   # a running f32 accumulator
        seq = np.float32(seq + np.cumsum(chunk, dtype=np.float32)[-1])
    assert abs(float(seq) - want) > abs(float(got[0]) - want)


def test_segment_reduce_empty_segments_hold_identity():
    ids = np.asarray([0, 0, 3, -1], np.int32)
    vals = np.asarray([1.0, 2.0, 5.0, 9.0], np.float32)
    for mode, want in (("sum", [3, 0, 0, 5]), ("count", [2, 0, 0, 1]),
                       ("min", [1, np.inf, np.inf, 5]),
                       ("max", [2, -np.inf, -np.inf, 5])):
        got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=4,
                                 mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.float32(want))
    allpad = tsr.segment_reduce(_t(vals), _t(np.full(4, -1, np.int32)),
                                num_segments=2)
    assert allpad.tolist() == [0.0, 0.0]


def test_segment_reduce_is_deterministic_and_matches_plain():
    ids, vals = _ids_vals(30_000, 3, 2, seed=9)
    a = tsr.segment_reduce(_t(vals), _t(ids), num_segments=3)
    b = tsr.segment_reduce_plain(_t(vals), _t(ids), 3, "sum")
    assert torch.equal(a, b)


@pytest.mark.parametrize("ids", [[0, 2, 1], [0, -1, 1], [0, 1, 5]])
def test_segment_reduce_rejects_bad_layout(ids):
    with pytest.raises(ValueError, match="segment ids"):
        tsr.segment_reduce(torch.ones(3), _t(np.asarray(ids, np.int32)),
                           num_segments=3)


@pytest.mark.parametrize("mode", ["sum", "count", "min", "max"])
def test_segment_reduce_offsets_entry_equals_ids_entry(mode):
    """The engine passes the groups' host row offsets; the ids entry
    derives the same offsets and gives the same bits."""
    ids, vals = _ids_vals(20_000, 7, 3, seed=11, pad=9)
    offsets = np.searchsorted(ids[:20_000], np.arange(8))
    by_ids = tsr.segment_reduce(_t(vals), _t(ids), num_segments=7, mode=mode)
    by_offsets = tsr.segment_reduce(_t(vals), offsets=offsets, mode=mode)
    assert torch.equal(by_ids, by_offsets)
    np.testing.assert_array_equal(tsr.segment_offsets(_t(ids), 7), offsets)
    with pytest.raises(ValueError, match="seg_ids or offsets"):
        tsr.segment_reduce(_t(vals), _t(ids), offsets=offsets)
    with pytest.raises(ValueError, match="segment offsets"):
        tsr.segment_reduce(_t(vals), offsets=[0, 5, 3])


_IDENTITY_NP = {"sum": 0.0, "count": 0.0, "min": np.inf, "max": -np.inf}
_COMBINE_NP = {"sum": np.add, "count": np.add, "min": np.minimum,
               "max": np.maximum}


def _tree_np(x, mode):
    """One CUDA block's fold of a chunk of <= CHUNK rows (C, len): the
    halving tree over identity-padded slots, in float32."""
    buf = np.full((x.shape[0], tsr.CHUNK), _IDENTITY_NP[mode], np.float32)
    buf[:, :x.shape[1]] = 1.0 if mode == "count" else x
    m = tsr.CHUNK
    while m > 1:
        m //= 2
        buf = _COMBINE_NP[mode](buf[:, :m], buf[:, m:2 * m])
    return buf[:, 0]


def _emulate_fold_launches(vals, offsets, mode, rng):
    """The CUDA path's launches on the host, from the very arrays the
    wrapper uploads (``_launch_plan``): every block folds its chunk and
    counts itself in its group, in a random finishing order, and the
    group's last block folds the group's partials in slot order.
    Partials start as NaN, so a fold that read one not yet written shows."""
    packed, launches = tsr._launch_plan(offsets, mode)
    packed, s1 = packed.copy(), len(offsets)

    def chain(p):
        return packed[s1 * p:s1 * (p + 1)].astype(np.int64)

    out = vals
    for p, fold, m1, blocks, outputs, at in launches:
        m2 = "sum" if m1 == "count" else m1
        offs, co = chain(p), chain(p + 1)
        partial = np.full((vals.shape[0], blocks), np.nan, np.float32)
        nxt = np.full((vals.shape[0], outputs), np.nan, np.float32) \
            if fold else partial
        for b in rng.permutation(blocks):
            seg = int(np.searchsorted(co[:-1], b, side="right")) - 1
            k = b - co[seg]
            row0 = offs[seg] + k * tsr.CHUNK
            partial[:, b] = _tree_np(
                out[:, row0:min(offs[seg + 1], row0 + tsr.CHUNK)], m1)
            if not fold:
                continue
            g = k // tsr.CHUNK
            group = min(tsr.CHUNK, co[seg + 1] - co[seg] - g * tsr.CHUNK)
            slot = chain(p + 2)[seg] + g
            packed[at + slot] += 1
            if packed[at + slot] == group:
                p0 = co[seg] + g * tsr.CHUNK
                nxt[:, slot] = _tree_np(partial[:, p0:p0 + group], m2)
        out = nxt
    return out, len(launches)


@pytest.mark.parametrize("mode", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("rows,launches", [
    # 1, 1023, 1024, 1025 and 1,048,576 rows a segment, with empty ones:
    # two passes, one launch.
    ([1, 0, 1023, 1024, 0, 1025, 1_048_576, 0], 1),
    # 1,048,577 rows: 1025 chunks, three passes, two launches.
    ([3, 1_048_577, 0], 2),
    # At most 1024 rows a segment: one pass, one launch that folds nothing.
    ([5, 0, 1024, 1], 1)])
def test_segment_reduce_single_launch_fold_emulation(mode, rows, launches):
    rng = np.random.default_rng(len(rows))
    offsets = np.concatenate([[0], np.cumsum(rows)])
    n = int(offsets[-1]) + 5             # rows past the last offset are ignored
    vals = rng.normal(0.0, 100.0, (2, n)).astype(np.float32)
    got, used = _emulate_fold_launches(vals, offsets, mode, rng)
    assert used == launches
    want = tsr.segment_reduce_plain(
        _t(vals[:, :offsets[-1]]),
        _t(np.repeat(np.arange(len(rows)), rows).astype(np.int32)),
        len(rows), mode)
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("ids,s", [
    ([0, 2, 1], 3),          # descending
    ([0, -1, 1], 3),         # -1 before a valid id
    ([-1, 0, 0], 3),         # -1 before a valid id, at the start
    ([0, 1, 5], 3),          # id past num_segments
    ([0, -2, -1], 3),        # id below -1
    ([1, 1, 0, -1], 2)])     # descending before the padding
def test_segment_offsets_derivation_rejects_bad_layout(ids, s):
    with pytest.raises(ValueError, match="segment ids"):
        tsr.segment_offsets(_t(np.asarray(ids, np.int32)), s)


def test_segment_offsets_derivation_finds_each_start():
    ids = np.asarray([0, 0, 3, 3, 3, 5, -1, -1], np.int32)
    np.testing.assert_array_equal(tsr.segment_offsets(_t(ids), 7),
                                  [0, 2, 2, 2, 5, 5, 6, 6])
    np.testing.assert_array_equal(
        tsr.segment_offsets(_t(np.full(3, -1, np.int32)), 2), [0, 0, 0])
    np.testing.assert_array_equal(
        tsr.segment_offsets(_t(np.zeros(0, np.int32)), 1), [0, 0])


def test_kernel_library_name_tracks_source_hash():
    """The build cache keys each library on its source: the name is
    stable for one source and lives under the ignored build directory."""
    path = kbuild.library_path("hash_join")
    assert path == kbuild.library_path("hash_join")
    assert path.parent == kbuild.BUILD_DIR
    assert path.name.startswith("hash_join-") and path.suffix == ".so"
    assert path != kbuild.library_path("segment_reduce")
