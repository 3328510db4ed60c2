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
    pos, match = thj.sorted_probe(_t(build), _t(keys), scalars=scal,
                                  starts=starts)
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


def test_kernel_library_name_tracks_source_hash():
    """The build cache keys each library on its source: the name is
    stable for one source and lives under the ignored build directory."""
    path = kbuild.library_path("hash_join")
    assert path == kbuild.library_path("hash_join")
    assert path.parent == kbuild.BUILD_DIR
    assert path.name.startswith("hash_join-") and path.suffix == ".so"
    assert path != kbuild.library_path("segment_reduce")
