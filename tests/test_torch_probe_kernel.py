"""The port's join probe kernels (``csrc/hash_join.cu``), emulated in
numpy and held bit for bit against the plain PyTorch versions, the
Pallas kernels in interpret mode and the numpy oracles: the kernels'
search (the key's 64K-bucket slice, then the lower and upper bound in
it), their launch plan (one key a thread, 32-thread blocks while n is
under 256 keys an SM), and the fields of ``ProbeTable`` and of the
``TableArgs`` block the C entry points read. Inputs are made with numpy
from a seed."""
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.kernels import hash_join as jhj
from repro_torch.kernels import hash_join as thj

NB = thj.NB
INT32_MAX = np.iinfo(np.int32).max
SMS = 132          # the H100's SMs, as the C launch plan sees them
SOURCE = (pathlib.Path(thj.__file__).resolve().parents[1] / "csrc"
          / "hash_join.cu").read_text()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


# ---------------------------------------------------------------------------
# Emulation of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _bucket(keys, bias, shift):
    diff = (keys.astype(np.int64) - bias) & 0xFFFFFFFF      # uint32 wrap
    return np.minimum(diff >> shift, NB - 1)


def _search(read, key, lo, hi, upper):
    """``search`` of the .cu, every thread's loop stepped at once."""
    lo, hi = lo.copy(), hi.copy()
    while True:
        act = lo < hi
        if not act.any():
            return lo
        mid = lo + ((hi - lo) >> 1)
        v = read(np.where(act, mid, 0))
        go = act & ((v <= key) if upper else (v < key))
        lo = np.where(go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)


def _plan(n, sms=SMS):
    """The launch plan of the .cu: (threads a block, blocks), one key a
    thread."""
    small, big = _constant("kSmallThreads"), _constant("kThreads")
    threads = small if n < big * sms else big
    return threads, -(-n // threads)


def _kernel(keys, build, range_, plan=None):
    """The kernel over its grid: thread i of ``plan`` (``_plan``'s by
    default) takes key i when i < n. A key whose slice is empty has no
    match (and no read of the build keys); the upper bound is searched
    from the lower."""
    s, n = len(build), len(keys)
    scal, starts = thj.prepare_buckets(build)
    bias, shift = int(scal[0]), int(scal[1])
    threads, blocks = plan or _plan(n)
    i = np.arange(blocks * threads)
    i = i[i < n]
    assert np.array_equal(i, np.arange(n))                  # each key once

    def read(at):
        return build[at].astype(np.int64)

    key = keys[i].astype(np.int64)
    b = _bucket(key, bias, shift)
    slice_lo = starts[b].astype(np.int64)
    slice_hi = starts[b + 1].astype(np.int64)
    lo = _search(read, key, slice_lo, slice_hi, False)
    pos = np.minimum(lo, s - 1)
    live = slice_lo < slice_hi
    match = live & (lo < s) & (read(np.where(live, pos, 0)) == key)
    if range_:
        return lo, _search(read, key, lo, slice_hi, True), match
    return pos, match


# ---------------------------------------------------------------------------
# The emulation against the plain versions, Pallas and the oracles
# ---------------------------------------------------------------------------

def _skewed(rng, s):
    """Sorted keys with a heavy duplicate run at the bottom, a sparse
    middle and a dense top (empty buckets between)."""
    zeros = np.zeros(s // 2, np.int64)
    rest = np.concatenate([rng.integers(1, 2**30, s // 4),
                           2**30 + rng.integers(0, 4 * s, s - s // 2 - s // 4)])
    return np.sort(np.concatenate([zeros, rest])).astype(np.int32)


@pytest.mark.parametrize("s", [1, 5, 600, 5_059, 187_500])
def test_bucket_starts_under_skew(rng, s):
    """``prepare_buckets`` equals the JAX package's, and each bucket's
    slice of the build keys holds exactly the keys of that bucket."""
    build = _skewed(rng, s)
    scal, starts = thj.prepare_buckets(build)
    jscal, jstarts, _ = jhj.prepare_buckets(build)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(scal, np.asarray(jscal)[:2])
    assert starts[0] == 0 and starts[NB] == s
    assert (np.diff(starts) >= 0).all()
    b = _bucket(build, int(scal[0]), int(scal[1]))
    np.testing.assert_array_equal(np.searchsorted(b, np.arange(NB + 1)),
                                  starts)


def _case(name, rng):
    if name == "empty_buckets":        # sparse build over a wide span
        build = np.sort(rng.choice(10**9, 300, replace=False)).astype(np.int32)
        keys = np.concatenate([rng.choice(build, 200),
                               rng.integers(0, 10**9, 301)])
    elif name == "outside":            # keys below bias and above the max
        build = np.sort(rng.integers(-500, 9000, 4096)).astype(np.int32)
        keys = np.concatenate([rng.integers(-2**31, -500, 150),
                               rng.integers(9000, 2**31 - 1, 150),
                               rng.integers(-600, 9100, 203)])
    elif name == "full_int32_span":
        build = np.sort(np.concatenate([
            [-2**31, 2**31 - 1], rng.integers(-2**31, 2**31 - 1, 998)]))
        keys = np.concatenate([build[[0, -1]], rng.choice(build, 300),
                               rng.integers(-2**31, 2**31 - 1, 301)])
    elif name == "dup_runs_on_bucket_edges":
        # Runs of 40 equal keys every 4,096, dense keys between (two keys
        # a bucket): runs fill whole slices beside neighbours' keys.
        build = np.sort(np.concatenate([
            np.repeat(np.arange(0, 2**16, 2**12), 40),
            rng.integers(0, 2**16, 1500)]))
        keys = rng.integers(-10, 2**16 + 10, 1999)
    elif name == "skewed":
        build = _skewed(rng, 2000)
        keys = np.concatenate([np.zeros(7), rng.choice(build, 500),
                               rng.integers(0, 2**30, 500)])
    elif name == "below_bias_top_bucket":
        # Span 131,071 (shift 1): the last bucket holds 131,070, and a key
        # below bias wraps into it.
        build = np.asarray([0, 5, 131_000, 131_000, 131_070])
        keys = np.asarray([-1, -7, -2**31, 0, 131_000, 131_070, 131_071, 3])
    elif name == "below_bias_past_int32":
        # The start of a wrapped key's bucket lies past INT32_MAX (every
        # build key is below it).
        top = INT32_MAX
        build = np.asarray([top - 60_000, top - 2_000, top - 2_000, top])
        keys = np.asarray([0, -5, top - 60_001, top - 2_000, top, 12])
    elif name == "n_is_1":
        build = np.sort(rng.integers(0, 100, 50))
        keys = build[17:18]
    else:
        raise KeyError(name)
    return build.astype(np.int32), np.asarray(keys).astype(np.int32)


CASES = ["empty_buckets", "outside", "full_int32_span",
         "dup_runs_on_bucket_edges", "skewed", "below_bias_top_bucket",
         "below_bias_past_int32", "n_is_1"]


def _want(build, keys, range_):
    """The plain version's outputs (checked against the Pallas kernel in
    interpret mode and the numpy oracle on the way)."""
    scal, starts = thj.prepare_buckets(build)
    if range_:
        plain = [x.numpy() for x in thj.sorted_probe_range_plain(
            _t(build), _t(keys), scal, _t(starts))]
        pallas = [np.asarray(x) for x in
                  jhj.sorted_probe_range(build, keys, interpret=True)]
        ref_lo, ref_hi, ref_match = jhj.sorted_probe_range_np(build, keys)
        np.testing.assert_array_equal(plain[2], ref_match)
        np.testing.assert_array_equal(plain[0][ref_match], ref_lo[ref_match])
        np.testing.assert_array_equal(plain[1] - plain[0],
                                      np.where(ref_match, ref_hi - ref_lo, 0))
    else:
        plain = [x.numpy() for x in thj.sorted_probe_plain(
            _t(build), _t(keys), scal, _t(starts))]
        pallas = [np.asarray(x) for x in
                  jhj.sorted_probe(build, keys, interpret=True)]
        ref_pos, ref_match = jhj.sorted_probe_np(build, keys)
        np.testing.assert_array_equal(plain[1], ref_match)
        np.testing.assert_array_equal(plain[0][ref_match], ref_pos[ref_match])
    for p, j in zip(plain, pallas):
        np.testing.assert_array_equal(p, j)
    return plain


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(w.dtype), w)


@pytest.mark.parametrize("threads", [32, 256])
@pytest.mark.parametrize("range_", [False, True], ids=["probe", "range"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_emulation_is_bit_equal(rng, case, range_, threads):
    """Bit-equal on both block sizes the plan takes (n not a multiple of
    either in most cases)."""
    build, keys = _case(case, rng)
    want = _want(build, keys, range_)
    plan = (threads, -(-len(keys) // threads))
    _assert_bit_equal(_kernel(keys, build, range_, plan), want)


@pytest.mark.parametrize("n,plan", [
    (5_265, (32, 165)),               # the main path's probe: 132+ SMs
    (1, (32, 1)),
    (256 * SMS - 1, (32, 1056)),
    (256 * SMS, (256, 132)),
    (187_500, (256, 733)),            # the main path's range probe
])
def test_plan_spreads_small_n_over_the_sms(n, plan):
    assert _plan(n) == plan
    assert "n < kThreads * sms ? kSmallThreads : kThreads" in SOURCE


def test_skewed_bucket_is_searched_whole(rng):
    """A bucket holding half the build (5,000 equal keys) stays exact:
    its run is found whole."""
    build = np.sort(np.concatenate([np.zeros(5000, np.int32),
                                    rng.integers(1, 2**30, 100)])
                    ).astype(np.int32)
    keys = np.concatenate([np.zeros(9, np.int32),
                           rng.integers(-5, 2**30, 5091).astype(np.int32)])
    want = _want(build, keys, True)
    assert (want[1][:9] - want[0][:9] == 5000).all()
    _assert_bit_equal(_kernel(keys, build, True), want)


# ---------------------------------------------------------------------------
# ProbeTable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 5_059, 187_500])
def test_probe_table_fields(rng, s):
    """What ``probe_table`` folds in once per build side, and the ctypes
    block the C entry points read (its layout that of ``TableArgs``)."""
    build = np.sort(rng.integers(0, 10**7, s)).astype(np.int32)
    table = thj.probe_table(build, "cpu")
    scal, starts = thj.prepare_buckets(build)
    np.testing.assert_array_equal(table.build.numpy(), build)
    np.testing.assert_array_equal(table.starts.numpy(), starts)
    a = table.args
    assert table.args_ptr == ctypes.addressof(a)
    assert (a.starts, a.build) == (table.starts.data_ptr(),
                                   table.build.data_ptr())
    assert (a.s, a.bias, a.shift) == (s, int(scal[0]), int(scal[1]))
    assert (a.device, a.sms) == (-1, 0)
    assert ctypes.sizeof(thj._TableArgs) == 2 * 8 + 5 * 4 + 4   # padded


def test_table_args_match_the_source():
    """``_TableArgs`` lists ``TableArgs``' fields in the .cu's order, with
    its types."""
    body = re.search(r"struct TableArgs \{(.*?)\};", SOURCE, re.S)[1]
    fields = re.findall(r"^\s*(const int32_t\*|int32_t) (\w+);", body, re.M)
    ctype = {"const int32_t*": ctypes.c_void_p, "int32_t": ctypes.c_int32}
    assert [(name, ctype[ty]) for ty, name in fields] == \
        thj._TableArgs._fields_

def test_probe_table_from_a_tensor_keeps_it(rng):
    build = _t(np.sort(rng.integers(0, 900, 600)).astype(np.int32))
    keys = _t(rng.integers(-10, 910, 700).astype(np.int32))
    table = thj.probe_table(build)
    assert table.build is build and table.device_index == -1
    got = thj.sorted_probe_range(build, keys, table=table)
    want = thj.sorted_probe_range(build, keys)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["probe", "range"])
def test_probe_table_checks_still_raise(rng, kind):
    """A table on another device, or made from other build keys, raises
    in both probes."""
    build = np.sort(rng.integers(0, 900, 600)).astype(np.int32)
    keys = _t(build[:5].copy())
    fn = thj.sorted_probe if kind == "probe" else thj.sorted_probe_range
    table = thj.probe_table(build, "cpu")
    with pytest.raises(ValueError, match="device"):
        fn(table.build, keys, table=table._replace(device_index=0))
    with pytest.raises(ValueError, match="other build keys"):
        fn(_t(build.copy()), keys, table=table)
    with pytest.raises(ValueError, match="int32"):
        fn(table.build, keys.to(torch.int64), table=table)
