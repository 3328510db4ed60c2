"""The sign of a zero from the segmented reduction's ``min`` and ``max``.

The reference's one-hot kernel reduces with ``jnp.minimum`` /
``jnp.maximum``, which order ``-0.0`` below ``+0.0``: a segment holding
both zeros gives ``-0.0`` for ``min`` and ``+0.0`` for ``max``, in any
order of its rows. The port's fold meets the rows in a pairwise tree;
both its plain version (run here, on the CPU) and the card's ``combine``
take the operand with the sign bit on a ``min`` tie and the one without
on a ``max`` tie, so the tree's order cannot show. NaN still wins.

Each case is held against the Pallas kernel in interpret mode
(``repro.kernels.segment_reduce``, as the JAX package's own tests run
it) bit for bit, the sign bit included, on the offsets path (ids sorted,
``-1`` padding the tail; and host ``offsets``, as the engine passes them)
and on the sort route (the same rows permuted, ``-1`` scattered). Inputs
are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro.kernels import segment_reduce as jsr
from repro_torch.kernels import segment_reduce as tsr

NAN = np.float32(np.nan)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    """The float32 bits, every NaN as one canonical NaN (the payload of a
    NaN is no part of the contract; that it is NaN is)."""
    a = np.asarray(a, np.float32).copy()
    a[np.isnan(a)] = NAN
    return a.view(np.uint32)


# Segments of a few rows: every order of the two zeros, with NaN, with a
# nonzero neighbour, and zeros of one sign only.
SMALL = [[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0], [0.0, 0.0],
         [NAN, -0.0, 0.0], [0.0, NAN, -0.0], [-0.0, 0.0, NAN],
         [0.0, 1.0, -0.0], [-1.0, 0.0, -0.0], [0.0, -0.0, 0.0, -0.0, 0.0]]


def _small_case():
    vals = np.concatenate([np.asarray(s, np.float32) for s in SMALL])
    ids = np.repeat(np.arange(len(SMALL), dtype=np.int32),
                    [len(s) for s in SMALL])
    # A second column: the same rows negated (min and max trade places).
    return np.stack([vals, -vals]), ids, len(SMALL)


def _long_case(seed):
    """Zeros of both signs spread over segments longer than one chunk of
    the fold (``CHUNK`` rows), so the partials' second pass meets mixed
    zeros too; one segment of one sign only, one with a NaN."""
    rng = np.random.default_rng(seed)
    lengths = [3 * tsr.CHUNK + 5, tsr.CHUNK, 2 * tsr.CHUNK - 1, 700]
    cols = []
    for sign in (1.0, -1.0):
        col = []
        for i, n in enumerate(lengths):
            neg = rng.random(n) < (0.0 if i == 3 else 0.5)
            x = np.where(neg, np.float32(-0.0), np.float32(0.0)) * sign
            if i == 2:
                x[rng.integers(n)] = NAN
            col.append(x.astype(np.float32))
        cols.append(np.concatenate(col))
    ids = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    return np.stack(cols), ids, len(lengths)


CASES = {"small": _small_case, "long_seed1": lambda: _long_case(1),
         "long_seed2": lambda: _long_case(2)}


def _pallas(vals, ids, s, mode):
    return np.asarray(jsr.segment_reduce(vals, ids, num_segments=s,
                                         mode=mode, interpret=True))


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("case", list(CASES))
def test_sorted_ids_keep_the_references_zero_bits(case, mode):
    vals, ids, s = CASES[case]()
    # -1 padding the tail: rows the reduction must ignore.
    vals = np.concatenate([vals, np.full((2, 3), -5.0, np.float32)], 1)
    ids = np.concatenate([ids, np.full(3, -1, np.int32)])
    want = _pallas(vals, ids, s, mode)
    got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=s,
                             mode=mode).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    offsets = np.searchsorted(ids[ids >= 0], np.arange(s + 1))
    by_offsets = tsr.segment_reduce(_t(vals), offsets=offsets,
                                    mode=mode).numpy()
    np.testing.assert_array_equal(_bits(by_offsets), _bits(want))


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("case", list(CASES))
def test_unsorted_ids_keep_the_references_zero_bits(case, mode):
    """The sort route: the rows permuted and a tenth of them ``-1``."""
    vals, ids, s = CASES[case]()
    rng = np.random.default_rng(7)
    order = rng.permutation(ids.size)
    vals, ids = vals[:, order], ids[order].copy()
    ids[rng.random(ids.size) < 0.1] = -1
    want = _pallas(vals, ids, s, mode)
    got = tsr.segment_reduce(_t(vals), _t(ids), num_segments=s,
                             mode=mode).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("a,b", [(-0.0, 0.0), (0.0, -0.0), (NAN, -0.0),
                                 (0.0, NAN), (-0.0, -0.0), (1.0, -0.0)])
def test_combine_orders_negative_zero_below_positive(a, b):
    """One step of the fold, both operand orders: ``min`` takes ``-0.0``
    and ``max`` ``+0.0`` on a tie, NaN wins, as ``jnp.minimum`` and
    ``jnp.maximum`` do."""
    import jax.numpy as jnp
    x, y = (torch.tensor([a], dtype=torch.float32),
            torch.tensor([b], dtype=torch.float32))
    for mode, ref in (("min", jnp.minimum), ("max", jnp.maximum)):
        comb = tsr._combine(mode)
        for u, w in ((x, y), (y, x)):
            want = np.asarray(ref(jnp.asarray(u.numpy()),
                                  jnp.asarray(w.numpy())))
            np.testing.assert_array_equal(_bits(comb(u, w).numpy()),
                                          _bits(want))
