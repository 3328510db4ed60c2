"""The tensor-core grouped matmul's arithmetic and routing, on the CPU.

``csrc/moe_gmm_wgmma.cu`` runs only on an H100, so this file holds a
numpy emulation of its arithmetic: x and w padded with zeros to whole
128 x 128 output tiles and 64-wide contraction slabs (TMA's zero fill),
the products of bf16 values exact, each slab's sum taken in float32 and
added to a float32 accumulator, and one rounding to bf16 (nearest even)
of the kept rows and columns (the masked store). The kernel's 256-wide
tiles and two-CTA pairs change which block computes an output, not its
arithmetic. It is held against the
JAX package's oracle (``repro.kernels.ref.gmm_ref``) and the Pallas
``gmm`` in interpret mode on ragged C, D and F.

Tolerance: the bf16 result within one bf16 rounding of the float32 result
(2^-8 of its size) plus 1e-5 of the size of the summed terms, |x| @ |w|:
the bound ``chip_smoke.check_gmm`` holds the kernel to on the card. Two
faults must break it: an accumulator rounded to bf16 after every slab,
and columns 64-127 of each tile computed from the tile's first B atom (a
wrong leading byte offset in the B descriptor).

``_route`` (which kernel a call takes on the card) is a pure function of
dtype and shape, and the wrapper's checks raise before any launch; both
are tested here too. Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.moe_gmm import gmm as pallas_gmm
from repro_torch.kernels import moe_gmm as tgmm

BM, BN, BK, ATOM = 128, 128, 64, 64     # the kernel's tile, slab, atom
BF16_ROUND = 2.0 ** -8
GMM_F32_TOL = 1e-5


def _bf16(a):
    """float32 values rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate(x, w, *, slab_bf16=False, wrong_b_atom=False):
    """The tensor-core kernel's arithmetic on bf16-valued float32 x
    (E, C, D) and w (E, D, F); returns bf16-valued float32 (E, C, F).
    ``slab_bf16`` rounds the accumulator to bf16 after every slab;
    ``wrong_b_atom`` reads columns 64-127 of each tile from its first B
    atom."""
    e, c, d = x.shape
    f = w.shape[2]
    cp, fp = -(-c // BM) * BM, -(-f // BN) * BN
    dp = -(-d // BK) * BK
    xp = np.zeros((e, cp, dp), np.float64)
    wp = np.zeros((e, dp, fp), np.float64)
    xp[:, :c, :d], wp[:, :d, :f] = x, w
    if wrong_b_atom:
        for n0 in range(0, fp, BN):
            wp[:, :, n0 + ATOM:n0 + BN] = wp[:, :, n0:n0 + ATOM]
    acc = np.zeros((e, cp, fp), np.float32)
    for k0 in range(0, dp, BK):
        # Exact products, the slab's sum rounded to float32.
        part = np.matmul(xp[:, :, k0:k0 + BK], wp[:, k0:k0 + BK])
        acc = (acc + part.astype(np.float32)).astype(np.float32)
        if slab_bf16:
            acc = _bf16(acc)
    return _bf16(acc[:, :c, :f])


def _inputs(rng, e, c, d, f):
    x = _bf16(rng.standard_normal((e, c, d)))
    w = _bf16(rng.standard_normal((e, d, f)) / np.sqrt(d))
    return x, w


def _excess(got, want, size):
    """How far |got - want| goes beyond one bf16 rounding of ``want`` plus
    the float32 part of the bound."""
    want = np.asarray(want, np.float32)
    return float((np.abs(got - want) - BF16_ROUND * np.abs(want)
                  - GMM_F32_TOL * size).max())


# (E, C, D, F): ragged in C, D and F (a partial tile, slab and atom), a
# shape of whole tiles, and more slabs than the ring holds stages.
CASES = {"ragged": (3, 200, 200, 136), "whole_tiles": (2, 128, 128, 256),
         "long_contraction": (2, 40, 520, 72)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_within_one_bf16_rounding(rng, case):
    e, c, d, f = CASES[case]
    x, w = _inputs(rng, e, c, d, f)
    got = emulate(x, w)
    assert got.shape == (e, c, f) and np.isfinite(got).all()
    size = np.matmul(np.abs(x), np.abs(w))
    want = np.asarray(jref.gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    assert _excess(got, want, size) <= 0
    pallas = np.asarray(pallas_gmm(jnp.asarray(x), jnp.asarray(w),
                                   block_c=c, block_f=f, block_d=d,
                                   interpret=True))
    assert _excess(got, pallas, size) <= 0


@pytest.mark.parametrize("fault", ["slab_bf16", "wrong_b_atom"])
def test_planted_faults_break_the_bound(rng, fault):
    e, c, d, f = CASES["long_contraction"] if fault == "slab_bf16" \
        else CASES["whole_tiles"]
    x, w = _inputs(rng, e, c, d, f)
    size = np.matmul(np.abs(x), np.abs(w))
    want = np.asarray(jref.gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    assert _excess(emulate(x, w), want, size) <= 0
    assert _excess(emulate(x, w, **{fault: True}), want, size) > 0


@pytest.mark.parametrize("dtype,d,f,route", [
    (torch.bfloat16, 2048, 1408, "tc"),     # DeepSeekMoE-16B gate / up
    (torch.bfloat16, 1408, 2048, "tc"),     # ... and down
    (torch.bfloat16, 8, 8, "tc"),
    (torch.bfloat16, 12, 16, "mma"),        # D: no 16-byte row stride
    (torch.bfloat16, 16, 12, "mma"),        # F: no 16-byte row stride
    (torch.bfloat16, 7, 7, "mma"),
    (torch.float32, 2048, 1408, "fma"),
    (torch.float32, 12, 16, "fma")])
def test_route_by_dtype_and_shape(dtype, d, f, route):
    assert tgmm._route(dtype, d, f) == route


def _misaligned(shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)


@pytest.mark.parametrize("x,w,match", [
    (torch.zeros(2, 8, 16, dtype=torch.bfloat16).transpose(1, 2),
     torch.zeros(2, 8, 8, dtype=torch.bfloat16), "contiguous"),
    (torch.zeros(2, 8, 8, dtype=torch.bfloat16),
     torch.zeros(2, 16, 8, dtype=torch.bfloat16)[:, ::2], "contiguous"),
    (_misaligned((2, 8, 8)), torch.zeros(2, 8, 8, dtype=torch.bfloat16),
     "aligned"),
    (torch.zeros(2, 8, 8, dtype=torch.bfloat16), _misaligned((2, 8, 8)),
     "aligned")])
def test_launch_checks_raise_before_any_launch(x, w, match):
    with pytest.raises(ValueError, match=match):
        tgmm._gmm_cuda(x, w)


@pytest.mark.parametrize("x,w", [
    (torch.zeros(2, 3, 8, dtype=torch.bfloat16),
     torch.zeros(2, 5, 8, dtype=torch.bfloat16)),            # D differs
    (torch.zeros(2, 3, 8, dtype=torch.bfloat16),
     torch.zeros(3, 8, 8, dtype=torch.bfloat16)),            # E differs
    (torch.zeros(2, 3, 8, dtype=torch.bfloat16),
     torch.zeros(2, 8, 8)),                                  # dtypes differ
    (torch.zeros(2, 3, 8, dtype=torch.float16),
     torch.zeros(2, 8, 8, dtype=torch.float16))])            # no kernel
def test_shape_and_dtype_checks_raise(x, w):
    with pytest.raises(ValueError):
        tgmm.gmm(x, w)
