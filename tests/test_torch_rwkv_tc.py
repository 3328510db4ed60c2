"""The tensor-core RWKV-6 scan kernel's arithmetic, on the CPU.

``csrc/rwkv6_scan_tc.cu`` runs only on an H100, so this file holds a
numpy emulation of its arithmetic: 64-step chunks in 16-step sub-chunks,
each in two 8-step halves; every decay a product of per-step decays
w = exp(log_w) <= 1 taken from a reference point at or between the two
steps it joins (the start and the end of each sub-chunk and half, whole
sub-chunks' products between), so no exponent is positive; the pairs
within a half by a running product of w in float32 (the CUDA cores);
every other product through operands split into hi + lo, three products
hi.hi + hi.lo + lo.hi summed in float32 (the tensor cores): TF32 parts
(mantissa cut to 10 bits, rounded to nearest) for float32 inputs, bf16
parts (rounded to nearest even) for bf16 inputs, whose v is exact.

It is held against the JAX package's Pallas ``_rwkv_kernel`` in interpret
mode at moderate decays, and against ``repro.kernels.ref.rwkv6_step_ref``
at log_w = -6 (a decay mass of 384 a chunk, where the Pallas form's
exp(-incl) overflows) and at a mix of log_w near -60 and near -1e-3
within one chunk. Tolerance: ``RWKV_TOL`` = 2e-4 of the size of the terms
each output sums (the recurrence stepped in float64 on absolute values),
the bound ``chip_smoke.within_scan`` holds the kernel to on the card. Two
planted faults must break it: the chunk-start reference point (r e^excl,
k e^-incl, which overflows) and operands rounded once, unsplit.

``_route`` (which kernel a call takes on the card) is a pure function of
dtype and head dims, tested here too. Inputs are made with numpy from a
seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan_hmajor
from repro_torch.kernels import rwkv6_scan as trs

L, Q, H8 = 64, 16, 8      # the kernel's chunk, sub-chunk and half
RWKV_TOL = 2e-4


def _round(x, keep: int):
    """Round float32 to ``keep`` mantissa bits: TF32 (10, to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``) or bf16 (7, to nearest even,
    as ``cvt.rn.bf16x2.f32``)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32) \
        .astype(np.uint64)
    drop = 23 - keep
    half = 1 << (drop - 1)
    if keep == 7:     # ties to even
        bits = bits + half - 1 + ((bits >> drop) & 1)
    else:
        bits = bits + half
    mask = (0xFFFFFFFF >> drop) << drop
    return (bits & mask).astype(np.uint32).view(np.float32)


def mm(a, b, parts="tf32", split=True):
    """a @ b as the kernel's mma.sync: operands in TF32 or bf16 parts,
    float32 sums; with ``split``, hi.hi + hi.lo + lo.hi."""
    keep = {"tf32": 10, "bf16": 7}[parts]
    ah, bh = _round(a, keep), _round(b, keep)
    if not split:
        return np.matmul(ah, bh)
    al, bl = _round(a - ah, keep), _round(b - bh, keep)
    return (np.matmul(al, bh) + np.matmul(ah, bl)) + np.matmul(ah, bh)


def _chunk_start_ref(rc, kc, vc, lc, uu, st, mmp):
    """The Pallas form's reference point, the chunk's start: r e^excl and
    k e^-incl, whose exponent is positive (the planted fault)."""
    incl = np.cumsum(lc, axis=2, dtype=np.float32)
    excl = incl - lc
    r0 = rc * np.exp(excl)
    a = np.tril(mmp(r0, np.swapaxes(kc * np.exp(-incl), 2, 3)), -1) \
        + np.eye(L, dtype=np.float32) * np.sum(rc * uu * kc, -1)[..., None]
    kl = kc * np.exp(incl[:, :, -1:] - incl)
    o = mmp(r0, st) + mmp(a, vc)
    st = np.exp(incl[:, :, -1])[..., None] * st \
        + mmp(np.swapaxes(kl, 2, 3), vc)
    return o, st


def emulate(r, k, v, log_w, u, s0, *, parts="tf32", split=True,
            chunk_start_ref=False):
    """The kernel's arithmetic on r, k, log_w (B, S, H, K), v (B, S, H, V),
    u (H, K), s0 (B, H, K, V): (o (B, S, H, V), s_final) in float32."""
    b, s, h, kd = r.shape
    n = -(-s // L) * L

    def mmp(x, y):
        return mm(x, y, parts, split)

    def heads_first(a):   # (B, H, n, *), a ragged last chunk zero-filled
        a = np.moveaxis(np.asarray(a, np.float32), 1, 2)
        return np.concatenate(
            [a, np.zeros(a.shape[:2] + (n - s, a.shape[3]), np.float32)], 2)

    r, k, v, lw = (heads_first(a) for a in (r, k, v, log_w))
    st = np.array(s0, np.float32)
    o = np.zeros(v.shape, np.float32)
    uu = np.asarray(u, np.float32)[None, :, None, :]
    nq = L // Q
    for c0 in range(0, n, L):
        rc, kc, vc, lc = (a[:, :, c0:c0 + L] for a in (r, k, v, lw))
        if chunk_start_ref:
            o[:, :, c0:c0 + L], st = _chunk_start_ref(rc, kc, vc, lc, uu, st,
                                                      mmp)
            continue
        w = np.exp(lc)
        one = np.ones(w.shape[:2] + (kd,), np.float32)
        rt, kt, r8, k8, tq = (np.empty_like(rc), np.empty_like(kc),
                              np.empty_like(rc), np.empty_like(kc), [])
        for q in range(nq):   # e_t, f_s, T_q and the halves' e8, f8
            e, e8 = one, one
            for t in range(q * Q, q * Q + Q):
                rt[:, :, t] = rc[:, :, t] * e
                e = e * w[:, :, t]
                if t >= q * Q + H8:
                    r8[:, :, t] = rc[:, :, t] * e8
                    e8 = e8 * w[:, :, t]
            tq.append(e)
            f, f8 = one, one
            for t in range(q * Q + Q - 1, q * Q - 1, -1):
                kt[:, :, t] = kc[:, :, t] * f
                f = f * w[:, :, t]
                if t < q * Q + H8:
                    k8[:, :, t] = kc[:, :, t] * f8
                    f8 = f8 * w[:, :, t]

        def prod(qs):
            out = one
            for q in qs:
                out = out * tq[q]
            return out

        a = np.zeros(rc.shape[:2] + (L, L), np.float32)
        for h0 in range(0, L, H8):   # within a half: the CUDA cores
            for t in range(h0, h0 + H8):
                d = one
                for p in range(t - 1, h0 - 1, -1):
                    a[:, :, t, p] = np.sum(rc[:, :, t] * kc[:, :, p] * d, -1)
                    d = d * w[:, :, p]
                a[:, :, t, t] = np.sum(rc[:, :, t] * uu[:, :, 0] * kc[:, :, t],
                                       -1)
        for q in range(nq):          # the halves of a sub-chunk: tensor cores
            hi, lo = slice(q * Q + H8, q * Q + Q), slice(q * Q, q * Q + H8)
            a[:, :, hi, lo] = mmp(r8[:, :, hi], np.swapaxes(k8[:, :, lo], 2, 3))
        for i in range(1, nq):       # sub-chunk pairs j < i: tensor cores
            for j in range(i):
                kj = kt[:, :, j * Q:j * Q + Q] * prod(range(j + 1, i))[:, :,
                                                                     None]
                a[:, :, i * Q:i * Q + Q, j * Q:j * Q + Q] = mmp(
                    rt[:, :, i * Q:i * Q + Q], np.swapaxes(kj, 2, 3))
        r0 = np.concatenate([rt[:, :, q * Q:q * Q + Q]
                             * prod(range(q))[:, :, None] for q in range(nq)],
                            2)
        kl = np.concatenate([kt[:, :, q * Q:q * Q + Q]
                             * prod(range(q + 1, nq))[:, :, None]
                             for q in range(nq)], 2)
        o[:, :, c0:c0 + L] = mmp(r0, st) + mmp(a, vc)
        st = prod(range(nq))[..., None] * st + mmp(np.swapaxes(kl, 2, 3), vc)
    return np.moveaxis(o[:, :, :s], 2, 1), st


def term_sizes(r, k, v, log_w, u, s0):
    """For each output and final state entry, the size of the terms it
    sums: the recurrence stepped in float64 on absolute values."""
    r, k, v = (np.abs(np.asarray(a, np.float64)) for a in (r, k, v))
    w = np.exp(np.asarray(log_w, np.float64))
    uu = np.abs(np.asarray(u, np.float64))[None, :, :, None]
    m = np.abs(np.asarray(s0, np.float64))
    mag = []
    for t in range(r.shape[1]):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        mag.append(np.einsum("bhk,bhkv->bhv", r[:, t], m + uu * kv))
        m = m * w[:, t, ..., None] + kv
    return np.stack(mag, 1), m


def excess(got, want, size):
    """Largest |got - want| over RWKV_TOL * size: at most 1 within the
    bound; inf where got is not finite."""
    if not np.isfinite(got).all():
        return np.inf
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    return float((err / (RWKV_TOL * np.maximum(size, 1e-300))).max())


def _inputs(rng, decay, parts="tf32", b=2, s=200, h=3, kd=64):
    """Seeded inputs; for the bf16 kernel, r, k and v rounded to bf16."""
    r, k, v = (rng.normal(0.0, 1.0, (b, s, h, kd)).astype(np.float32)
               for _ in range(3))
    if parts == "bf16":
        r, k, v = (_round(x, 7) for x in (r, k, v))
    if decay == "moderate":
        lw = -np.exp(rng.normal(-2.0, 1.0, (b, s, h, kd)))
    elif decay == "strong":
        lw = np.full((b, s, h, kd), -6.0)
    else:        # "mixed": a fifth of the steps near -60, the rest ~ -1e-3
        big = rng.random((b, s, h, kd)) < 0.2
        lw = np.where(big, -60.0 + rng.normal(0.0, 1.0, big.shape),
                      -1e-3 * rng.random(big.shape))
    u = rng.normal(0.0, 0.3, (h, kd)).astype(np.float32)
    s0 = rng.normal(0.0, 0.1, (b, h, kd, kd)).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u, s0


def _step_oracle(args):
    o, st = jref.rwkv6_step_ref(*(jnp.asarray(a) for a in args))
    return np.asarray(o), np.asarray(st)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


PARTS = ["tf32", "bf16"]


@pytest.mark.parametrize("parts", PARTS)
def test_emulation_matches_pallas_at_moderate_decay(rng, parts):
    args = _inputs(rng, "moderate", parts, s=128)
    r, k, v, lw, u, s0 = args
    hm = [jnp.asarray(np.moveaxis(a, 1, 2)) for a in (r, k, v, lw)]
    po, ps = rwkv6_scan_hmajor(*hm, jnp.asarray(u), jnp.asarray(s0),
                               chunk=L, interpret=True)
    po = np.moveaxis(np.asarray(po), 2, 1)
    go, gs = emulate(*args, parts=parts)
    o_size, s_size = term_sizes(*args)
    assert excess(go, po, o_size) <= 1.0
    assert excess(gs, np.asarray(ps), s_size) <= 1.0


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("decay", ["strong", "mixed"])
def test_emulation_matches_step_oracle(rng, decay, parts):
    """Where no exp(-incl) form survives: log_w = -6 overflows the chunk
    start's e^384; a step of -60 overflows it at once. A ragged length
    (200 = 3 chunks + 8 steps) takes the zero-filled last chunk."""
    args = _inputs(rng, decay, parts)
    wo, ws = _step_oracle(args)
    go, gs = emulate(*args, parts=parts)
    o_size, s_size = term_sizes(*args)
    assert excess(go, wo, o_size) <= 1.0
    assert excess(gs, ws, s_size) <= 1.0


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("fault,decay", [("chunk_start_ref", "strong"),
                                         ("chunk_start_ref", "mixed"),
                                         ("unsplit", "strong"),
                                         ("unsplit", "moderate")])
def test_planted_faults_break_the_bound(rng, fault, decay, parts):
    args = _inputs(rng, decay, parts)
    wo, _ = _step_oracle(args)
    o_size, _ = term_sizes(*args)
    kw = {"chunk_start_ref": True} if fault == "chunk_start_ref" \
        else {"split": False}
    with np.errstate(over="ignore", invalid="ignore"):
        go, _ = emulate(*args, parts=parts, **kw)
    assert excess(go, wo, o_size) > 1.0


@pytest.mark.parametrize("dtype,kd,vd,route", [
    (torch.bfloat16, 64, 64, "tc"), (torch.float32, 64, 64, "tc"),
    (torch.bfloat16, 32, 32, "seq"), (torch.float32, 64, 32, "seq"),
    (torch.bfloat16, 48, 64, "seq")])
def test_route_by_dtype_and_head_dims(dtype, kd, vd, route):
    assert trs._route(dtype, kd, vd) == route


def test_misaligned_rows_are_copied_for_the_tensor_core_kernel():
    base = torch.zeros((2, 9, 3, 64), dtype=torch.bfloat16)
    assert trs._aligned_rows(base) is base
    odd = torch.zeros((2 * 9 * 3 * 64 + 1,), dtype=torch.bfloat16)[1:] \
        .view(2, 9, 3, 64)
    fixed = trs._aligned_rows(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
