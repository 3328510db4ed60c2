"""Sorted-probe kernels for the query engine's compiled equi-join.

Backs ``hash_join`` in the torch backend: the build side arrives sorted
by key (the compiler argsorts it on the host, as the interpreted join
does) and every probe key is located with a bucket-accelerated search:

* ``prepare_buckets`` (host numpy) builds a radix bucket table over the
  high key bits: 2**16 buckets, ``bucket(k) = uint32(k - bias) >> shift``,
  and the NB+1 bucket start positions. Each probe searches only its
  bucket's slice of the build keys.
* ``sorted_probe`` emits, per probe key, the first matching build
  position (clipped into range when there is no match) and a match flag.
* ``sorted_probe_range`` is the duplicate-key variant: the lower and
  upper bound of the key's run ``[lo, hi)`` (``hi - lo`` is the match
  multiplicity) and the match flag.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/hash_join.cu``) and counts the launch in ``PROBE_LAUNCHES`` /
``PROBE_RANGE_LAUNCHES``; on a CPU tensor it runs the plain PyTorch
version beside it, which computes the same outputs bit for bit (the
global ``torch.searchsorted`` bound clipped into the key's bucket slice
IS the bucket-local bound the kernel searches for).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build as kbuild

NB_BITS = 16
NB = 1 << NB_BITS

_INT32_MAX = np.iinfo(np.int32).max

# Kernel launches (one per wrapper call that reaches the card).
PROBE_LAUNCHES = 0
PROBE_RANGE_LAUNCHES = 0


def prepare_buckets(build_sorted: np.ndarray) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """Host-side probe acceleration structure for a sorted int32 key array.

    Returns ``(scalars, starts)``: ``scalars = [bias, shift]`` (bucket of
    key k is ``(k - bias) >> shift``) and ``starts`` the NB+1 bucket
    boundary positions (``starts[NB]`` is the build length).
    """
    bs = np.ascontiguousarray(build_sorted, dtype=np.int32)
    s = len(bs)
    if s == 0:
        return np.asarray([0, 0], np.int32), np.zeros(NB + 1, np.int32)
    bias = int(bs[0])
    span = int(bs[-1]) - bias + 1        # may exceed int32 (full key span)
    shift = max(0, span.bit_length() - NB_BITS)
    bounds = bias + (np.arange(1, NB, dtype=np.int64) << shift)
    starts = np.empty(NB + 1, np.int32)
    starts[0], starts[NB] = 0, s
    # int64 bounds compare exactly against the int32 keys (no clipping:
    # a bound past INT32_MAX correctly maps its bucket start to s).
    starts[1:NB] = np.searchsorted(bs, bounds)
    return np.asarray([bias, shift], np.int32), starts


def _bucket_slices(keys, scalars, starts):
    bias, shift = int(scalars[0]), int(scalars[1])
    diff = (keys.to(torch.int64) - bias) & 0xFFFFFFFF   # uint32 wrap
    bucket = torch.clamp(diff >> shift, max=NB - 1)
    return starts[bucket].to(torch.int64), starts[bucket + 1].to(torch.int64)


def _match(build, keys, lo):
    s = build.shape[0]
    pos = torch.clamp(lo, max=s - 1)
    return pos, (build[pos] == keys) & (lo < s)


def sorted_probe_plain(build_sorted, keys, scalars, starts):
    """Plain PyTorch version of the probe kernel (same outputs)."""
    b_lo, b_hi = _bucket_slices(keys, scalars, starts)
    lo = torch.clamp(torch.searchsorted(build_sorted, keys), b_lo, b_hi)
    pos, match = _match(build_sorted, keys, lo)
    return pos.to(torch.int32), match


def sorted_probe_range_plain(build_sorted, keys, scalars, starts):
    """Plain PyTorch version of the range-probe kernel (same outputs)."""
    b_lo, b_hi = _bucket_slices(keys, scalars, starts)
    lo = torch.clamp(torch.searchsorted(build_sorted, keys), b_lo, b_hi)
    hi = torch.clamp(torch.searchsorted(build_sorted, keys, right=True),
                     b_lo, b_hi)
    _, match = _match(build_sorted, keys, lo)
    return lo.to(torch.int32), hi.to(torch.int32), match


def _prepare(build_sorted, keys, scalars, starts):
    for name, t in (("build_sorted", build_sorted), ("keys", keys)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if build_sorted.device != keys.device:
        raise ValueError("build_sorted and keys lie on different devices")
    if scalars is None:
        scalars, starts = prepare_buckets(build_sorted.cpu().numpy())
    starts = torch.as_tensor(starts, dtype=torch.int32, device=keys.device)
    if starts.shape != (NB + 1,):
        raise ValueError(f"starts must have shape ({NB + 1},)")
    return np.asarray(scalars), starts


def _cuda_args(build_sorted, keys, starts):
    for t in (build_sorted, keys, starts):
        if not t.is_contiguous():
            raise ValueError("probe inputs must be contiguous")
    if keys.shape[0] > _INT32_MAX or build_sorted.shape[0] > _INT32_MAX:
        raise ValueError("probe sizes must fit int32")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("hash_join")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.repro_probe.argtypes = [p, p, p, p, p, i64, i32, i32, i32, p]
        lib.repro_probe.restype = ctypes.c_int
        lib.repro_probe_range.argtypes = [p, p, p, p, p, p, i64, i32, i32,
                                          i32, p]
        lib.repro_probe_range.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def sorted_probe(build_sorted, keys, *, scalars=None, starts=None):
    """Lower-bound probe of int32 ``keys`` (n,) into sorted int32
    ``build_sorted`` (s,), both on one device.

    Returns ``(pos, match)``: ``pos[i]`` (int32) is the first build
    position whose key equals ``keys[i]`` (clipped into range when there
    is no match) and ``match[i]`` (bool) whether the key exists. The
    bucket structure (``prepare_buckets``) may be passed in to amortize
    it across calls; it is built on the fly otherwise.
    """
    global PROBE_LAUNCHES
    scalars, starts = _prepare(build_sorted, keys, scalars, starts)
    n, s = keys.shape[0], build_sorted.shape[0]
    if n == 0 or s == 0:      # no match; never launch an empty grid
        return (torch.zeros(n, dtype=torch.int32, device=keys.device),
                torch.zeros(n, dtype=torch.bool, device=keys.device))
    if keys.device.type == "cpu":
        return sorted_probe_plain(build_sorted, keys, scalars, starts)
    pos = torch.empty(n, dtype=torch.int32, device=keys.device)
    match = torch.empty(n, dtype=torch.uint8, device=keys.device)
    _cuda_args(build_sorted, keys, starts)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_probe(
            starts.data_ptr(), build_sorted.data_ptr(), keys.data_ptr(),
            pos.data_ptr(), match.data_ptr(), n, s, int(scalars[0]),
            int(scalars[1]), stream)
    kbuild.check(rc, "repro_probe")
    PROBE_LAUNCHES += 1
    return pos, match.view(torch.bool)


def sorted_probe_range(build_sorted, keys, *, scalars=None, starts=None):
    """Range probe of int32 ``keys`` (n,) into sorted int32
    ``build_sorted`` (s,), both on one device.

    Returns ``(lo, hi, match)``: ``[lo[i], hi[i])`` is the contiguous run
    of build positions whose key equals ``keys[i]`` (``hi - lo`` is the
    duplicate multiplicity, 0 when absent) and ``match[i]`` whether the
    key exists. Backs the compiled duplicate-key join expansion.
    """
    global PROBE_RANGE_LAUNCHES
    scalars, starts = _prepare(build_sorted, keys, scalars, starts)
    n, s = keys.shape[0], build_sorted.shape[0]
    if n == 0 or s == 0:      # no match; never launch an empty grid
        zeros = torch.zeros(n, dtype=torch.int32, device=keys.device)
        return (zeros, zeros.clone(),
                torch.zeros(n, dtype=torch.bool, device=keys.device))
    if keys.device.type == "cpu":
        return sorted_probe_range_plain(build_sorted, keys, scalars, starts)
    lo = torch.empty(n, dtype=torch.int32, device=keys.device)
    hi = torch.empty(n, dtype=torch.int32, device=keys.device)
    match = torch.empty(n, dtype=torch.uint8, device=keys.device)
    _cuda_args(build_sorted, keys, starts)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_probe_range(
            starts.data_ptr(), build_sorted.data_ptr(), keys.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), match.data_ptr(), n, s,
            int(scalars[0]), int(scalars[1]), stream)
    kbuild.check(rc, "repro_probe_range")
    PROBE_RANGE_LAUNCHES += 1
    return lo, hi, match.view(torch.bool)
