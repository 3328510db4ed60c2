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

``probe_table`` runs ``prepare_buckets`` once per build side and holds
what every launch needs (``ProbeTable``: the bucket starts on the
build's device, ``bias`` and ``shift`` as ints, the device's index), so a
probe call that is handed one does no host-to-device copy and no numpy
conversion; without one, the wrappers build it per call.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/hash_join.cu``, which selects the device itself, so no device
context is entered) and counts the launch in ``PROBE_LAUNCHES`` /
``PROBE_RANGE_LAUNCHES``; on a CPU tensor it runs the plain PyTorch
version beside it, which computes the same outputs bit for bit (the
global ``torch.searchsorted`` bound clipped into the key's bucket slice
IS the bucket-local bound the kernel searches for).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

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


class ProbeTable(NamedTuple):
    """What a probe launch needs of one sorted build side: the NB+1
    bucket ``starts`` (int32, contiguous, on the build's device), ``bias``
    and ``shift`` as Python ints, and ``device_index``, the CUDA device's
    index (-1 on the CPU)."""
    starts: torch.Tensor
    bias: int
    shift: int
    device_index: int


def probe_table(build_sorted: np.ndarray, device) -> ProbeTable:
    """The bucket table of a sorted int32 key array (``prepare_buckets``)
    with its starts on ``device``: made once per build side and passed to
    every ``sorted_probe`` / ``sorted_probe_range`` of it as ``table``."""
    scalars, starts = prepare_buckets(build_sorted)
    starts = torch.as_tensor(starts, device=device).contiguous()
    return ProbeTable(starts, int(scalars[0]), int(scalars[1]),
                      starts.get_device())


def _resolve(build_sorted, keys, table):
    """Checks the inputs; returns the bucket table (``table`` as given,
    or, without one, one made from the build keys) and the keys' device
    index (-1 on the CPU)."""
    for name, t in (("build_sorted", build_sorted), ("keys", keys)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    dev = keys.get_device()
    if build_sorted.get_device() != dev:
        raise ValueError("build_sorted and keys lie on different devices")
    if table is None:
        table = probe_table(build_sorted.cpu().numpy(), keys.device)
    elif table.device_index != dev:
        raise ValueError("the bucket table lies on another device than "
                         "the keys")
    return table, dev


def _cuda_args(build_sorted, keys):
    if not (build_sorted.is_contiguous() and keys.is_contiguous()):
        raise ValueError("probe inputs must be contiguous")
    if keys.shape[0] > _INT32_MAX or build_sorted.shape[0] > _INT32_MAX:
        raise ValueError("probe sizes must fit int32")


_PROBE = _PROBE_RANGE = None


def _fns():
    """The two C entry points, bound once."""
    global _PROBE, _PROBE_RANGE
    if _PROBE is None:
        lib = kbuild.load("hash_join")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.repro_probe.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i32,
                                    p]
        lib.repro_probe_range.argtypes = [p, p, p, p, p, p, i64, i32, i32,
                                          i32, i32, p]
        lib.repro_probe.restype = lib.repro_probe_range.restype = ctypes.c_int
        _PROBE, _PROBE_RANGE = lib.repro_probe, lib.repro_probe_range
    return _PROBE, _PROBE_RANGE


def sorted_probe(build_sorted, keys, *, table=None):
    """Lower-bound probe of int32 ``keys`` (n,) into sorted int32
    ``build_sorted`` (s,), both on one device.

    Returns ``(pos, match)``: ``pos[i]`` (int32) is the first build
    position whose key equals ``keys[i]`` (clipped into range when there
    is no match) and ``match[i]`` (bool) whether the key exists. The
    bucket table is ``table`` (``probe_table``, made once per build side)
    or, without one, is made from ``build_sorted`` on every call.
    """
    global PROBE_LAUNCHES
    table, dev = _resolve(build_sorted, keys, table)
    n, s = keys.shape[0], build_sorted.shape[0]
    if n == 0 or s == 0:      # no match; never launch an empty grid
        return (torch.zeros(n, dtype=torch.int32, device=keys.device),
                torch.zeros(n, dtype=torch.bool, device=keys.device))
    if dev < 0:
        return sorted_probe_plain(build_sorted, keys,
                                  (table.bias, table.shift), table.starts)
    _cuda_args(build_sorted, keys)
    pos = torch.empty_like(keys)
    match = torch.empty_like(keys, dtype=torch.bool)
    rc = _fns()[0](
        table.starts.data_ptr(), build_sorted.data_ptr(), keys.data_ptr(),
        pos.data_ptr(), match.data_ptr(), n, s, table.bias, table.shift,
        table.device_index,
        torch.cuda.current_stream(table.device_index).cuda_stream)
    kbuild.check(rc, "repro_probe")
    PROBE_LAUNCHES += 1
    return pos, match


def sorted_probe_range(build_sorted, keys, *, table=None):
    """Range probe of int32 ``keys`` (n,) into sorted int32
    ``build_sorted`` (s,), both on one device.

    Returns ``(lo, hi, match)``: ``[lo[i], hi[i])`` is the contiguous run
    of build positions whose key equals ``keys[i]`` (``hi - lo`` is the
    duplicate multiplicity, 0 when absent) and ``match[i]`` whether the
    key exists. Backs the compiled duplicate-key join expansion. The
    bucket table is resolved as in ``sorted_probe``.
    """
    global PROBE_RANGE_LAUNCHES
    table, dev = _resolve(build_sorted, keys, table)
    n, s = keys.shape[0], build_sorted.shape[0]
    if n == 0 or s == 0:      # no match; never launch an empty grid
        zeros = torch.zeros(n, dtype=torch.int32, device=keys.device)
        return (zeros, zeros.clone(),
                torch.zeros(n, dtype=torch.bool, device=keys.device))
    if dev < 0:
        return sorted_probe_range_plain(build_sorted, keys,
                                        (table.bias, table.shift),
                                        table.starts)
    _cuda_args(build_sorted, keys)
    lo = torch.empty_like(keys)
    hi = torch.empty_like(keys)
    match = torch.empty_like(keys, dtype=torch.bool)
    rc = _fns()[1](
        table.starts.data_ptr(), build_sorted.data_ptr(), keys.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), match.data_ptr(), n, s, table.bias,
        table.shift, table.device_index,
        torch.cuda.current_stream(table.device_index).cuda_stream)
    kbuild.check(rc, "repro_probe_range")
    PROBE_RANGE_LAUNCHES += 1
    return lo, hi, match
