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
what every launch needs (``ProbeTable``): the build keys and the bucket
starts on the build's device, ``bias`` and ``shift``, the device's index
and a ctypes block with all of it, so a probe call handed its table
checks and passes only the keys, the outputs and the stream. Without
one, the wrappers build it per call.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/hash_join.cu``: one key a thread, the 64K-bucket starts and the
build keys read through L2) and counts the launch in ``PROBE_LAUNCHES``
/ ``PROBE_RANGE_LAUNCHES``; a launch that fails raises. On a CPU tensor
it runs the plain PyTorch version beside it, which computes the same
outputs bit for bit (the global ``torch.searchsorted`` bound clipped into
the key's bucket slice IS the bucket-local bound the kernel searches
for).
"""
from __future__ import annotations

import ctypes
import functools
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


class _TableArgs(ctypes.Structure):
    """``TableArgs`` of ``csrc/hash_join.cu``: what a launch needs of one
    build side."""
    _fields_ = [("starts", ctypes.c_void_p), ("build", ctypes.c_void_p),
                ("s", ctypes.c_int32), ("bias", ctypes.c_int32),
                ("shift", ctypes.c_int32), ("device", ctypes.c_int32),
                ("sms", ctypes.c_int32)]


class ProbeTable(NamedTuple):
    """What a probe launch needs of one sorted build side: the NB+1
    bucket ``starts`` (int32, contiguous, on the build's device), ``bias``
    and ``shift`` as Python ints, and ``device_index``, the CUDA device's
    index (-1 on the CPU). ``probe_table`` also fills in ``build``, the
    build keys the table indexes (a call must pass these), and ``args``,
    the ctypes block the C entry points read, at address ``args_ptr``."""
    starts: torch.Tensor
    bias: int
    shift: int
    device_index: int
    build: torch.Tensor | None = None
    args: _TableArgs | None = None
    args_ptr: int = 0


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index`` (0 for
    the CPU)."""
    if device_index < 0:
        return 0
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_keys(name, t):
    if t.dtype != torch.int32 or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")


def probe_table(build_sorted, device=None) -> ProbeTable:
    """The probe table of a sorted int32 build side, made once and passed
    to every ``sorted_probe`` / ``sorted_probe_range`` of it as ``table``:
    a numpy array's keys copied to ``device``, or a 1-D int32 tensor taken
    as it is on its own device (the calls then pass that tensor)."""
    if isinstance(build_sorted, torch.Tensor):
        build = build_sorted
        _check_keys("build_sorted", build)
        host = build.cpu().numpy()
    else:
        host = np.ascontiguousarray(build_sorted, dtype=np.int32)
        build = torch.from_numpy(host)
        if device is not None:
            build = build.to(device)
    dev, s = build.get_device(), build.shape[0]
    if dev >= 0 and not build.is_contiguous():
        raise ValueError("probe inputs must be contiguous")
    if s > _INT32_MAX:
        raise ValueError("probe sizes must fit int32")
    scalars, starts = prepare_buckets(host)
    starts_t = torch.as_tensor(starts, device=build.device).contiguous()
    bias, shift = int(scalars[0]), int(scalars[1])
    args = _TableArgs(starts_t.data_ptr(), build.data_ptr(), s, bias, shift,
                      dev, _sms(dev))
    return ProbeTable(starts_t, bias, shift, dev, build, args,
                      ctypes.addressof(args))


def _checked(build_sorted, keys, table) -> ProbeTable:
    """Checks the inputs; returns the table (``table`` as given, or,
    without one, one made from the build keys). The build keys of a table
    that ``probe_table`` made were checked then; a call given it must pass
    them (the same tensor, or one over the same memory)."""
    _check_keys("keys", keys)
    if table is None or build_sorted is not table.build:
        _check_keys("build_sorted", build_sorted)
        if build_sorted.get_device() != keys.get_device():
            raise ValueError("build_sorted and keys lie on different devices")
        if table is None:
            table = probe_table(build_sorted)
        elif table.build is not None and not (
                build_sorted.data_ptr() == table.build.data_ptr()
                and build_sorted.shape == table.build.shape):
            raise ValueError("the bucket table was made from other build "
                             "keys than build_sorted")
    if table.device_index != keys.get_device():
        raise ValueError("the bucket table lies on another device than "
                         "the keys")
    return table


def _cuda_checked(keys, n: int, table) -> None:
    """The checks only a launch needs."""
    if not keys.is_contiguous():
        raise ValueError("probe inputs must be contiguous")
    if n > _INT32_MAX:
        raise ValueError("probe sizes must fit int32")
    if not table.args_ptr:
        raise ValueError("a table for the card is made by probe_table")


_FNS = {}
_STREAM = None


def _fns():
    """The C entry points by kind (range probe or not), bound once, and
    the current raw stream of a device."""
    global _STREAM
    if not _FNS:
        lib = kbuild.load("hash_join")
        p = ctypes.c_void_p
        for rng, fn in ((False, lib.repro_probe),
                        (True, lib.repro_probe_range)):
            # table, keys, the 2 or 3 outputs, n, stream
            fn.argtypes = [p] * (5 if rng else 4) + [ctypes.c_int32, p]
            fn.restype = ctypes.c_int
            _FNS[rng] = fn
        _STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _FNS


def _launch(table, keys, n: int, range_: bool) -> tuple:
    """Launches the kernel on the current stream of the table's device;
    returns the outputs, one tensor each (measured cheaper on the host
    than views of one buffer)."""
    _cuda_checked(keys, n, table)
    dev = table.device_index
    fn = (_FNS or _fns())[range_]
    lo = keys.new_empty(n)
    match = keys.new_empty(n, dtype=torch.bool)
    if range_:
        hi = keys.new_empty(n)
        out = (lo, hi, match)
        rc = fn(table.args_ptr, keys.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), match.data_ptr(), n, _STREAM(dev))
    else:
        out = (lo, match)
        rc = fn(table.args_ptr, keys.data_ptr(), lo.data_ptr(),
                match.data_ptr(), n, _STREAM(dev))
    if rc:
        kbuild.check(rc, f"repro_probe{'_range' if range_ else ''}")
    return out


def sorted_probe(build_sorted, keys, *, table=None):
    """Lower-bound probe of int32 ``keys`` (n,) into sorted int32
    ``build_sorted`` (s,), both on one device.

    Returns ``(pos, match)``: ``pos[i]`` (int32) is the first build
    position whose key equals ``keys[i]`` (clipped into range when there
    is no match) and ``match[i]`` (bool) whether the key exists. The
    table is ``table`` (``probe_table``, made once per build side) or,
    without one, is made from ``build_sorted`` on every call.
    """
    global PROBE_LAUNCHES
    table = _checked(build_sorted, keys, table)
    n, s = keys.numel(), build_sorted.numel()
    if n == 0 or s == 0:      # no match; never launch an empty grid
        return (torch.zeros(n, dtype=torch.int32, device=keys.device),
                torch.zeros(n, dtype=torch.bool, device=keys.device))
    if table.device_index < 0:
        return sorted_probe_plain(build_sorted, keys,
                                  (table.bias, table.shift), table.starts)
    out = _launch(table, keys, n, False)
    PROBE_LAUNCHES += 1
    return out


def sorted_probe_range(build_sorted, keys, *, table=None):
    """Range probe of int32 ``keys`` (n,) into sorted int32
    ``build_sorted`` (s,), both on one device.

    Returns ``(lo, hi, match)``: ``[lo[i], hi[i])`` is the contiguous run
    of build positions whose key equals ``keys[i]`` (``hi - lo`` is the
    duplicate multiplicity, 0 when absent) and ``match[i]`` whether the
    key exists. Backs the compiled duplicate-key join expansion. The
    table is resolved as in ``sorted_probe``.
    """
    global PROBE_RANGE_LAUNCHES
    table = _checked(build_sorted, keys, table)
    n, s = keys.numel(), build_sorted.numel()
    if n == 0 or s == 0:      # no match; never launch an empty grid
        zeros = torch.zeros(n, dtype=torch.int32, device=keys.device)
        return (zeros, zeros.clone(),
                torch.zeros(n, dtype=torch.bool, device=keys.device))
    if table.device_index < 0:
        return sorted_probe_range_plain(build_sorted, keys,
                                        (table.bias, table.shift),
                                        table.starts)
    out = _launch(table, keys, n, True)
    PROBE_RANGE_LAUNCHES += 1
    return out
