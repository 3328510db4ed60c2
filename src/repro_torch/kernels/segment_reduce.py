"""Deterministic segmented reduction over sorted, contiguous segments.

Backs the query engine's ``hash_agg`` in the torch backend: the compiler
lexsorts the group keys, so each group is one contiguous run of rows and
its id is non-decreasing along the rows (``-1`` may only pad the tail).

The reduction is a fixed pairwise tree, the same on both paths: each
segment splits into chunks of ``CHUNK`` rows, each chunk folds with a
power-of-two halving tree (slot ``i`` absorbs slot ``i + m`` for
``m = CHUNK/2, ..., 1``; empty slots hold the identity), and the chunk
partials fold again the same way until one value per segment is left.
A float32 sum over ``k`` rows so loses ``O(log2 k * eps)`` relative
precision instead of a sequential sum's ``O(k * eps)`` -- what keeps
aggregates within rtol = 1e-6 of the float64 reference backend. No float
atomics: the association depends only on the row layout, so results are
reproducible bit for bit. Min and max are exact in any order.

On a CUDA tensor ``segment_reduce`` launches the hand-written kernel
(``csrc/segment_reduce.cu``, one launch per pass, counted in
``SEGMENT_REDUCE_LAUNCHES``); on a CPU tensor it runs the plain PyTorch
version of the same passes, which gives the same bits.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build as kbuild

CHUNK = 1024          # rows folded by one CUDA block (a power of two)

_MODES = {"sum": 0, "count": 1, "min": 2, "max": 3}
_IDENTITY = {"sum": 0.0, "count": 0.0, "min": math.inf, "max": -math.inf}

_INT32_MAX = np.iinfo(np.int32).max

# Kernel launches (one per reduction pass that reaches the card).
SEGMENT_REDUCE_LAUNCHES = 0


def _combine(mode: str):
    if mode == "min":
        return torch.minimum
    if mode == "max":
        return torch.maximum
    return torch.add


def segment_offsets(seg_ids: torch.Tensor, num_segments: int) -> np.ndarray:
    """Host ``(num_segments + 1,)`` int64 row offsets of each segment.
    Validates the layout the kernel relies on: ids non-decreasing and in
    ``[0, num_segments)``, with ``-1`` only as tail padding."""
    n_valid = int((seg_ids >= 0).sum())
    ids = seg_ids[:n_valid]
    bad = (ids[1:] < ids[:-1]).any() | (ids >= num_segments).any() \
        | (ids < 0).any() | (seg_ids[n_valid:] != -1).any()
    if bool(bad):
        raise ValueError("segment ids must be sorted, within "
                         "[0, num_segments), with -1 only as tail padding")
    counts = torch.bincount(ids.to(torch.int64), minlength=num_segments)
    offsets = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=offsets[1:])
    return offsets


def reduction_passes(offsets: np.ndarray):
    """The pass plan: ``[(offsets, chunk_offsets), ...]`` per pass. Every
    segment gets at least one chunk (an empty one reduces to the
    identity), and the last pass leaves exactly one value per segment."""
    plan = []
    while True:
        counts = np.diff(offsets)
        chunks = np.maximum(1, -(-counts // CHUNK))
        chunk_offsets = np.zeros(len(offsets), np.int64)
        np.cumsum(chunks, out=chunk_offsets[1:])
        plan.append((offsets, chunk_offsets))
        if counts.max(initial=0) <= CHUNK:
            return plan
        offsets = chunk_offsets


def _pass_plain(vals, offsets, chunk_offsets, mode):
    """One reduction pass in plain PyTorch, folding exactly as the kernel
    block does."""
    c, device = vals.shape[0], vals.device
    counts = torch.as_tensor(np.diff(offsets), device=device)
    seg = torch.repeat_interleave(
        torch.arange(len(counts), device=device), counts)
    n = int(offsets[-1])
    j = torch.arange(n, device=device) - torch.as_tensor(
        offsets[:-1], device=device)[seg]
    slot = torch.as_tensor(chunk_offsets[:-1], device=device)[seg] * CHUNK \
        + (j // CHUNK) * CHUNK + j % CHUNK
    total = int(chunk_offsets[-1])
    buf = torch.full((c, total * CHUNK), _IDENTITY[mode],
                     dtype=torch.float32, device=device)
    buf[:, slot] = torch.ones_like(vals[:, :n]) if mode == "count" \
        else vals[:, :n]
    t = buf.view(c, total, CHUNK)
    comb = _combine(mode)
    m = CHUNK
    while m > 1:
        m //= 2
        t = comb(t[..., :m], t[..., m:2 * m])
    return t[..., 0]


def _pass_modes(mode: str):
    """Mode of each pass: counts become sums of the chunk counts."""
    yield mode
    while True:
        yield "sum" if mode == "count" else mode


def _reduce_plain(vals, offsets, mode: str):
    out = vals
    for (offs, chunk_offsets), m in zip(reduction_passes(offsets),
                                        _pass_modes(mode)):
        out = _pass_plain(out, offs, chunk_offsets, m)
    return out


def segment_reduce_plain(vals, seg_ids, num_segments: int, mode: str):
    """Plain PyTorch version of the kernel on ``(C, n)`` values with at
    least one valid row: same passes, same bits."""
    return _reduce_plain(vals, segment_offsets(seg_ids, num_segments), mode)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("segment_reduce")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.repro_segment_reduce_pass.argtypes = [p, i64, p, p, i32, i32,
                                                  i32, p, i64, i32, p]
        lib.repro_segment_reduce_pass.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _reduce_cuda(vals, offsets, mode: str):
    global SEGMENT_REDUCE_LAUNCHES
    if not vals.is_contiguous():
        raise ValueError("segment_reduce values must be contiguous")
    if vals.shape[1] > _INT32_MAX:
        raise ValueError("segment_reduce rows must fit int32")
    device = vals.device
    num_segments = len(offsets) - 1
    out = vals
    with torch.cuda.device(device):
        lib = _lib()
        stream = torch.cuda.current_stream().cuda_stream
        for (offs, chunk_offsets), pass_mode in zip(
                reduction_passes(offsets), _pass_modes(mode)):
            off = torch.as_tensor(offs.astype(np.int32), device=device)
            co = torch.as_tensor(chunk_offsets.astype(np.int32),
                                 device=device)
            blocks = int(chunk_offsets[-1])
            nxt = torch.empty((vals.shape[0], blocks), dtype=torch.float32,
                              device=device)
            rc = lib.repro_segment_reduce_pass(
                out.data_ptr(), out.stride(0), off.data_ptr(), co.data_ptr(),
                num_segments, vals.shape[0], _MODES[pass_mode],
                nxt.data_ptr(), nxt.stride(0), blocks, stream)
            kbuild.check(rc, "repro_segment_reduce_pass")
            SEGMENT_REDUCE_LAUNCHES += 1
            out = nxt
    return out


def segment_reduce(vals, seg_ids, *, num_segments: int, mode: str = "sum"):
    """Reduce float32 ``vals`` into ``num_segments`` slots by sorted int32
    ``seg_ids`` (n,), both on one device.

    ``vals`` is ``(n,)`` for one column or ``(C, n)`` for a stack of
    columns reduced together (one launch per pass for all of them). Ids
    are non-decreasing in ``[0, num_segments)``; ``-1`` pads the tail and
    is ignored. Returns float32 ``(num_segments,)`` / ``(C,
    num_segments)``; an empty segment holds the mode's identity.
    ``mode``: sum | count | min | max.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown reduction mode {mode!r}")
    if vals.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise ValueError("segment_reduce takes float32 values and int32 ids")
    if vals.device != seg_ids.device:
        raise ValueError("vals and seg_ids lie on different devices")
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[None, :]
    if vals.dim() != 2 or seg_ids.shape != (vals.shape[1],):
        raise ValueError(f"vals {tuple(vals.shape)} and seg_ids "
                         f"{tuple(seg_ids.shape)} do not line up")
    offsets = segment_offsets(seg_ids, num_segments)
    if num_segments == 0 or vals.shape[0] == 0 or offsets[-1] == 0:
        # Nothing to fold: never launch an empty grid.
        out = torch.full((vals.shape[0], num_segments), _IDENTITY[mode],
                         dtype=torch.float32, device=vals.device)
    elif vals.device.type == "cpu":
        out = _reduce_plain(vals, offsets, mode)
    else:
        out = _reduce_cuda(vals, offsets, mode)
    return out[0] if squeeze else out
