"""Deterministic segmented reduction over sorted, contiguous segments.

Backs the query engine's ``hash_agg`` in the torch backend: the compiler
lexsorts the group keys, so each group is one contiguous run of rows,
given by its row offsets; as ids, each group's id is non-decreasing
along the rows (``-1`` may only pad the tail).

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
(``csrc/segment_reduce.cu``), which runs two passes of the plan in one
launch (``_launch_plan``; one launch for every segment of up to
``CHUNK * CHUNK`` rows), counted in ``SEGMENT_REDUCE_LAUNCHES``. Every
launch's offsets reach the card in one pinned copy, and nothing waits
for the card before the result is returned. Given ids rather than
offsets, it first derives the offsets on the card (one launch, counted
in ``SEGMENT_OFFSETS_LAUNCHES``, and one wait for its copy to the host).
On a CPU tensor it runs the plain PyTorch version of the same passes,
which gives the same bits.
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
_LAYOUT_ERROR = ("segment ids must be sorted, within [0, num_segments), "
                 "with -1 only as tail padding")

# Kernel launches: one per launch of the reduction (each runs one or two
# passes), and one per derivation of offsets from ids on the card.
SEGMENT_REDUCE_LAUNCHES = 0
SEGMENT_OFFSETS_LAUNCHES = 0


def _combine(mode: str):
    if mode == "min":
        return torch.minimum
    if mode == "max":
        return torch.maximum
    return torch.add


def _offsets_plain(seg_ids: torch.Tensor, num_segments: int):
    """Plain version of the derivation kernel: ``(offsets, bad)``, the
    ``(num_segments + 1,)`` int64 row offsets (segment ``s`` starts at
    the first row whose id is at least ``s``, a ``-1`` counting as
    ``num_segments``) and whether any row breaks the layout (an id out of
    ``[-1, num_segments)``, a descending id, a -1 before a valid id)."""
    ids = seg_ids.to(torch.int64)
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    inner = torch.arange(ids.numel(), device=ids.device) > 0
    bad = (ids < -1) | (ids >= num_segments) \
        | ((ids >= 0) & inner & ((prev == -1) | (ids < prev)))
    key = torch.where(ids == -1, num_segments, ids)
    offsets = torch.searchsorted(
        key, torch.arange(num_segments + 1, device=ids.device))
    return offsets, bad.any()


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("segment_reduce")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.repro_segment_reduce_fold.argtypes = [p, i64, p, p, p, i32, i32,
                                                  i32, p, i64, p, i64, p,
                                                  i32, i32, p]
        lib.repro_segment_reduce_fold.restype = ctypes.c_int
        lib.repro_segment_offsets.argtypes = [p, i64, i32, p, i32, p]
        lib.repro_segment_offsets.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _offsets_cuda(seg_ids: torch.Tensor, num_segments: int):
    global SEGMENT_OFFSETS_LAUNCHES
    n, device = seg_ids.numel(), seg_ids.device
    if n >= _INT32_MAX:
        raise ValueError("segment_reduce rows must fit int32")
    ids = seg_ids.contiguous()
    dev = torch.zeros(num_segments + 2, dtype=torch.int32, device=device)
    rc = _lib().repro_segment_offsets(
        ids.data_ptr(), n, num_segments, dev.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    kbuild.check(rc, "repro_segment_offsets")
    SEGMENT_OFFSETS_LAUNCHES += 1
    host = torch.empty(num_segments + 2, dtype=torch.int32, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    out = host.numpy().astype(np.int64)
    return out[:-1], bool(out[-1])


def segment_offsets(seg_ids: torch.Tensor, num_segments: int) -> np.ndarray:
    """Host ``(num_segments + 1,)`` int64 row offsets of each segment, from
    sorted ids: on the card for a CUDA tensor, else the plain version.
    Validates the layout the kernel relies on: ids non-decreasing and in
    ``[0, num_segments)``, with ``-1`` only as tail padding."""
    if seg_ids.device.type == "cpu":
        offsets, bad = _offsets_plain(seg_ids, num_segments)
        offsets, bad = offsets.numpy(), bool(bad)
    else:
        offsets, bad = _offsets_cuda(seg_ids, num_segments)
    if bad:
        raise ValueError(_LAYOUT_ERROR)
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
    offsets, bad = _offsets_plain(seg_ids, num_segments)
    if bool(bad):
        raise ValueError(_LAYOUT_ERROR)
    return _reduce_plain(vals, offsets.cpu().numpy(), mode)


def _launch_plan(offsets: np.ndarray, mode: str):
    """The CUDA path's host plan: one int32 array ``packed`` holding the
    chain of the passes' offsets (pass ``p`` reads rows by ``chain[p]``
    and writes chunks by ``chain[p + 1]``) followed by every launch's
    zeroed counters, and per launch ``(p, fold, mode, blocks, outputs,
    counters_at)``: launch ``i`` runs pass ``p = 2 i`` (in ``mode``) over
    ``blocks`` chunks and, with ``fold``, pass ``p + 1`` too, whose
    ``outputs`` counters start at ``counters_at`` in ``packed``."""
    passes = reduction_passes(offsets)
    chain = [passes[0][0]] + [co for _, co in passes]
    modes = [m for m, _ in zip(_pass_modes(mode), passes)]
    launches, at = [], len(chain) * len(offsets)
    for p in range(0, len(passes), 2):
        fold = p + 1 < len(passes)
        blocks = int(chain[p + 1][-1])
        outputs = int(chain[p + 2][-1]) if fold else blocks
        launches.append((p, fold, modes[p], blocks, outputs, at))
        at += outputs if fold else 0
    packed = np.zeros(at, np.int32)
    packed[:len(chain) * len(offsets)] = np.concatenate(chain)
    return packed, launches


def _reduce_cuda(vals, offsets, mode: str):
    global SEGMENT_REDUCE_LAUNCHES
    if not vals.is_contiguous():
        raise ValueError("segment_reduce values must be contiguous")
    device, c = vals.device, vals.shape[0]
    s1 = len(offsets)
    packed, launches = _launch_plan(offsets, mode)
    host = torch.empty(len(packed), dtype=torch.int32, pin_memory=True)
    host.numpy()[:] = packed
    plan = host.to(device, non_blocking=True)
    base = plan.data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    out = vals
    for p, fold, m, blocks, outputs, at in launches:
        partial = torch.empty((c, blocks), dtype=torch.float32,
                              device=device)
        nxt = torch.empty((c, outputs), dtype=torch.float32,
                          device=device) if fold else partial
        rc = lib.repro_segment_reduce_fold(
            out.data_ptr(), out.stride(0), base + 4 * s1 * p,
            base + 4 * s1 * (p + 1),
            base + 4 * s1 * (p + 2) if fold else None, s1 - 1, c, _MODES[m],
            partial.data_ptr(), partial.stride(0), nxt.data_ptr(),
            nxt.stride(0), base + 4 * at if fold else None, blocks,
            device.index, stream)
        kbuild.check(rc, "repro_segment_reduce_fold")
        SEGMENT_REDUCE_LAUNCHES += 1
        out = nxt
    return out


def segment_reduce(vals, seg_ids=None, *, num_segments=None,
                   mode: str = "sum", offsets=None):
    """Reduce float32 ``vals`` into segments of contiguous rows, given
    either by sorted int32 ``seg_ids`` (n,) on the values' device with
    ``num_segments``, or by host ``offsets``, the ``(S + 1,)`` int64 row
    offsets of the segments (``offsets[s]`` to ``offsets[s + 1]``; rows
    from ``offsets[-1]`` on are ignored).

    ``vals`` is ``(n,)`` for one column or ``(C, n)`` for a stack of
    columns reduced together (one launch for all of them). Ids are
    non-decreasing in ``[0, num_segments)``; ``-1`` pads the tail and is
    ignored. Returns float32 ``(S,)`` / ``(C, S)``; an empty segment holds
    the mode's identity. ``mode``: sum | count | min | max.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown reduction mode {mode!r}")
    if vals.dtype != torch.float32:
        raise ValueError("segment_reduce takes float32 values")
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[None, :]
    if vals.dim() != 2:
        raise ValueError(f"vals {tuple(vals.shape)} is not (n,) or (C, n)")
    n = vals.shape[1]
    if n > _INT32_MAX:
        raise ValueError("segment_reduce rows must fit int32")
    if (seg_ids is None) == (offsets is None):
        raise ValueError("segment_reduce takes seg_ids or offsets")
    if offsets is None:
        if seg_ids.dtype != torch.int32 or seg_ids.shape != (n,):
            raise ValueError(f"seg_ids {tuple(seg_ids.shape)} "
                             f"{seg_ids.dtype} are no int32 ids of the "
                             f"{n} rows of vals")
        if vals.device != seg_ids.device:
            raise ValueError("vals and seg_ids lie on different devices")
        offsets = segment_offsets(seg_ids, num_segments)
    else:
        offsets = np.asarray(offsets, dtype=np.int64)
        if offsets.ndim != 1 or len(offsets) == 0 or offsets[0] != 0 \
                or offsets[-1] > n or (np.diff(offsets) < 0).any():
            raise ValueError("segment offsets must rise from 0 to at most "
                             "the row count")
        if num_segments is not None and num_segments != len(offsets) - 1:
            raise ValueError(f"{len(offsets) - 1} segments by offsets, "
                             f"{num_segments} by num_segments")
    num_segments = len(offsets) - 1
    if num_segments == 0 or vals.shape[0] == 0 or offsets[-1] == 0:
        # Nothing to fold: never launch an empty grid.
        out = torch.full((vals.shape[0], num_segments), _IDENTITY[mode],
                         dtype=torch.float32, device=vals.device)
    elif vals.device.type == "cpu":
        out = _reduce_plain(vals, offsets, mode)
    else:
        out = _reduce_cuda(vals, offsets, mode)
    return out[0] if squeeze else out
