"""The RWKV-6 WKV scan: ``o_t = r_t (S + diag(u) k_t v_t^T)``,
``S <- diag(exp(log_w_t)) S + k_t v_t^T``.

Backs ``models.rwkv6.rwkv_time_mix`` under ``impl="flash"``: takes the
model layout, r/k/v/log_w (B, S, H, K|V), u (H, K), s0 (B, H, K, V)
float32, and returns o (B, S, H, V) in r's dtype and s_final
(B, H, K, V) float32, for any S (no padding to a whole chunk, which the
reference's ``ops.rwkv6_scan`` needed).

On a CUDA tensor ``rwkv6_scan`` launches one of two hand-written
kernels, both reading the inputs through their strides, chosen by
``_route`` from the dtype and head dims alone: K = V = 64 (every served
shape) takes the chunk-parallel tensor-core kernel
(``csrc/rwkv6_scan_tc.cu``, ``"tc"``: 64-step chunks, decays as products
of per-step decays, operands split hi + lo, in bf16 parts for bf16 inputs
and TF32 parts for float32); other K, V take the kernel that steps the
recurrence one token at a time (``csrc/rwkv6_scan.cu``, ``"seq"``: V
tiled over the grid, so any V; K up to ``SEQ_MAX_K``, a thread's K / 4
state rows in registers and a chunk's K-wide rows of r, k and w in shared
memory; ``card_limit`` says what the card refuses). Every launch counts in
``RWKV6_SCAN_LAUNCHES``, the tensor-core ones also in
``RWKV6_SCAN_TC_LAUNCHES``. On a CPU tensor it runs the plain version,
the vectorised chunked oracle ``ref.rwkv6_chunked_ref`` with its exact
pairwise decays. ``ref.rwkv6_step_ref`` is the ground truth of all.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import rwkv6_chunked_ref as rwkv6_scan_plain

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "RWKV6_SCAN_LAUNCHES",
           "RWKV6_SCAN_TC_LAUNCHES", "SEQ_MAX_K", "card_limit"]

SEQ_MAX_K = 256      # the seq kernel's largest K (its kMaxK)
SEQ_TILE_V = 64      # state columns a block of the seq kernel (kTileV)
_MAX_GRID_Y = 65535  # CUDA's limit on a grid's second dimension
TC_HEAD_DIM = 64     # the tensor-core kernel's K and V

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call that reaches the card), and those
# of them on the tensor-core route.
RWKV6_SCAN_LAUNCHES = 0
RWKV6_SCAN_TC_LAUNCHES = 0


def _route(dtype, k: int, v: int) -> str:
    """The kernel for r of ``dtype`` and head dims ``k``, ``v``: ``"tc"``
    (chunk-parallel on the tensor cores, at both dtypes) at K = V = 64,
    else ``"seq"`` (one step at a time on the CUDA cores)."""
    return "tc" if k == v == TC_HEAD_DIM else "seq"


def card_limit(k: int, v: int) -> str | None:
    """Why the card refuses head dims ``k``, ``v``, or None if it takes
    them: the seq kernel holds K / 4 state rows a thread in registers
    and a chunk's K-wide rows of r, k and w in one block's shared memory,
    so K is at most ``SEQ_MAX_K``; V is tiled over the grid's second
    dimension, up to its 65,535 tiles of ``SEQ_TILE_V`` columns."""
    if k > SEQ_MAX_K:
        return (f"the rwkv6 kernel takes K up to {SEQ_MAX_K} (a block's "
                f"registers and shared memory), not {k}")
    if -(-v // SEQ_TILE_V) > _MAX_GRID_Y:
        return (f"the rwkv6 kernel takes V up to {_MAX_GRID_Y * SEQ_TILE_V} "
                f"(the grid's second dimension), not {v}")
    return None


def _check(r, k, v, log_w, u, s0):
    if r.dim() != 4 or k.shape != r.shape or log_w.shape != r.shape:
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)} and log_w "
                         f"{tuple(log_w.shape)} must be one (B, S, H, K) "
                         "shape")
    b, s, h, kd = r.shape
    if v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} does not line up with r "
                         f"{tuple(r.shape)}")
    vd = v.shape[3]
    if u.shape != (h, kd) or s0.shape != (b, h, kd, vd):
        raise ValueError(f"u {tuple(u.shape)} or s0 {tuple(s0.shape)} does "
                         f"not fit (H, K) = {(h, kd)}, V = {vd}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("rwkv6_scan takes float32 or bfloat16 r, k, v of "
                         "one dtype")
    if not (log_w.dtype == u.dtype == s0.dtype == torch.float32):
        raise ValueError("rwkv6_scan takes float32 log_w, u and s0")
    if len({t.device for t in (r, k, v, log_w, u, s0)}) != 1:
        raise ValueError("rwkv6_scan's inputs lie on different devices")


_LIBS = {}


def _lib(route: str):
    lib = _LIBS.get(route)
    if lib is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        if route == "tc":
            lib = kbuild.load("rwkv6_scan_tc")
            fn = lib.repro_rwkv6_scan_tc
            fn.argtypes = [p] * 9 + [i32] * 4 + [p]
        else:
            lib = kbuild.load("rwkv6_scan")
            fn = lib.repro_rwkv6_scan
            fn.argtypes = [p] * 9 + [i32] * 6 + [p]
        fn.restype = ctypes.c_int
        _LIBS[route] = lib
    return lib


def _aligned_rows(t):
    """``t`` itself if every (batch, step, head) row starts on 16 bytes,
    as the tensor-core kernel's asynchronous copies need; else a
    contiguous copy."""
    unit = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(t.stride(i) % unit == 0
                                      for i in range(3)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _scan_cuda(r, k, v, log_w, u, s0):
    global RWKV6_SCAN_LAUNCHES, RWKV6_SCAN_TC_LAUNCHES
    b, s, h, kd = r.shape
    vd = v.shape[3]
    limit = card_limit(kd, vd)
    if limit is not None:
        raise ValueError(limit)
    route = _route(r.dtype, kd, vd)
    u, s0 = u.contiguous(), s0.contiguous()
    o = torch.empty((b, s, h, vd), dtype=r.dtype, device=r.device)
    s_final = torch.empty_like(s0)
    if b * h * kd * vd == 0:      # nothing to launch; an empty sum is 0
        return o.zero_(), s_final
    ins = (r, k, v, log_w)
    if any(t.stride(3) != 1 for t in ins):
        raise ValueError("rwkv6_scan needs a contiguous last dim")
    if route == "tc":
        ins = tuple(_aligned_rows(t) for t in ins)
    strides = [t.stride(i) for t in (*ins, o) for i in range(3)]
    st = (ctypes.c_int64 * 15)(*strides)
    ptrs = [t.data_ptr() for t in (*ins, u, s0, o, s_final)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc":
            rc = _lib(route).repro_rwkv6_scan_tc(
                *ptrs, st, b, h, s, _DTYPES[r.dtype], stream)
        else:
            rc = _lib(route).repro_rwkv6_scan(
                *ptrs, st, b, h, s, kd, vd, _DTYPES[r.dtype], stream)
    kbuild.check(rc, f"repro_rwkv6_scan ({route})")
    RWKV6_SCAN_LAUNCHES += 1
    RWKV6_SCAN_TC_LAUNCHES += int(route == "tc")
    return o, s_final


def rwkv6_scan(r, k, v, log_w, u, s0, *, chunk: int = 64):
    """r/k/log_w: (B, S, H, K); v: (B, S, H, V); u: (H, K); s0:
    (B, H, K, V) float32 -> (o (B, S, H, V) in r's dtype, s_final
    (B, H, K, V) float32). ``chunk`` is the plain version's chunk length
    (the kernels keep their own)."""
    _check(r, k, v, log_w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, log_w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not "
                         f"{r.device.type}")
    return _scan_cuda(r, k, v, log_w, u, s0)
