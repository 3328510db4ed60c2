"""The RWKV-6 WKV scan: ``o_t = r_t (S + diag(u) k_t v_t^T)``,
``S <- diag(exp(log_w_t)) S + k_t v_t^T``.

Backs ``models.rwkv6.rwkv_time_mix`` under ``impl="flash"``: takes the
model layout, r/k/v/log_w (B, S, H, K|V), u (H, K), s0 (B, H, K, V)
float32, and returns o (B, S, H, V) in r's dtype and s_final
(B, H, K, V) float32, for any S (no padding to a whole chunk, which the
reference's ``ops.rwkv6_scan`` needed).

On a CUDA tensor ``rwkv6_scan`` launches the hand-written kernel
(``csrc/rwkv6_scan.cu``, one block per (batch, head) stepping the
recurrence exactly, counted in ``RWKV6_SCAN_LAUNCHES``), which reads the
inputs through their strides; on a CPU tensor it runs the plain version,
the vectorised chunked oracle ``ref.rwkv6_chunked_ref`` with its exact
pairwise decays. ``ref.rwkv6_step_ref`` is the ground truth of both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import rwkv6_chunked_ref as rwkv6_scan_plain

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "RWKV6_SCAN_LAUNCHES",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call that reaches the card).
RWKV6_SCAN_LAUNCHES = 0

_LIB = None


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


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("rwkv6_scan")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_rwkv6_scan.argtypes = [p] * 9 + [i32] * 6 + [p]
        lib.repro_rwkv6_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _scan_cuda(r, k, v, log_w, u, s0):
    global RWKV6_SCAN_LAUNCHES
    b, s, h, kd = r.shape
    vd = v.shape[3]
    if not (0 < kd <= MAX_HEAD_DIM and 0 < vd <= MAX_HEAD_DIM):
        raise ValueError(f"the rwkv6 kernel takes K and V up to "
                         f"{MAX_HEAD_DIM}, not {kd} and {vd}")
    u, s0 = u.contiguous(), s0.contiguous()
    o = torch.empty((b, s, h, vd), dtype=r.dtype, device=r.device)
    s_final = torch.empty_like(s0)
    if b * h == 0:
        return o, s_final
    strides = []
    for t in (r, k, v, log_w, o):
        if t.stride(3) != 1:
            raise ValueError("rwkv6_scan needs a contiguous last dim")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    st = (ctypes.c_int64 * 15)(*strides)
    with torch.cuda.device(r.device):
        rc = _lib().repro_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_final.data_ptr(),
            st, b, h, s, kd, vd, _DTYPES[r.dtype],
            torch.cuda.current_stream().cuda_stream)
    kbuild.check(rc, "repro_rwkv6_scan")
    RWKV6_SCAN_LAUNCHES += 1
    return o, s_final


def rwkv6_scan(r, k, v, log_w, u, s0, *, chunk: int = 64):
    """r/k/log_w: (B, S, H, K); v: (B, S, H, V); u: (H, K); s0:
    (B, H, K, V) float32 -> (o (B, S, H, V) in r's dtype, s_final
    (B, H, K, V) float32). ``chunk`` is the plain version's chunk length
    (the kernel steps one token at a time and needs none)."""
    _check(r, k, v, log_w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, log_w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not "
                         f"{r.device.type}")
    return _scan_cuda(r, k, v, log_w, u, s0)
