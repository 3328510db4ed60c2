"""The RG-LRU linear recurrence ``h_t = exp(log_a_t) * h_{t-1} + b_t``.

Backs ``models.rglru.rglru_block`` under ``impl="flash"``: log_a and b
(B, S, W) float32, h0 (B, W); returns h_all (B, S, W) and h_last (B, W)
in float32, for any S. Sequential in time, so arbitrarily strong decays
stay exact.

On a CUDA tensor ``rglru_scan`` launches the hand-written kernel
(``csrc/rglru_scan.cu``, one thread per (batch, channel) lane, counted in
``RGLRU_SCAN_LAUNCHES``); on a CPU tensor it runs the plain version,
which is the sequential oracle ``ref.rglru_scan_ref`` itself: the kernel
computes exactly that loop, lane by lane.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import rglru_scan_ref as rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_plain", "RGLRU_SCAN_LAUNCHES"]

# Kernel launches (one per wrapper call that reaches the card).
RGLRU_SCAN_LAUNCHES = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("rglru_scan")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_rglru_scan.argtypes = [p, p, p, p, p, i32, i32, i32, p]
        lib.repro_rglru_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _scan_cuda(log_a, b_in, h0):
    global RGLRU_SCAN_LAUNCHES
    if not (log_a.is_contiguous() and b_in.is_contiguous()
            and h0.is_contiguous()):
        raise ValueError("rglru_scan needs contiguous log_a, b_in and h0")
    b, s, w = log_a.shape
    h_all = torch.empty_like(log_a)
    h_last = torch.empty_like(h0)
    if b * s * w == 0:
        return h_all, h0.clone()
    with torch.cuda.device(log_a.device):
        rc = _lib().repro_rglru_scan(
            log_a.data_ptr(), b_in.data_ptr(), h0.data_ptr(),
            h_all.data_ptr(), h_last.data_ptr(), b, s, w,
            torch.cuda.current_stream().cuda_stream)
    kbuild.check(rc, "repro_rglru_scan")
    RGLRU_SCAN_LAUNCHES += 1
    return h_all, h_last


def rglru_scan(log_a, b_in, h0):
    """log_a, b_in: (B, S, W) float32; h0: (B, W) float32 ->
    (h_all (B, S, W), h_last (B, W)), float32."""
    if log_a.dim() != 3 or b_in.shape != log_a.shape \
            or h0.shape != (log_a.shape[0], log_a.shape[2]):
        raise ValueError(f"log_a {tuple(log_a.shape)}, b_in "
                         f"{tuple(b_in.shape)} and h0 {tuple(h0.shape)} do "
                         "not line up")
    if not (log_a.dtype == b_in.dtype == h0.dtype == torch.float32):
        raise ValueError("rglru_scan takes float32 log_a, b_in and h0")
    if not (log_a.device == b_in.device == h0.device):
        raise ValueError("log_a, b_in and h0 lie on different devices")
    if log_a.device.type == "cpu":
        return rglru_scan_plain(log_a, b_in, h0)
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not "
                         f"{log_a.device.type}")
    return _scan_cuda(log_a, b_in, h0)
