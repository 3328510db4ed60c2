"""Causal / sliding-window GQA flash attention for prefill.

Backs ``models.attention`` under ``impl="flash"``: online-softmax
attention in float32 over KV tiles, with the TPU kernel's finite
``NEG_INF``, its guard for fully masked rows and its 1e-20 denominator
floor, so such a row gives 0. Takes the model layout, q (B, Sq, H, D) and
k, v (B, Skv, Hkv, D), with kv head ``h // (H // Hkv)``; any Sq and Skv.

On a CUDA tensor ``flash_attention`` launches the hand-written kernel
(``csrc/flash_attention.cu``, counted in ``FLASH_ATTENTION_LAUNCHES``),
which reads the tensors through their strides; on a CPU tensor it runs
the plain version, which is the oracle ``ref.flash_attention_ref``
itself: one full score matrix and a softmax, not the kernel's tiles.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain",
           "FLASH_ATTENTION_LAUNCHES"]

MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call that reaches the card).
FLASH_ATTENTION_LAUNCHES = 0


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,Sq,H,D), k and v "
                         "(B,Skv,Hkv,D)")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not line up")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} heads are no multiple of {k.shape[2]} kv "
                         "heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention takes float32 or bfloat16 q, k, v "
                         "of one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("flash_attention")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = [p, p, p, p, p] + [i32] * 8 \
            + [ctypes.c_float, i32, p]
        lib.repro_flash_attention.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _flash_cuda(q, k, v, causal: bool, window: int):
    global FLASH_ATTENTION_LAUNCHES
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes a head dim that is a "
                         f"multiple of 4 up to {MAX_HEAD_DIM}, not {d}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1:
            raise ValueError("flash_attention needs a contiguous last dim")
        # Rows are read as 4-element vectors: aligned base and strides.
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError("flash_attention needs 16-byte aligned rows")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    if sq == 0 or b == 0:
        return out
    st = (ctypes.c_int64 * 12)(*strides)
    with torch.cuda.device(q.device):
        rc = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st,
            b, sq, skv, h, h // hkv, d, int(causal), int(window),
            1.0 / math.sqrt(d), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    kbuild.check(rc, "repro_flash_attention")
    FLASH_ATTENTION_LAUNCHES += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, H, D) in q's
    dtype. ``window`` > 0 limits each query to the ``window`` keys ending
    at its own position."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    return _flash_cuda(q, k, v, causal, window)
