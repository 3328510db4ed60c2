"""Causal / sliding-window GQA flash attention for prefill.

Backs ``models.attention`` under ``impl="flash"`` and ``"flash_moe"``:
online-softmax attention in float32 over KV tiles, with the TPU kernel's
finite ``NEG_INF``, its guard for fully masked rows and its 1e-20
denominator floor, so such a row gives 0. Takes the model layout, q (B,
Sq, H, D) and k, v (B, Skv, Hkv, D), with kv head ``h // (H // Hkv)``;
any Sq and Skv.

On a CUDA tensor ``flash_attention`` launches one of three hand-written
kernels, each reading the tensors through their strides, chosen by
``_route`` from the dtype and head dim alone: bf16 with a head dim that is
a multiple of 16 up to ``TC_MAX_HEAD_DIM`` (StableLM-3B's 80 among them)
takes the wgmma kernel (``csrc/flash_attention_wgmma.cu``, ``"tc"``:
``wgmma`` products, TMA-fed K/V tiles, the head dim's tail past a multiple
of 64 zero-filled by TMA); bf16 at every other head dim up to
``MMA_MAX_HEAD_DIM`` (6, 36, 37, 200, ...) takes the ``mma.sync`` kernel
(``csrc/flash_attention_mma.cu``, ``"mma"``: the head dim zero-filled to a
multiple of 16, K/V tiles by ``cp.async``); float32, and bf16 over
``MMA_MAX_HEAD_DIM``, take the CUDA-core kernel
(``csrc/flash_attention.cu``, ``"fma"``: float32 FMAs; any head dim up to
``MAX_HEAD_DIM``, whose tiles fill most of a block's 227 KB of shared
memory, rows read as vectors where D is a multiple of 4). Every launch
counts in ``FLASH_ATTENTION_LAUNCHES``, the tensor-core ones also in
``FLASH_ATTENTION_TC_LAUNCHES`` or ``FLASH_ATTENTION_MMA_LAUNCHES``. On a
CPU tensor it runs the plain version, which is the oracle
``ref.flash_attention_ref`` itself: one full score matrix and a softmax,
not the kernels' tiles.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain",
           "FLASH_ATTENTION_LAUNCHES", "FLASH_ATTENTION_TC_LAUNCHES",
           "FLASH_ATTENTION_MMA_LAUNCHES"]

MAX_HEAD_DIM = 512   # the CUDA-core kernel's largest head dim (kMaxD)
# The wgmma kernel takes bf16 head dims that are multiples of 16 up to
# this (one template each).
TC_MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 256   # the mma.sync kernel's largest head dim (kMaxD)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call that reaches the card), and those
# of them on each tensor-core route.
FLASH_ATTENTION_LAUNCHES = 0
FLASH_ATTENTION_TC_LAUNCHES = 0
FLASH_ATTENTION_MMA_LAUNCHES = 0


def _route(dtype, d: int) -> str:
    """The kernel for q of ``dtype`` and head dim ``d``: ``"tc"`` (bf16 on
    the tensor cores by wgmma), ``"mma"`` (bf16 on the tensor cores by
    mma.sync) or ``"fma"`` (float32 FMAs on the CUDA cores)."""
    if dtype != torch.bfloat16:
        return "fma"
    if _tc_takes(d):
        return "tc"
    return "mma" if d <= MMA_MAX_HEAD_DIM else "fma"


def _tc_takes(d: int) -> bool:
    """Whether the wgmma kernel has an instance for bf16 head dim ``d``."""
    return d % 16 == 0 and 0 < d <= TC_MAX_HEAD_DIM


def _copy_bytes(d: int, tensors) -> int:
    """Bytes of one ``cp.async`` copy of the mma route: the largest of 16,
    8 and 4 that divides a row's bytes and every base address and stride
    (in bytes) of ``tensors``; else 2 (one element at a time)."""
    for g in (16, 8, 4):
        if (2 * d) % g == 0 and all(
                t.data_ptr() % g == 0 and all(2 * s % g == 0
                                              for s in t.stride()[:3])
                for t in tensors):
            return g
    return 2


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


_LIBS = {}


def _lib(route: str):
    lib = _LIBS.get(route)
    if lib is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        if route == "tc":
            lib = kbuild.load("flash_attention_wgmma")
            fn = lib.repro_flash_attention_wgmma
            fn.argtypes = [p] * 5 + [i32] * 8 + [ctypes.c_float, p]
        elif route == "mma":
            lib = kbuild.load("flash_attention_mma")
            fn = lib.repro_flash_attention_mma
            fn.argtypes = [p] * 5 + [i32] * 8 + [ctypes.c_float, i32, p]
        else:
            lib = kbuild.load("flash_attention")
            fn = lib.repro_flash_attention
            fn.argtypes = [p] * 5 + [i32] * 8 + [ctypes.c_float, i32, p]
        fn.restype = ctypes.c_int
        _LIBS[route] = lib
    return lib


def _flash_cuda(q, k, v, causal: bool, window: int, route=None,
                scale=None):
    """One launch of the kernel of ``_route`` (``route`` names another
    kernel that takes the inputs, to time it beside its successor)."""
    global FLASH_ATTENTION_LAUNCHES, FLASH_ATTENTION_TC_LAUNCHES, \
        FLASH_ATTENTION_MMA_LAUNCHES
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head dims up to "
                         f"{MAX_HEAD_DIM} (a block's shared memory), not {d}")
    route = route or _route(q.dtype, d)
    if route != "fma" and not (q.dtype == torch.bfloat16 and (
            _tc_takes(d) if route == "tc" else d <= MMA_MAX_HEAD_DIM)):
        raise ValueError(f"the {route} flash kernel does not take {q.dtype} "
                         f"at head dim {d}")
    # TMA needs 16-byte strides (8 bf16); the CUDA-core kernel reads rows
    # as 4-element vectors where D is a multiple of 4, else one element
    # at a time, which needs no alignment; the mma kernel's copies take
    # whatever alignment the rows have (``_copy_bytes``).
    align = 8 if route == "tc" else 4 if route == "fma" and d % 4 == 0 \
        else 1
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1:
            raise ValueError("flash_attention needs a contiguous last dim")
        if align > 1 and (t.data_ptr() % 16
                          or any(s % align for s in t.stride()[:3])):
            raise ValueError("flash_attention needs 16-byte aligned rows")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    if sq == 0 or b == 0:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    st = (ctypes.c_int64 * 12)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st)
    with torch.cuda.device(q.device):
        if route == "tc":
            rc = _lib(route).repro_flash_attention_wgmma(
                *ptrs, b, sq, skv, h, hkv, d, int(causal), int(window),
                scale, stream)
        elif route == "mma":
            rc = _lib(route).repro_flash_attention_mma(
                *ptrs, b, sq, skv, h, h // hkv, d, int(causal), int(window),
                scale, _copy_bytes(d, (q, k, v)), stream)
        else:
            rc = _lib(route).repro_flash_attention(
                *ptrs, b, sq, skv, h, h // hkv, d, int(causal), int(window),
                scale, _DTYPES[q.dtype], stream)
    kbuild.check(rc, f"flash_attention ({route} route)")
    FLASH_ATTENTION_LAUNCHES += 1
    FLASH_ATTENTION_TC_LAUNCHES += int(route == "tc")
    FLASH_ATTENTION_MMA_LAUNCHES += int(route == "mma")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, H, D) in q's
    dtype. ``window`` > 0 limits each query to the ``window`` keys ending
    at its own position; ``scale`` multiplies the scores (1/sqrt(D) by
    default)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    return _flash_cuda(q, k, v, causal, window, scale=scale)
