"""Grouped matmul for MoE expert FFNs: ``y[e] = x[e] @ w[e]``.

Backs ``models.moe`` under ``impl="flash_moe"``: x (E, C, D) and
w (E, D, F) of one dtype (float32 or bfloat16) give y (E, C, F) in x's
dtype with float32 accumulation, for any C, D and F.
``moe_grouped_ffn`` is the SiLU-gated expert FFN as three ``gmm`` calls
(gate, up, down), as the reference's ``ops.moe_grouped_ffn``.

On a CUDA tensor ``gmm`` launches the hand-written kernel
(``csrc/moe_gmm.cu``: tensor-core ``mma.sync`` tiles for bfloat16,
float32 FMAs for float32; counted in ``GMM_LAUNCHES``); on a CPU tensor
it runs the plain version, the oracle ``ref.gmm_ref`` itself (one
``einsum``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import gmm_ref as gmm_plain

__all__ = ["gmm", "gmm_plain", "moe_grouped_ffn", "GMM_LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call that reaches the card).
GMM_LAUNCHES = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kbuild.load("moe_gmm")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_gmm.argtypes = [p, p, p] + [i32] * 5 + [p]
        lib.repro_gmm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _gmm_cuda(x, w):
    global GMM_LAUNCHES
    e, c, d = x.shape
    f = w.shape[2]
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gmm needs 16-byte aligned x and w")
    y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if e * c * f == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _lib().repro_gmm(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              e, c, d, f, _DTYPES[x.dtype],
                              torch.cuda.current_stream().cuda_stream)
    kbuild.check(rc, "repro_gmm")
    GMM_LAUNCHES += 1
    return y


def gmm(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are no "
                         "(E, C, D) and (E, D, F)")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError("gmm takes float32 or bfloat16 x and w of one dtype")
    if x.device != w.device:
        raise ValueError("x and w lie on different devices")
    if x.device.type == "cpu":
        return gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {x.device.type}")
    return _gmm_cuda(x, w)


def moe_grouped_ffn(x, w_gate, w_up, w_down):
    """SiLU-gated expert FFN over stacked experts: x (E, C, D), w_gate and
    w_up (E, D, F), w_down (E, F, D) -> (E, C, D)."""
    gate = gmm(x, w_gate)
    up = gmm(x, w_up)
    h = gate * torch.sigmoid(gate) * up
    return gmm(h, w_down)
