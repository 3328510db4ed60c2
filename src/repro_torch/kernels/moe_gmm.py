"""Grouped matmul for MoE expert FFNs: ``y[e] = x[e] @ w[e]``.

Backs ``models.moe`` under ``impl="flash_moe"`` (whose attention runs
``kernels.flash_attention``): x (E, C, D) and w (E, D, F) of one dtype
(float32 or bfloat16) give y (E, C, F) in x's dtype with float32
accumulation, for any C, D and F.
``moe_grouped_ffn`` is the SiLU-gated expert FFN as three ``gmm`` calls
(gate, up, down), as the reference's ``ops.moe_grouped_ffn``.

On a CUDA tensor ``gmm`` launches one of three hand-written kernels,
chosen by ``_route`` from the dtype and shape alone: bfloat16 with D and
F multiples of 8 takes ``csrc/moe_gmm_wgmma.cu`` (``"tc"``: ``wgmma``
products on TMA-fed tiles; TMA needs 16-byte row strides), other
bfloat16 shapes ``csrc/moe_gmm.cu``'s ``mma.sync`` tiles (``"mma"``), and
float32 that file's float32 FMAs (``"fma"``). Every launch counts in
``GMM_LAUNCHES``, the tensor-core ones also in ``GMM_TC_LAUNCHES``. A
failed build, tensor map or launch raises; no route stands in for
another. On a CPU tensor it runs the plain version, the oracle
``ref.gmm_ref`` itself (one ``einsum``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import gmm_ref as gmm_plain

__all__ = ["gmm", "gmm_plain", "moe_grouped_ffn", "GMM_LAUNCHES",
           "GMM_TC_LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call that reaches the card), and those
# of them on the tensor-core route.
GMM_LAUNCHES = 0
GMM_TC_LAUNCHES = 0


def _route(dtype, d: int, f: int) -> str:
    """The kernel for x of ``dtype`` (E, C, ``d``) and w (E, ``d``, ``f``):
    ``"tc"`` (bf16 on ``wgmma``), ``"mma"`` (bf16 on ``mma.sync``) or
    ``"fma"`` (float32 FMAs on the CUDA cores)."""
    if dtype != torch.bfloat16:
        return "fma"
    return "tc" if d % 8 == 0 and f % 8 == 0 else "mma"


_LIBS = {}


def _lib(route: str):
    lib = _LIBS.get(route)
    if lib is None:
        p = ctypes.c_void_p
        if route == "tc":
            lib = kbuild.load("moe_gmm_wgmma")
            fn = lib.repro_gmm_wgmma      # x, w, y, e, c, d, f, stream
            fn.argtypes = [p, p, p] + [ctypes.c_int] * 4 + [p]
        else:
            lib = kbuild.load("moe_gmm")
            fn = lib.repro_gmm            # ..., e, c, d, f, dtype, stream
            fn.argtypes = [p, p, p] + [ctypes.c_int] * 5 + [p]
        fn.restype = ctypes.c_int
        _LIBS[route] = lib
    return lib


def _gmm_cuda(x, w):
    global GMM_LAUNCHES, GMM_TC_LAUNCHES
    e, c, d = x.shape
    f = w.shape[2]
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gmm needs 16-byte aligned x and w")
    route = _route(x.dtype, d, f)
    y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if e * c * f == 0:
        return y
    if d == 0:                # an empty contraction: no products to take
        return y.zero_()
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if route == "tc":
            rc = _lib(route).repro_gmm_wgmma(*ptrs, e, c, d, f, stream)
        else:
            rc = _lib(route).repro_gmm(*ptrs, e, c, d, f, _DTYPES[x.dtype],
                                       stream)
    kbuild.check(rc, f"gmm ({route} route)")
    GMM_LAUNCHES += 1
    GMM_TC_LAUNCHES += int(route == "tc")
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
