"""The RG-LRU linear recurrence ``h_t = exp(log_a_t) * h_{t-1} + b_t``.

Backs ``models.rglru.rglru_block`` under ``impl="flash"``: log_a and b
(B, S, W) float32, h0 (B, W); returns h_all (B, S, W) and h_last (B, W)
in float32, for any S. Sequential in time, so arbitrarily strong decays
stay exact.

On a CUDA tensor ``rglru_scan`` launches one of two hand-written
kernels, chosen by ``_route`` from S and W alone:

- ``"tma"``, wherever TMA can address the rows (W * 4 a multiple of 16
  bytes: every served shape): ``csrc/rglru_scan_tma.cu``, a block per
  tile of channels of one batch row, fed by a ring of shared-memory
  stages that one producer thread fills by TMA, its h stored by TMA;
  ``_plan`` gives its tile, grid, ring depth and shared memory;
- ``"seq"`` otherwise: ``csrc/rglru_scan.cu``, one thread per (batch,
  channel) lane that loads its own steps.

Both step the recurrence in time order with the product and the sum
rounded separately. Every launch counts in ``RGLRU_SCAN_LAUNCHES``, the
TMA kernel's also in ``RGLRU_SCAN_TMA_LAUNCHES``. On a CPU tensor it runs
the plain version, which is the sequential oracle ``ref.rglru_scan_ref``
itself: the kernels compute exactly that loop, lane by lane.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ref import rglru_scan_ref as rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_plain", "RGLRU_SCAN_LAUNCHES",
           "RGLRU_SCAN_TMA_LAUNCHES"]

# Kernel launches (one per wrapper call that reaches the card), and those
# of them on the TMA route.
RGLRU_SCAN_LAUNCHES = 0
RGLRU_SCAN_TMA_LAUNCHES = 0

# The TMA kernel's launch plan. A block owns a tile of channels of one
# batch row; a stage holds STEPS steps of the tile's log_a and b, and two
# staging tiles hold its h. The tile is the widest of LANE_TILES (rows of
# 512, 256 or 128 bytes: wide rows are read faster) whose grid still
# gives at least 1 / MIN_SM_SHARE of the SMs a block (too few SMs cannot
# pull the bytes: at one batch row 20 blocks of 128 ran slower than 40 of
# 64, PERF.md) and is resident all at once. The ring is as deep as
# MAX_STAGES while every block of the grid stays resident.
STEPS = 64                  # the kernel's kSteps
LANE_TILES = (128, 64, 32)
MIN_SM_SHARE = 4
MAX_STAGES = 4
SMS = 132                   # H100 SXM; the wrapper reads the card's own
SMEM_PER_SM = 233_472       # shared memory an SM holds (228 KB)
SMEM_RESERVED = 1_024       # the runtime's own, per resident block
TMA_MAX_STRIDE = 2 ** 40    # a tensor map's strides, in bytes, stay below


class Plan(NamedTuple):
    lanes: int               # channels a block
    stages: int              # depth of the ring
    threads: int             # a producer warp and a warp per 32 channels
    grid: tuple[int, int]    # (channel tiles, batch rows)
    smem: int                # the kernel's smem_bytes<lanes>(stages)


def _stage_bytes(lanes: int) -> int:
    """One stage: a box of log_a and one of b, and two mbarriers."""
    return 2 * STEPS * lanes * 4 + 16


def _staging_bytes(lanes: int) -> int:
    """The two tiles of h that TMA stores from."""
    return 2 * STEPS * lanes * 4


def _smem(lanes: int, stages: int) -> int:
    return stages * _stage_bytes(lanes) + _staging_bytes(lanes)


def _depth(blocks: int, s: int, lanes: int, sms: int) -> int:
    """The deepest ring (at least 2 stages, at most ``MAX_STAGES``, never
    more than S has stages) that leaves every block of a grid of
    ``blocks`` its share of an SM's shared memory."""
    chunks = -(-s // STEPS)
    room = SMEM_PER_SM // -(-blocks // sms) - SMEM_RESERVED \
        - _staging_bytes(lanes)
    return max(min(2, chunks),
               min(MAX_STAGES, chunks, room // _stage_bytes(lanes)))


def _plan(b: int, s: int, w: int, *, sms: int = SMS) -> Plan:
    """The TMA kernel's launch for (B, S, W) on a card of ``sms`` SMs: a
    grid of ceil(W / lanes) x B blocks, the tile the widest of
    ``LANE_TILES`` whose grid reaches ``sms / MIN_SM_SHARE`` blocks and
    is resident all at once (else the narrowest), the ring ``_depth``.
    The kernel takes the tile and the depth and derives the rest."""
    def fits(n: int) -> bool:
        blocks = -(-w // n) * b
        per_sm = SMEM_PER_SM // (_smem(n, _depth(blocks, s, n, sms))
                                 + SMEM_RESERVED)
        return sms <= blocks * MIN_SM_SHARE and blocks <= sms * per_sm
    lanes = next((n for n in LANE_TILES if fits(n)), LANE_TILES[-1])
    grid = (-(-w // lanes), b)
    stages = _depth(grid[0] * grid[1], s, lanes, sms)
    return Plan(lanes, stages, 32 + lanes, grid, _smem(lanes, stages))


def _route(s: int, w: int) -> str:
    """The kernel for (B, S, W): ``"tma"`` where a tensor map can take the
    rows (W * 4 a multiple of 16 bytes, the batch stride S * W * 4 below
    TMA's 2^40), else ``"seq"``."""
    return "tma" if w % 4 == 0 and s * w * 4 < TMA_MAX_STRIDE else "seq"


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_LIBS = {}


def _lib(route: str):
    lib = _LIBS.get(route)
    if lib is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        if route == "tma":
            lib = kbuild.load("rglru_scan_tma")
            fn = lib.repro_rglru_scan_tma
            fn.argtypes = [p] * 5 + [i32] * 5 + [p]
        else:
            lib = kbuild.load("rglru_scan")
            fn = lib.repro_rglru_scan
            fn.argtypes = [p] * 5 + [i32] * 3 + [p]
        fn.restype = ctypes.c_int
        _LIBS[route] = lib
    return lib


def _aligned(t):
    """``t`` itself if it starts on 16 bytes, as a tensor map needs; else
    a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scan_cuda(log_a, b_in, h0):
    global RGLRU_SCAN_LAUNCHES, RGLRU_SCAN_TMA_LAUNCHES
    if not (log_a.is_contiguous() and b_in.is_contiguous()
            and h0.is_contiguous()):
        raise ValueError("rglru_scan needs contiguous log_a, b_in and h0")
    b, s, w = log_a.shape
    h_all = torch.empty_like(log_a)
    h_last = torch.empty_like(h0)
    if b * s * w == 0:
        return h_all, h0.clone()
    route = _route(s, w)
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tma":
            log_a, b_in = _aligned(log_a), _aligned(b_in)
            plan = _plan(b, s, w, sms=_sms(log_a.device.index))
            rc = _lib(route).repro_rglru_scan_tma(
                log_a.data_ptr(), b_in.data_ptr(), h0.data_ptr(),
                h_all.data_ptr(), h_last.data_ptr(), b, s, w, plan.lanes,
                plan.stages, stream)
        else:
            rc = _lib(route).repro_rglru_scan(
                log_a.data_ptr(), b_in.data_ptr(), h0.data_ptr(),
                h_all.data_ptr(), h_last.data_ptr(), b, s, w, stream)
    kbuild.check(rc, f"repro_rglru_scan ({route})")
    RGLRU_SCAN_LAUNCHES += 1
    RGLRU_SCAN_TMA_LAUNCHES += int(route == "tma")
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
