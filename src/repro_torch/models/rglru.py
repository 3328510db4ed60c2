"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
port of ``repro.models.rglru``.

Two branches from the residual stream, (linear -> causal depthwise conv
(width 4) -> RG-LRU) gated by (linear -> GeLU), merged by an output
linear. The cell:

    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_x u_t + b_x)
    log a_t = -8 * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

``rglru_block`` runs the recurrence through the hand-written scan kernel
(``use_kernel=True``, the model's ``impl="flash"``, forward only) or, as
the reference does, through ``linear_scan``: a log-depth scan over time
that autograd differentiates (training runs this route). ``scan_impl``
``chunked`` runs it chunk by chunk with the state carried between
chunks, ``chunked_block`` the whole block per chunk. The sequential
``kernels.ref.rglru_scan_ref`` stays the oracle. Decode carries (h, conv
tail) state.

Tensor parallelism (a step whose rules split ``ff``, the LRU width W,
over ``"model"``): ``w_in_rnn``, ``w_in_gate``, the conv, ``lam`` and the
gate biases on the rank's W/tp channels, ``w_out`` row-parallel, the
state and the conv tail (B, W/tp) and (B, cw-1, W/tp), as
``cache_shardings`` places them. ``gate_a``/``gate_x`` are (W, W)
sharded on their rows (``("ff", None)``): each rank multiplies its
channels of u by its rows, and one reduce-scatter over ``"model"`` of
both gates' (B, S, 2, W) partial sums leaves each rank the whole sums of
its channels (``_gates``). That keeps the weights where the parameter
rules put them and moves (B, S, 2, W) float32 partials, where
all-gathering u would move u and both whole (W, W) gates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard_map as sm
from repro_torch.kernels import rglru_scan as scan_kernel
from repro_torch.models import common
from repro_torch.models.common import (Param, dense_init, init_device,
                                       zeros_init)

RGLRU_C = 8.0


class RglruState(NamedTuple):
    h: torch.Tensor          # (B, W) fp32 recurrent state
    conv: torch.Tensor       # (B, conv_width - 1, W) conv tail


def init_rglru(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv_width
    return {
        "w_in_rnn": dense_init(gen, (d, w), ("embed", "ff")),
        "w_in_gate": dense_init(gen, (d, w), ("embed", "ff")),
        "conv_w": dense_init(gen, (cw, w), (None, "ff"), fan_in=cw),
        "conv_b": zeros_init(gen, (w,), ("ff",)),
        "gate_a": dense_init(gen, (w, w), ("ff", None)),
        "gate_a_b": zeros_init(gen, (w,), ("ff",)),
        "gate_x": dense_init(gen, (w, w), ("ff", None)),
        "gate_x_b": zeros_init(gen, (w,), ("ff",)),
        # Lambda init so a^c ~ U[0.9, 0.999] at r=1 (Griffin init)
        "lam": Param(torch.linspace(0.65, 4.6, w, dtype=torch.float32,
                                    device=init_device(gen)), ("ff",)),
        "w_out": dense_init(gen, (w, d), ("ff", "embed"), fan_in=w),
    }


def _causal_conv(x, conv_w, conv_b, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time, as a sum of shifted products.
    x: (B, S, W); tail: (B, cw-1, W)."""
    cw = conv_w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * conv_w[i]
    return out + conv_b, xp[:, -(cw - 1):]


def _weights(params) -> dict:
    """The block's weights as the rank computes with them, and ``split``:
    whether the width is split over "model" (then the rank's W/tp
    channels, the gates' rows among them, and ``w_out`` row-parallel)."""
    w = params["lam"].shape[0]
    split = common.model_split("ff", w)
    col = 1 if split else None
    row = 0 if split else None
    out = {"split": split,
           "w_in_rnn": common.tp_weight(params["w_in_rnn"], col),
           "w_in_gate": common.tp_weight(params["w_in_gate"], col),
           "conv_w": common.tp_weight(params["conv_w"], col),
           "w_out": common.tp_weight(params["w_out"], row)}
    for k in ("conv_b", "gate_a", "gate_a_b", "gate_x", "gate_x_b", "lam"):
        out[k] = common.tp_weight(params[k], row)
    return out


def _gates(params, u):
    """u: (B, S, W) conv output -> (log_a, x_in) both fp32. Under TP u
    holds the rank's channels and the gates their rows: the partial
    products are summed over "model" into the rank's channels."""
    uf = u.float()
    if params.get("split"):
        both = torch.stack([uf @ params["gate_a"].float(),
                            uf @ params["gate_x"].float()], dim=-2)
        _, mesh, _ = common.installed_rules()
        both = sm.reduce_scatter(both, -1, mesh, "model")
        ga, gx = both.unbind(-2)
    else:
        ga = uf @ params["gate_a"].float()
        gx = uf @ params["gate_x"].float()
    r = torch.sigmoid(ga + params["gate_a_b"])
    i = torch.sigmoid(gx + params["gate_x_b"])
    log_a = -RGLRU_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * uf)
    return log_a.contiguous(), x_in.contiguous()


def _out(params, y):
    return common.leave_tp(y) if params.get("split") else y


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def linear_scan(log_a, b, h0):
    """h_t = exp(log_a_t) * h_{t-1} + b_t over time, in log depth.

    log_a, b: (B, S, W) fp32; h0: (B, W). Returns (h_all, h_last). A
    Hillis-Steele scan of the reference's associative ``combine``:
    after the level of distance d, position t holds the composition of
    steps (t - 2d, t], so each level is two whole-tensor products and
    autograd carries them without a per-step loop. The reference's
    ``lax.associative_scan`` composes in another tree; the results agree
    within float32 rounding."""
    b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None],
                   b[:, 1:]], dim=1)
    la, s = log_a, log_a.shape[1]
    d = 1
    while d < s:
        # combine(left = t - d, right = t) for every t >= d
        b = torch.cat([b[:, :d], torch.exp(la[:, d:]) * b[:, :-d]
                       + b[:, d:]], dim=1)
        if 2 * d < s:
            la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
        d *= 2
    return b, b[:, -1]


def linear_scan_chunked(log_a, b, h0, chunk: int = 1024):
    """``linear_scan`` chunk by chunk, the state carried between chunks:
    the scan's working set is O(chunk x W) per level instead of
    O(S x W). The last chunk may be shorter (the reference pads it with
    identity steps to keep ``lax.scan``'s shapes equal)."""
    h = h0.float()
    outs = []
    for c in range(0, log_a.shape[1], chunk):
        h_all, h = linear_scan(log_a[:, c:c + chunk], b[:, c:c + chunk], h)
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def _enter(p, x):
    """x as the block's branches take it: entering the split width's
    work under TP."""
    return common.enter_tp(x) if p["split"] else x


def rglru_block(params, x, cfg: ArchConfig,
                state: Optional[RglruState] = None, *,
                use_kernel: bool = False):
    """Full-sequence recurrent block. x: (B, S, D) -> (y, new_state)."""
    if cfg.recurrent.scan_impl == "chunked_block" and state is None:
        return _rglru_block_chunked(params, x, cfg,
                                    chunk=max(cfg.recurrent.chunk, 256))
    p = _weights(params)
    x = _enter(p, x)
    w = params["lam"].shape[0]
    u = common.shard(x @ p["w_in_rnn"], ("batch", "seq", "ff"), ff=w)
    gate = _gelu(x @ p["w_in_gate"])
    conv_tail = state.conv if state is not None else None
    u, new_tail = _causal_conv(u, p["conv_w"], p["conv_b"], conv_tail)
    log_a, x_in = _gates(p, u)
    h0 = state.h if state is not None \
        else torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                         device=x.device)
    if use_kernel:
        h_all, h_last = scan_kernel.rglru_scan(log_a, x_in, h0)
    elif cfg.recurrent.scan_impl == "chunked":
        h_all, h_last = linear_scan_chunked(
            log_a, x_in, h0, chunk=max(cfg.recurrent.chunk, 256))
    else:
        h_all, h_last = linear_scan(log_a, x_in, h0)
    y = (h_all.to(x.dtype) * gate) @ p["w_out"]
    return _out(p, y), RglruState(h_last, new_tail)


def _rglru_block_chunked(params, x, cfg: ArchConfig, chunk: int):
    """The whole block chunk by chunk along time (conv, gates, scan and
    output projection), the (h, conv tail) carry passed between chunks,
    so the fp32 gate and scan intermediates exist for one chunk at a
    time: O(B x chunk x W) instead of O(B x S x W)."""
    p = _weights(params)
    x = _enter(p, x)
    b, s, d = x.shape
    w = p["lam"].shape[0]
    cw = cfg.recurrent.conv_width
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    # Padded positions must be identity updates (log_a = 0, input = 0) or
    # the carried state would evolve through the padding.
    valid = (torch.arange(s + pad, device=x.device) < s)[None, :, None]
    h = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    tail = x.new_zeros((b, cw - 1, w))
    ys = []
    for c in range(0, s + pad, chunk):
        x_c, valid_c = x[:, c:c + chunk], valid[:, c:c + chunk]
        u = x_c @ p["w_in_rnn"]
        gate = _gelu(x_c @ p["w_in_gate"])
        u, tail = _causal_conv(u, p["conv_w"], p["conv_b"], tail)
        log_a, x_in = _gates(p, u)
        log_a = torch.where(valid_c, log_a, 0.0)
        x_in = torch.where(valid_c, x_in, 0.0)
        h_all, h = linear_scan(log_a, x_in, h)
        ys.append((h_all.to(x_c.dtype) * gate) @ p["w_out"])
    y = torch.cat(ys, dim=1)[:, :s]
    # Conv tail for decode continuation: the last cw-1 REAL inputs (the
    # in-loop tail ends on padded positions).
    tail = x[:, max(0, s - (cw - 1)):s] @ p["w_in_rnn"]
    if tail.shape[1] < cw - 1:
        tail = F.pad(tail, (0, 0, cw - 1 - tail.shape[1], 0))
    return _out(p, y), RglruState(h, tail.to(x.dtype))


def rglru_block_decode(params, x, cfg: ArchConfig, state: RglruState):
    """One-step decode: O(1) state. x: (B, 1, D)."""
    p = _weights(params)
    u = x @ p["w_in_rnn"]
    gate = _gelu(x @ p["w_in_gate"])
    u, new_tail = _causal_conv(u, p["conv_w"], p["conv_b"], state.conv)
    log_a, x_in = _gates(p, u)
    h = torch.exp(log_a[:, 0]) * state.h + x_in[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return _out(p, y), RglruState(h, new_tail)
