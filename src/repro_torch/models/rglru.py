"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
port of ``repro.models.rglru``.

Two branches from the residual stream, (linear -> causal depthwise conv
(width 4) -> RG-LRU) gated by (linear -> GeLU), merged by an output
linear. The cell:

    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_x u_t + b_x)
    log a_t = -8 * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

``rglru_block`` runs the recurrence through the hand-written scan kernel
(``use_kernel=True``, the model's ``impl="flash"``) or through the plain
sequential oracle (the reference's associative ``linear_scan`` computes
the same recurrence; the two agree within float32 rounding). Decode
carries (h, conv tail) state. The reference's chunked variants
(``scan_impl`` ``chunked`` / ``chunked_block``) are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rglru_scan as scan_kernel
from repro_torch.models.common import dense_init, zeros_init

RGLRU_C = 8.0


class RglruState(NamedTuple):
    h: torch.Tensor          # (B, W) fp32 recurrent state
    conv: torch.Tensor       # (B, conv_width - 1, W) conv tail


def init_rglru(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv_width
    return {
        "w_in_rnn": dense_init(gen, (d, w)),
        "w_in_gate": dense_init(gen, (d, w)),
        "conv_w": dense_init(gen, (cw, w), fan_in=cw),
        "conv_b": zeros_init(gen, (w,)),
        "gate_a": dense_init(gen, (w, w)),
        "gate_a_b": zeros_init(gen, (w,)),
        "gate_x": dense_init(gen, (w, w)),
        "gate_x_b": zeros_init(gen, (w,)),
        # Lambda init so a^c ~ U[0.9, 0.999] at r=1 (Griffin init)
        "lam": torch.linspace(0.65, 4.6, w, dtype=torch.float32,
                              device=gen.device),
        "w_out": dense_init(gen, (w, d), fan_in=w),
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


def _gates(params, u):
    """u: (B, S, W) conv output -> (log_a, x_in) both fp32."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["gate_a"].float() + params["gate_a_b"])
    i = torch.sigmoid(uf @ params["gate_x"].float() + params["gate_x_b"])
    log_a = -RGLRU_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-12)) * (i * uf)
    return log_a, x_in


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def rglru_block(params, x, cfg: ArchConfig,
                state: Optional[RglruState] = None, *,
                use_kernel: bool = False):
    """Full-sequence recurrent block. x: (B, S, D) -> (y, new_state)."""
    if cfg.recurrent.scan_impl != "assoc":
        raise NotImplementedError(
            f"scan_impl {cfg.recurrent.scan_impl!r} is not ported")
    u = x @ params["w_in_rnn"]
    gate = _gelu(x @ params["w_in_gate"])
    conv_tail = state.conv if state is not None else None
    u, new_tail = _causal_conv(u, params["conv_w"], params["conv_b"],
                               conv_tail)
    log_a, x_in = _gates(params, u)
    h0 = state.h if state is not None \
        else torch.zeros((x.shape[0], u.shape[-1]), dtype=torch.float32,
                         device=x.device)
    if use_kernel:
        h_all, h_last = scan_kernel.rglru_scan(log_a, x_in, h0)
    else:
        h_all, h_last = kref.rglru_scan_ref(log_a, x_in, h0)
    y = (h_all.to(x.dtype) * gate) @ params["w_out"]
    return y, RglruState(h_last, new_tail)


def rglru_block_decode(params, x, cfg: ArchConfig, state: RglruState):
    """One-step decode: O(1) state. x: (B, 1, D)."""
    u = x @ params["w_in_rnn"]
    gate = _gelu(x @ params["w_in_gate"])
    u, new_tail = _causal_conv(u, params["conv_w"], params["conv_b"],
                               state.conv)
    log_a, x_in = _gates(params, u)
    h = torch.exp(log_a[:, 0]) * state.h + x_in[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ params["w_out"]
    return y, RglruState(h, new_tail)
