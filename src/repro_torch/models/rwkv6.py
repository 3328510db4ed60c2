"""RWKV-6 "Finch" time-mix layer (arXiv:2404.05892) and the RWKV channel-mix
FFN: the port of ``repro.models.rwkv6``.

Time mix: token shift, five projections (r, k, v, g and a data-dependent
decay through a LoRA), the WKV recurrence per head with a (Dk, Dv) state,
a per-head GroupNorm (``ln_x``), a SiLU gate and the output projection.
``rwkv_time_mix`` runs the recurrence through the hand-written scan
kernel (``use_kernel=True``, the model's ``impl="flash"``) or through the
plain chunked oracle with exact pairwise decays. Decode carries
``RwkvState``: the WKV state and the last inputs of both mixers.

Mixed dtypes follow the reference's promotion: the decay LoRA runs in
float32 on a float32 copy of the token-shifted input and weights.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv6_scan as scan_kernel
from repro_torch.models.common import (dense_init, full_init,
                                       group_norm_heads, ones_init, silu,
                                       zeros_init)

DECAY_LORA = 64


class RwkvState(NamedTuple):
    wkv: torch.Tensor         # (B, H, Dk, Dv) fp32
    x_prev_t: torch.Tensor    # (B, D) last input to time-mix
    x_prev_c: torch.Tensor    # (B, D) last input to channel-mix


def init_rwkv(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hd = cfg.recurrent.head_dim
    h = d // hd
    return {
        # token-shift interpolation weights per projection
        "mu_r": full_init(gen, (d,), ("embed",), 0.5),
        "mu_k": full_init(gen, (d,), ("embed",), 0.5),
        "mu_v": full_init(gen, (d,), ("embed",), 0.5),
        "mu_w": full_init(gen, (d,), ("embed",), 0.5),
        "mu_g": full_init(gen, (d,), ("embed",), 0.5),
        "w_r": dense_init(gen, (d, d), ("embed", "heads_flat")),
        "w_k": dense_init(gen, (d, d), ("embed", "heads_flat")),
        "w_v": dense_init(gen, (d, d), ("embed", "heads_flat")),
        "w_g": dense_init(gen, (d, d), ("embed", "heads_flat")),
        "w_o": dense_init(gen, (d, d), ("heads_flat", "embed")),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "decay_w0": full_init(gen, (d,), ("embed",), -5.0),
        "decay_a": dense_init(gen, (d, DECAY_LORA), ("embed", None)),
        "decay_b": dense_init(gen, (DECAY_LORA, d), (None, "embed"),
                              fan_in=DECAY_LORA),
        "bonus_u": zeros_init(gen, (h, hd), ("heads", None)),
        "ln_x_w": ones_init(gen, (d,), ("embed",)),
        "ln_x_b": zeros_init(gen, (d,), ("embed",)),
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": full_init(gen, (d,), ("embed",), 0.5),
        "w_in": dense_init(gen, (d, f), ("embed", "ff")),
        "w_out": dense_init(gen, (f, d), ("ff", "embed"), fan_in=f),
    }


def _token_shift(x, x_prev, mu):
    """lerp(x, shift(x), mu): the shift brings the previous token forward."""
    shifted = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    return x + (shifted - x) * mu


def _projections(params, x, x_prev, cfg: ArchConfig):
    b, s, d = x.shape
    hd = cfg.recurrent.head_dim
    h = d // hd
    xr = _token_shift(x, x_prev, params["mu_r"])
    xk = _token_shift(x, x_prev, params["mu_k"])
    xv = _token_shift(x, x_prev, params["mu_v"])
    xw = _token_shift(x, x_prev, params["mu_w"])
    xg = _token_shift(x, x_prev, params["mu_g"])
    r = (xr @ params["w_r"]).reshape(b, s, h, hd)
    k = (xk @ params["w_k"]).reshape(b, s, h, hd)
    v = (xv @ params["w_v"]).reshape(b, s, h, hd)
    g = xg @ params["w_g"]
    # data-dependent decay, log-space: log w_t in (-inf, 0)
    lora = torch.tanh(xw.float() @ params["decay_a"].float()) \
        @ params["decay_b"].float()
    log_w = -torch.exp(params["decay_w0"].float() + lora)
    return r, k, v, g, log_w.reshape(b, s, h, hd)


def _output(params, o, g, h: int):
    o = group_norm_heads(o, params["ln_x_w"], params["ln_x_b"], h)
    return (o * silu(g)) @ params["w_o"]


def rwkv_time_mix(params, x, cfg: ArchConfig,
                  state: Optional[RwkvState] = None, *,
                  use_kernel: bool = False):
    """Full-sequence (prefill) time-mix. x: (B, S, D) -> (y, new_state)."""
    b, s, d = x.shape
    hd = cfg.recurrent.head_dim
    h = d // hd
    x_prev = state.x_prev_t if state is not None \
        else x.new_zeros((b, d))
    r, k, v, g, log_w = _projections(params, x, x_prev, cfg)
    u = params["bonus_u"].float()
    s0 = state.wkv if state is not None \
        else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device)
    if use_kernel:
        o, s_out = scan_kernel.rwkv6_scan(r, k, v, log_w, u, s0,
                                          chunk=cfg.recurrent.chunk)
    else:
        o, s_out = kref.rwkv6_chunked_ref(r, k, v, log_w, u, s0,
                                          chunk=cfg.recurrent.chunk)
    y = _output(params, o.reshape(b, s, d), g, h)
    new_state = RwkvState(s_out, x[:, -1],
                          state.x_prev_c if state is not None
                          else x.new_zeros((b, d)))
    return y, new_state


def rwkv_time_mix_decode(params, x, cfg: ArchConfig, state: RwkvState):
    """Single-token decode: O(1) state update. x: (B, 1, D)."""
    b, _, d = x.shape
    hd = cfg.recurrent.head_dim
    h = d // hd
    r, k, v, g, log_w = _projections(params, x, state.x_prev_t, cfg)
    r = r[:, 0].float()                 # (B, H, hd)
    k = k[:, 0].float()
    v = v[:, 0].float()
    w = torch.exp(log_w[:, 0])          # (B, H, hd)
    u = params["bonus_u"].float()
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, state.wkv + u[None, :, :, None] * kv)
    s_new = state.wkv * w[..., None] + kv
    y = _output(params, o.reshape(b, 1, d).to(x.dtype), g, h)
    return y, RwkvState(s_new, x[:, -1], state.x_prev_c)


def rwkv_channel_mix(params, x, x_prev):
    """RWKV squared-ReLU channel mix with token shift."""
    xk = _token_shift(x, x_prev, params["mu_k"])
    h = torch.relu(xk @ params["w_in"]).square()
    return h @ params["w_out"]
