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

Tensor parallelism (a step whose rules split ``heads`` over ``"model"``,
for the time mix, and ``ff``, for the channel mix): ``w_r``/``w_k``/
``w_v``/``w_g`` are column-parallel on the rank's heads' channels
(``heads_flat``), the decay LoRA's output columns (``decay_b``,
``decay_w0``), ``bonus_u`` and ``ln_x`` sliced to them, and ``w_o``
row-parallel; the WKV state is (B, H/tp, Dk, Dv), as
``cache_shardings`` places it. The token-shift ``mu``s and ``decay_a``
act on the whole input, before the split: they stay whole, their
gradients summed over ``"model"``. The channel mix's ``w_in`` is
column-parallel on ``ff``, ``w_out`` row-parallel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv6_scan as scan_kernel
from repro_torch.models import common
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


def _weights(params, cfg: ArchConfig) -> dict:
    """The time mix's weights as the rank computes with them; ``heads``:
    the rank's head count (all of them without TP), ``split``: whether
    they are split over "model"."""
    h = cfg.d_model // cfg.recurrent.head_dim
    split = common.model_split("heads", h)
    col = 1 if split else None
    vec = 0 if split else None
    whole = "sum" if split else "mean"
    out = {"split": split, "heads": h // common.tp_size() if split else h}
    for k in ("w_r", "w_k", "w_v", "w_g", "decay_b"):
        out[k] = common.tp_weight(params[k], col)
    for k in ("decay_w0", "bonus_u", "ln_x_w", "ln_x_b"):
        out[k] = common.tp_weight(params[k], vec)
    for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_a"):
        out[k] = common.tp_weight(params[k], grad=whole)
    out["w_o"] = common.tp_weight(params["w_o"], vec)
    return out


def _projections(p, x, x_prev, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.recurrent.head_dim
    h = p["heads"]
    xr = _token_shift(x, x_prev, p["mu_r"])
    xk = _token_shift(x, x_prev, p["mu_k"])
    xv = _token_shift(x, x_prev, p["mu_v"])
    xw = _token_shift(x, x_prev, p["mu_w"])
    xg = _token_shift(x, x_prev, p["mu_g"])
    r = (xr @ p["w_r"]).reshape(b, s, h, hd)
    k = (xk @ p["w_k"]).reshape(b, s, h, hd)
    v = (xv @ p["w_v"]).reshape(b, s, h, hd)
    g = xg @ p["w_g"]
    # data-dependent decay, log-space: log w_t in (-inf, 0)
    lora = torch.tanh(xw.float() @ p["decay_a"].float()) \
        @ p["decay_b"].float()
    log_w = -torch.exp(p["decay_w0"].float() + lora)
    return r, k, v, g, log_w.reshape(b, s, h, hd)


def _output(p, o, g):
    o = group_norm_heads(o, p["ln_x_w"], p["ln_x_b"], p["heads"])
    y = (o * silu(g)) @ p["w_o"]
    return common.leave_tp(y) if p["split"] else y


def rwkv_time_mix(params, x, cfg: ArchConfig,
                  state: Optional[RwkvState] = None, *,
                  use_kernel: bool = False):
    """Full-sequence (prefill) time-mix. x: (B, S, D) -> (y, new_state)."""
    p = _weights(params, cfg)
    b, s, d = x.shape
    hd = cfg.recurrent.head_dim
    h = p["heads"]
    x_prev = state.x_prev_t if state is not None \
        else x.new_zeros((b, d))
    xt = common.enter_tp(x) if p["split"] else x
    r, k, v, g, log_w = _projections(p, xt, x_prev, cfg)
    u = p["bonus_u"].float()
    s0 = state.wkv if state is not None \
        else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device)
    if use_kernel:
        o, s_out = scan_kernel.rwkv6_scan(r, k, v, log_w, u, s0,
                                          chunk=cfg.recurrent.chunk)
    else:
        o, s_out = kref.rwkv6_chunked_ref(r, k, v, log_w, u, s0,
                                          chunk=cfg.recurrent.chunk)
    y = _output(p, o.reshape(b, s, h * hd), g)
    new_state = RwkvState(s_out, x[:, -1],
                          state.x_prev_c if state is not None
                          else x.new_zeros((b, d)))
    return y, new_state


def rwkv_time_mix_decode(params, x, cfg: ArchConfig, state: RwkvState):
    """Single-token decode: O(1) state update. x: (B, 1, D)."""
    p = _weights(params, cfg)
    b = x.shape[0]
    h, hd = p["heads"], cfg.recurrent.head_dim
    r, k, v, g, log_w = _projections(p, x, state.x_prev_t, cfg)
    r = r[:, 0].float()                 # (B, H, hd)
    k = k[:, 0].float()
    v = v[:, 0].float()
    w = torch.exp(log_w[:, 0])          # (B, H, hd)
    u = p["bonus_u"].float()
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, state.wkv + u[None, :, :, None] * kv)
    s_new = state.wkv * w[..., None] + kv
    y = _output(p, o.reshape(b, 1, h * hd).to(x.dtype), g)
    return y, RwkvState(s_new, x[:, -1], state.x_prev_c)


def rwkv_channel_mix(params, x, x_prev):
    """RWKV squared-ReLU channel mix with token shift."""
    ff = params["w_in"].shape[-1]
    split = common.model_split("ff", ff)
    if split:
        x = common.enter_tp(x)
    xk = _token_shift(x, x_prev, common.tp_weight(
        params["mu_k"], grad="sum" if split else "mean"))
    h = torch.relu(xk @ common.tp_weight(params["w_in"],
                                         1 if split else None)).square()
    h = common.shard(h, ("batch", "seq", "ff"), ff=ff)
    y = h @ common.tp_weight(params["w_out"], 0 if split else None)
    return common.leave_tp(y) if split else y
