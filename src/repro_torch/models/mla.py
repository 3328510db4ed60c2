"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 section 2.1)
with a latent KV cache.

Weights (``H`` heads, latent ``r = kv_lora_rank``, per head ``dn =
qk_nope_head_dim`` dims without rotary, ``dr = qk_rope_head_dim`` with it
and ``dv = v_head_dim`` of value): ``wq`` (D, H, dn + dr), ``w_kv_a`` (D,
r + dr), ``kv_norm`` (r,), ``w_kv_b`` (r, H, dn + dv) and ``wo`` (H, dv,
D), as the published ``q_proj``, ``kv_a_proj_with_mqa``,
``kv_a_layernorm``, ``kv_b_proj`` and ``o_proj`` lay them out (no query
latent: DeepSeek-V2-Lite has none).

- Queries: ``x wq``, each head's last ``dr`` dims rotated.
- Keys and values: ``[c, k_pe] = x w_kv_a``; ``c`` gets an RMSNorm, and
  ``k_pe``, one rotary key every head shares, is rotated. The rotary pairs
  adjacent dims at YaRN's frequencies (``common.apply_rope_pairs``).
- Prefill (``mla_prefill``, and ``mla_attention`` in training) decompresses
  ``[k_nope, v] = c w_kv_b`` per head and attends with keys ``[k_nope,
  k_pe]`` at ``dn + dr`` dims. On the flash routes that is one launch of
  the flash kernel at ``dn + dr``, the values zero-filled from ``dv`` to
  that width and the output cut back to ``dv``: the zero columns add
  nothing. It writes ``c`` (after the norm) and the rotated ``k_pe`` into
  the cache, ``MLACache`` (B, S_max, r) and (B, S_max, dr), in the
  activation dtype.
- Decode (``mla_decode``) absorbs ``w_kv_b`` into the query and the
  output: the query ``q_nope W_UK`` is a latent of ``r`` per head, the
  scores ``q_lat c^T + q_pe k_pe^T`` over the cache's valid slots, and
  the output ``softmax(...) c W_UV``; one query over the latent cache as
  multi-query attention with keys of ``r + dr`` and values of ``r``, in
  float32 plain ``torch``.

The softmax scale is ``(dn + dr)^-1/2`` times YaRN's mscale squared. Spans
(``core.tracing``, inside ``model.attention``): ``mla.kv_down`` (``w_kv_a``,
the norm, ``k_pe``'s rotary), ``mla.kv_up`` (``w_kv_b``, prefill),
``mla.core`` (the attention) and ``mla.absorb`` (``W_UK`` and ``W_UV``,
decode); the counter ``mla.cache_bytes`` counts the cache bytes a step
writes. Under a mesh every rank computes every head: the weights are
fetched whole (``common.tp_weight``) and no head is split over
``"model"``; the cache keeps the rank's rows of the batch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tracing
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import common
from repro_torch.models.attention import NEG_INF
from repro_torch.models.common import dense_init, ones_init, tp_weight


class MLACache(NamedTuple):
    ckv: torch.Tensor        # (B, S_cache, kv_lora_rank): normed latents
    kpe: torch.Tensor        # (B, S_cache, qk_rope_head_dim): rotated keys
    length: int              # tokens currently in the cache


def init_mla(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init(gen, (d, h, dn + dr),
                         ("embed", "heads", "head_dim")),
        "w_kv_a": dense_init(gen, (d, r + dr), ("embed", None)),
        "kv_norm": ones_init(gen, (r,), (None,)),
        "w_kv_b": dense_init(gen, (r, h, dn + dv),
                             (None, "heads", "head_dim")),
        "wo": dense_init(gen, (h, dv, d), ("heads", "head_dim", "embed"),
                         fan_in=h * dv),
    }


def softmax_scale(cfg: ArchConfig) -> float:
    """(dn + dr)^-1/2, times mscale(factor, mscale_all_dim)^2 under YaRN."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    if cfg.rope_scaling == "yarn" and cfg.yarn_mscale_all_dim:
        scale *= common.yarn_mscale(cfg.rope_factor,
                                    cfg.yarn_mscale_all_dim) ** 2
    return scale


def _count_written(c, k_pe) -> None:
    tracing.count("mla.cache_bytes", (c.numel() + k_pe.numel())
                  * c.element_size())


def _query(params, x, cfg: ArchConfig, positions):
    """(q_nope (B, S, H, dn), q_pe (B, S, H, dr) rotated)."""
    q = torch.einsum("bsd,dhk->bshk", x, tp_weight(params["wq"]))
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    return q_nope, common.apply_rope_pairs(q_pe, positions, cfg)


def _latent(params, x, cfg: ArchConfig, positions):
    """(c (B, S, r) normed, k_pe (B, S, dr) rotated)."""
    with tracing.span("mla.kv_down"):
        kv = x @ tp_weight(params["w_kv_a"])
        c, k_pe = kv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
        c = common.rms_norm(c, tp_weight(params["kv_norm"]), cfg.norm_eps)
        k_pe = common.apply_rope_pairs(k_pe[:, :, None], positions, cfg)
    return c, k_pe[:, :, 0]


def _core(q, k, v, scale: float, impl: str):
    """Causal attention, q and k at one width, v at its own."""
    if impl in ("flash", "flash_moe"):
        dv = v.shape[-1]
        if dv < q.shape[-1]:
            # The kernel takes one head dim; zero columns of V add nothing.
            v = F.pad(v, (0, q.shape[-1] - dv))
        return flash_kernel.flash_attention(q, k, v, causal=True,
                                            scale=scale)[..., :dv]
    if impl not in ("reference", "blocked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_kernel.flash_attention_plain(q, k, v, causal=True,
                                              scale=scale)


def _full(params, x, cfg: ArchConfig, positions, impl: str):
    """Attention over the whole sequence: (y, c, k_pe)."""
    b, s, h = x.shape[0], x.shape[1], cfg.num_heads
    q_nope, q_pe = _query(params, x, cfg, positions)
    c, k_pe = _latent(params, x, cfg, positions)
    with tracing.span("mla.kv_up"):
        kv = torch.einsum("bsc,chk->bshk", c, tp_weight(params["w_kv_b"]))
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(
        b, s, h, cfg.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_pe], -1)
    with tracing.span("mla.core"):
        out = _core(q, k, v, softmax_scale(cfg), impl)
    y = torch.einsum("bshk,hkd->bsd", out, tp_weight(params["wo"]))
    return y, c, k_pe


def mla_attention(params, x, cfg: ArchConfig, positions, *,
                  impl: str = "reference") -> torch.Tensor:
    """Full-sequence (train) attention."""
    return _full(params, x, cfg, positions, impl)[0]


def mla_prefill(params, x, cfg: ArchConfig, positions, *, cache_len: int,
                impl: str = "reference"):
    """Prefill: full attention, and the latent cache of ``cache_len``
    slots holding the prompt's."""
    b, s = x.shape[0], x.shape[1]
    if s > cache_len:
        raise ValueError(f"a prompt of {s} tokens in a cache of "
                         f"{cache_len} slots")
    y, c, k_pe = _full(params, x, cfg, positions, impl)
    ckv = c.new_zeros((b, cache_len, c.shape[-1]))
    kpe = k_pe.new_zeros((b, cache_len, k_pe.shape[-1]))
    ckv[:, :s] = c
    kpe[:, :s] = k_pe
    _count_written(c, k_pe)
    return y, MLACache(ckv, kpe, s)


def mla_decode(params, x, cfg: ArchConfig, position: int,
               cache: MLACache):
    """One-token decode over the latent cache. x: (B, 1, D)."""
    b = x.shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _query(params, x, cfg, pos)
    c, k_pe = _latent(params, x, cfg, pos)
    size = cache.ckv.shape[1]
    slot = min(position, size - 1)
    cache.ckv[:, slot] = c[:, 0]
    cache.kpe[:, slot] = k_pe[:, 0]
    new_len = min(cache.length + 1, size)
    _count_written(c, k_pe)
    w_uk, w_uv = tp_weight(params["w_kv_b"]).float().split(
        [cfg.qk_nope_head_dim, cfg.v_head_dim], -1)
    with tracing.span("mla.absorb"):
        q_lat = torch.einsum("bqhd,chd->bqhc", q_nope.float(), w_uk)
    with tracing.span("mla.core"):
        ckv = cache.ckv.float()
        scores = (torch.einsum("bqhc,bkc->bhqk", q_lat, ckv)
                  + torch.einsum("bqhr,bkr->bhqk", q_pe.float(),
                                 cache.kpe.float())) * softmax_scale(cfg)
        valid = torch.arange(size, device=x.device) < new_len
        scores = torch.where(valid, scores, NEG_INF)
        o_lat = torch.einsum("bhqk,bkc->bqhc", torch.softmax(scores, -1),
                             ckv)
    with tracing.span("mla.absorb"):
        out = torch.einsum("bqhc,chd->bqhd", o_lat, w_uv).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, tp_weight(params["wo"]))
    return y, MLACache(cache.ckv, cache.kpe, new_len)
