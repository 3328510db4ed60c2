"""GQA attention with RoPE / M-RoPE, optional QKV bias, sliding windows,
KV-cache prefill and decode, and the flash-attention kernel switch (the
port of ``repro.models.attention``).

Layouts as in the reference: activations (B, S, D); q/k/v (B, S, H, Dh);
weights ``wq`` (D, H, Dh), ``wk``/``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D).
The KV cache of full attention is (B, S_max, Hkv, Dh); sliding-window
layers keep a rolling cache of ``window`` slots, token j in slot
j % window. Decode writes the new token into the cache in place (the
reference returned an updated copy); the returned cache holds the same
tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import common
from repro_torch.models.common import dense_init, zeros_init

NEG_INF = -2.3819763e38


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, Hkv, Dh)
    v: torch.Tensor
    length: int              # tokens currently in the cache


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, dh)),
        "wk": dense_init(gen, (d, hkv, dh)),
        "wv": dense_init(gen, (d, hkv, dh)),
        "wo": dense_init(gen, (h, dh, d), fan_in=h * dh),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init(gen, (h, dh))
        p["bk"] = zeros_init(gen, (hkv, dh))
        p["bv"] = zeros_init(gen, (hkv, dh))
    return p


def _project_qkv(params, x, cfg: ArchConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.rope == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = common.apply_mrope(q, positions, cfg.mrope_sections,
                               cfg.rope_theta)
        k = common.apply_mrope(k, positions, cfg.mrope_sections,
                               cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, window: int = 0,
          kv_length: Optional[int] = None,
          q_offset: Optional[int] = None) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,Dh), k/v: (B,Skv,Hkv,Dh)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, groups, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(dh)
    q_pos = torch.arange(sq, device=dev)[:, None]
    if q_offset is not None:
        q_pos = q_pos + q_offset
    k_pos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    if kv_length is not None:
        mask &= k_pos < kv_length
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, dh)


def _attend(q, k, v, *, window: int, impl: str):
    if impl == "flash":
        return flash_kernel.flash_attention(q, k, v, causal=True,
                                            window=window)
    # "flash_moe" selects the grouped-matmul kernel for the MoE layers and
    # the reference attention, as in the reference.
    if impl not in ("reference", "flash_moe"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported (the blocked and local "
            "stand-ins wait for ROADMAP A.11)")
    return _sdpa(q, k, v, causal=True, window=window)


def attention(params, x, cfg: ArchConfig, positions, *,
              window: int = 0, impl: str = "reference") -> torch.Tensor:
    """Full-sequence (train / prefill) attention."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def attention_prefill(params, x, cfg: ArchConfig, positions, *,
                      cache_len: int, window: int = 0,
                      impl: str = "reference"):
    """Prefill: run full attention and build the KV cache."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, window=window, impl=impl)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    b, s = x.shape[0], x.shape[1]
    size = min(window, cache_len) if window else cache_len
    kc = k.new_zeros((b, size) + tuple(k.shape[2:]))
    vc = v.new_zeros((b, size) + tuple(v.shape[2:]))
    if window and s > size:
        # Rolling layout: token j lives at slot j % window, so the next
        # decode step (slot position % window) overwrites the oldest entry.
        slots = torch.arange(s - size, s, device=x.device) % size
        kc[:, slots] = k[:, -size:]
        vc[:, slots] = v[:, -size:]
    else:
        n = min(s, size)
        kc[:, :n] = k[:, :n]
        vc[:, :n] = v[:, :n]
    return y, KVCache(kc, vc, min(s, size))


def attention_decode(params, x, cfg: ArchConfig, position: int,
                     cache: KVCache, *, window: int = 0):
    """One-token decode against the cache. x: (B, 1, D); position: int."""
    b = x.shape[0]
    if cfg.rope == "mrope":
        # Decode emits text tokens: all three M-RoPE streams advance together.
        pos = torch.full((3, b, 1), position, dtype=torch.int32,
                         device=x.device)
    else:
        pos = torch.full((b, 1), position, dtype=torch.int32,
                         device=x.device)
    q, k, v = _project_qkv(params, x, cfg, pos)
    size = cache.k.shape[1]
    slot = position % size if window else min(position, size - 1)
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    new_len = min(cache.length + 1, size)
    # Rolling window caches are position-scrambled; attention over a window
    # is permutation-invariant given the causal validity mask.
    out = _sdpa(q, cache.k, cache.v, causal=False, kv_length=new_len)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, KVCache(cache.k, cache.v, new_len)
