"""GQA attention with RoPE / M-RoPE, optional QKV bias, sliding windows,
KV-cache prefill and decode, the flash-attention kernel switch and the
reference's blocked and local stand-ins for it (the port of
``repro.models.attention``).

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
        "wq": dense_init(gen, (d, h, dh), ("embed", "heads", "head_dim")),
        "wk": dense_init(gen, (d, hkv, dh),
                         ("embed", "kv_heads", "head_dim")),
        "wv": dense_init(gen, (d, hkv, dh),
                         ("embed", "kv_heads", "head_dim")),
        "wo": dense_init(gen, (h, dh, d), ("heads", "head_dim", "embed"),
                         fan_in=h * dh),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init(gen, (h, dh), ("heads", "head_dim"))
        p["bk"] = zeros_init(gen, (hkv, dh), ("kv_heads", "head_dim"))
        p["bv"] = zeros_init(gen, (hkv, dh), ("kv_heads", "head_dim"))
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


def _blocked_sdpa(q, k, v, *, causal: bool, window: int = 0,
                  block_k: int = 1024) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over KV blocks with
    a running (max, denominator, accumulator) online softmax. Never
    builds the (Sq, Skv) scores, an O(Sq x block_k) working set: the
    reference's stand-in for the flash kernel, differentiable."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    block_k = min(block_k, skv)
    assert skv % block_k == 0
    dev = q.device
    qf = q.reshape(b, sq, hkv, g, dh).float()
    scale = 1.0 / math.sqrt(dh)
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=dev)
    for start in range(0, skv, block_k):
        kc = k[:, start:start + block_k].float()
        vc = v[:, start:start + block_k].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc) * scale
        k_pos = start + torch.arange(block_k, device=dev)
        mask = torch.ones((sq, block_k), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        safe = m_new > NEG_INF / 2
        alpha = torch.where(safe, torch.exp(m - m_new), 0.0)
        p = torch.where(safe[..., None], torch.exp(logits - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vc)
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    out = out.movedim(-2, 1).reshape(b, sq, h, dh)
    return out.to(q.dtype)


def _local_sdpa(q, k, v, *, window: int) -> torch.Tensor:
    """Sliding-window attention by chunks of ``window`` queries, each
    attending within its chunk and the previous one (exact for window <=
    chunk): O(S x 2W) compute and memory, in place of the S x S scores
    and their masked blocks."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    chunk = window
    pad = (-s) % chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
    sp = q.shape[1]
    nc = sp // chunk
    dev = q.device
    qc = q.reshape(b, nc, chunk, hkv, g, dh).float()
    kc = k.reshape(b, nc, chunk, hkv, dh).float()
    vc = v.reshape(b, nc, chunk, hkv, dh).float()
    # previous chunk's K/V (zeros before the first chunk)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([kprev, kc], dim=2)                 # (B, nc, 2W, hkv, d)
    vv = torch.cat([vprev, vc], dim=2)
    scale = 1.0 / math.sqrt(dh)
    qpos = torch.arange(chunk, device=dev)[:, None] + chunk   # [W, 2W)
    kpos = torch.arange(2 * chunk, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    first = mask & (kpos >= chunk)                     # no previous chunk
    # One chunk at a time: the live set is O(B x W x 2W x H), not
    # O(B x S x 2W x H).
    outs = []
    for c in range(nc):
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qc[:, c],
                              kk[:, c]) * scale
        logits = torch.where(first if c == 0 else mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vv[:, c]))
    out = torch.stack(outs, dim=1).reshape(b, sp, h, dh)[:, :s]
    return out.to(q.dtype)


def _attend(q, k, v, *, window: int, impl: str):
    if impl == "flash":
        return flash_kernel.flash_attention(q, k, v, causal=True,
                                            window=window)
    if impl == "blocked" and window and window <= q.shape[1]:
        return _local_sdpa(q, k, v, window=window)
    if impl == "blocked":
        return _blocked_sdpa(q, k, v, causal=True, window=window)
    # "flash_moe" selects the grouped-matmul kernel for the MoE layers and
    # the reference attention, as in the reference.
    if impl not in ("reference", "flash_moe"):
        raise ValueError(f"unknown attention impl {impl!r}")
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
