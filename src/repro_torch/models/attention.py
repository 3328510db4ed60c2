"""GQA attention with RoPE / M-RoPE, optional QKV bias, sliding windows,
KV-cache prefill and decode, the flash-attention kernel switch (the
prefill of ``impl="flash"`` and ``"flash_moe"``) and the reference's
blocked and local stand-ins for it (the port of
``repro.models.attention``).

Layouts as in the reference: activations (B, S, D); q/k/v (B, S, H, Dh);
weights ``wq`` (D, H, Dh), ``wk``/``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D).
The KV cache of full attention is (B, S_max, Hkv, Dh); sliding-window
layers keep a rolling cache of ``window`` slots, token j in slot
j % window. Decode writes the new token into the cache in place (the
reference returned an updated copy); the returned cache holds the same
tensors.

Tensor parallelism (a step whose rules split ``heads`` over
``"model"``): ``wq``/``bq`` are column-parallel on the rank's heads,
``wk``/``wv``/``bk``/``bv`` on its KV heads where those divide too, else
whole on every model rank (their gradients then summed over
``"model"``: each rank's query heads use them for other work), and
``wo`` is row-parallel. Each local query head attends to its own KV
head (``_local_kv``). The decode cache follows ``rules.cache_pspec``:
the rank's KV heads where they split, else, where the cache's slots
divide over the model ranks, the rank's block of slots (``cache_split``).
On a slot-split cache each rank writes the slots it owns, and decode
attends every head over the rank's slots and merges the ranks' partial
softmaxes by log-sum-exp over ``"model"`` (``_merge_partials``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard_map as sm
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import common
from repro_torch.models.common import dense_init, zeros_init

NEG_INF = -2.3819763e38


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, Hkv, Dh)
    v: torch.Tensor
    length: int              # tokens currently in the cache
    # All the slots, where the rank holds a block of them over "model"
    # (``cache_split`` "seq"); 0 where the rank holds every slot.
    slots: int = 0


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


class Layout(NamedTuple):
    """How a step's rules place attention on the model ranks."""
    heads: bool              # query heads split over "model"
    kv: bool                 # KV heads split too
    tp: int
    rank: int


def layout(cfg: ArchConfig) -> Layout:
    heads = common.model_split("heads", cfg.num_heads)
    kv = heads and common.model_split("kv_heads", cfg.num_kv_heads)
    return Layout(heads, kv, common.tp_size(), common.tp_rank())


def cache_split(kv_heads: int, size: int, **given) -> Optional[str]:
    """How a decode cache of ``size`` slots and ``kv_heads`` KV heads lies
    over ``"model"``: ``"kv"`` (the rank's KV heads), ``"seq"`` (the
    rank's block of slots) or None (whole), as ``rules.cache_pspec``
    places it where the rules put heads on ``"model"``. The running
    step's rules unless ``given`` (``rules``, ``mesh``, ``split``). (KV
    heads that divide imply query heads that do: they are a multiple.)"""
    if not common.model_split("heads", 0, **given):
        # (Size 0 divides: the rules keep attention whole on "model".)
        return None
    if common.model_split("kv_heads", kv_heads, **given):
        return "kv"
    return "seq" if common.model_split("heads", size, **given) else None


def _kv_grad(lay: Layout) -> str:
    """How the gradient of a whole KV weight meets over "model": summed
    where the ranks' query heads differ, averaged where all do the same."""
    return "sum" if lay.heads else "mean"


def _project_qkv(params, x, cfg: ArchConfig, positions, lay: Layout):
    """q on the rank's heads; k, v on its KV heads, or all of them."""
    if lay.heads:
        x = common.enter_tp(x)
    qd = 1 if lay.heads else None
    kd = 1 if lay.kv else None
    kg = _kv_grad(lay)
    q = torch.einsum("bsd,dhk->bshk", x, common.tp_weight(params["wq"], qd))
    k = torch.einsum("bsd,dhk->bshk", x,
                     common.tp_weight(params["wk"], kd, grad=kg))
    v = torch.einsum("bsd,dhk->bshk", x,
                     common.tp_weight(params["wv"], kd, grad=kg))
    if cfg.qkv_bias:
        q = q + common.tp_weight(params["bq"], None if qd is None else 0)
        k = k + common.tp_weight(params["bk"], None if kd is None else 0,
                                 grad=kg)
        v = v + common.tp_weight(params["bv"], None if kd is None else 0,
                                 grad=kg)
    if cfg.rope == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = common.apply_mrope(q, positions, cfg.mrope_sections,
                               cfg.rope_theta)
        k = common.apply_mrope(k, positions, cfg.mrope_sections,
                               cfg.rope_theta)
    q = common.shard(q, ("batch", "seq", "heads", None), heads=cfg.num_heads)
    k = common.shard(k, ("batch", "seq", "kv_heads", None),
                     kv_heads=cfg.num_kv_heads)
    v = common.shard(v, ("batch", "seq", "kv_heads", None),
                     kv_heads=cfg.num_kv_heads)
    return q, k, v


def _local_kv(k, v, cfg: ArchConfig, lay: Layout):
    """The KV heads the rank's query heads attend to, in the grouping the
    attention routines read (local query head i to KV head i // groups):
    k and v as they are unless the query heads are split and the KV heads
    are not; then the one KV head the rank's heads share, or the KV heads
    of whole groups, or one KV head copied per query head."""
    if not lay.heads or lay.kv:
        return k, v
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    hl, g = h // lay.tp, h // hkv
    a = lay.rank * hl
    lo, hi = a // g, (a + hl - 1) // g + 1
    if hi - lo == 1 or (hl % g == 0 and a % g == 0):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = (a + torch.arange(hl, device=k.device)) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _out_proj(params, out, lay: Layout):
    """``wo``: row-parallel on the rank's heads under TP."""
    y = torch.einsum("bshk,hkd->bsd", out,
                     common.tp_weight(params["wo"], 0 if lay.heads else None))
    return common.leave_tp(y) if lay.heads else y


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
    # "flash_moe" (the grouped-matmul kernel in the MoE layers) takes the
    # flash kernel too, where the reference's flash_moe keeps the reference
    # attention: its float32 scores are 4.3 GB a layer at DeepSeekMoE's
    # 4 x 4,096 tokens.
    if impl in ("flash", "flash_moe"):
        return flash_kernel.flash_attention(q, k, v, causal=True,
                                            window=window)
    if impl == "blocked" and window and window <= q.shape[1]:
        return _local_sdpa(q, k, v, window=window)
    if impl == "blocked":
        return _blocked_sdpa(q, k, v, causal=True, window=window)
    if impl != "reference":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _sdpa(q, k, v, causal=True, window=window)


def attention(params, x, cfg: ArchConfig, positions, *,
              window: int = 0, impl: str = "reference") -> torch.Tensor:
    """Full-sequence (train / prefill) attention."""
    lay = layout(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions, lay)
    out = _attend(q, *_local_kv(k, v, cfg, lay), window=window, impl=impl)
    out = common.shard(out, ("batch", "seq", "heads", None),
                       heads=cfg.num_heads)
    return _out_proj(params, out, lay)


def attention_prefill(params, x, cfg: ArchConfig, positions, *,
                      cache_len: int, window: int = 0,
                      impl: str = "reference"):
    """Prefill: run full attention and build the KV cache (the rank's
    part of it, as ``cache_split`` places it)."""
    lay = layout(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions, lay)
    out = _attend(q, *_local_kv(k, v, cfg, lay), window=window, impl=impl)
    y = _out_proj(params, out, lay)
    b, s = x.shape[0], x.shape[1]
    size = min(window, cache_len) if window else cache_len
    # The slots the rank keeps: all of them, or its block of them.
    seq = cache_split(cfg.num_kv_heads, size) == "seq"
    count = size // lay.tp if seq else size
    g = lay.rank * count * seq + torch.arange(count, device=x.device)
    if window and s > size:
        # Rolling layout: token j lives at slot j % window, so the next
        # decode step (slot position % window) overwrites the oldest
        # entry; slot g holds the last token j < s with j % size == g.
        tok = g + size * torch.div(s - 1 - g, size, rounding_mode="floor")
        keep = torch.ones_like(g, dtype=torch.bool)
    else:
        tok, keep = g, g < min(s, size)
    # Slots past the prompt stay zero; a gather and a select (no boolean
    # indexing, whose output size depends on the data).
    tok = tok.clamp(max=s - 1)
    kc = torch.where(keep[:, None, None], k[:, tok], 0)
    vc = torch.where(keep[:, None, None], v[:, tok], 0)
    return y, KVCache(kc, vc, min(s, size), size if seq else 0)


def _partial(q, k, v, valid):
    """One rank's part of decode attention over its slots: the running
    max m, the sum of exponentials l and the unnormalised output acc of
    every query head (float32). q: (B, 1, H, Dh); k, v: (B, L, Hkv, Dh);
    valid: (L,) bool."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(dh)
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m, p.sum(dim=-1), acc


def _merge_partials(m, l, acc, mesh):
    """The softmax over every rank's slots from the ranks' partials: each
    rescaled to the global max (log-sum-exp) before the sums over
    ``"model"``."""
    top = sm.all_reduce(m, mesh, "model", op=dist.ReduceOp.MAX)
    scale = torch.exp(m - top)
    num = sm.all_reduce(acc * scale[..., None], mesh, "model")
    den = sm.all_reduce(l * scale, mesh, "model")
    return num / den[..., None]


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
    lay = layout(cfg)
    q, k, v = _project_qkv(params, x, cfg, pos, lay)
    local = cache.k.shape[1]
    size = cache.slots or local
    slot = position % size if window else min(position, size - 1)
    new_len = min(cache.length + 1, size)
    if not cache.slots:
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        # Rolling window caches are position-scrambled; attention over a
        # window is permutation-invariant given the causal validity mask.
        out = _sdpa(q, *_local_kv(cache.k, cache.v, cfg, lay),
                    causal=False, kv_length=new_len)
        return _out_proj(params, out, lay), KVCache(cache.k, cache.v,
                                                    new_len)
    # Slot-split cache: the owner writes the slot; every rank attends all
    # heads over its slots, and the partials merge over "model".
    first = lay.rank * local
    if first <= slot < first + local:
        cache.k[:, slot - first] = k[:, 0]
        cache.v[:, slot - first] = v[:, 0]
    _, mesh, _ = common.installed_rules()
    q_all = sm.gather(q, 2, mesh, "model") if lay.heads else q
    valid = first + torch.arange(local, device=x.device) < new_len
    out = _merge_partials(*_partial(q_all, cache.k, cache.v, valid), mesh)
    h, dh = cfg.num_heads, q.shape[-1]
    out = out.movedim(-2, 1).reshape(b, 1, h, dh).to(q.dtype)
    if lay.heads:
        hl = h // lay.tp
        out = out[:, :, lay.rank * hl:(lay.rank + 1) * hl]
    return _out_proj(params, out, lay), KVCache(cache.k, cache.v, new_len,
                                                size)
