"""Model assembly: the decoder as one module per layer, walked by a Python
loop (the port of ``repro.models.transformer``).

The reference stacks each segment's layers on a leading axis and runs
them with ``lax.scan``; eager PyTorch needs neither, so the port keeps a
flat ``nn.ModuleList`` in layer order. ``compute_segments`` stays for the
weight converter, which unstacks the reference's segments into it.

Entry points: ``forward_train`` (loss), ``forward_prefill`` (last-token
logits + caches) and ``forward_decode`` (one-token step); caches are a
list with one entry per layer (``KVCache``, ``RwkvState`` or
``RglruState``). Each takes a ``mesh``: then the model's parameters are
DTensors placed by ``sharding.rules`` (``init_model(mesh=...)``,
``convert.from_reference(mesh=...)``), the batch and the caches are the
rank's batch shard over ``(pod, data)``, every layer gathers its dense
weights where it uses them (``common.gather_param``) and the MoE
layers run the expert-parallel path. The ranks of ``"model"`` compute
the dense layers of their batch shard whole: the reference's activation
tensor parallelism (``ACT_RULES`` on heads, ff and vocab) is not ported.
The loss sums its numerator and its mask count over the batch axes
before dividing, as the reference's global mean does.

Under ``cfg.remat == "block"`` training runs each repeat of a segment's
unit (the reference's scan body) under ``torch.utils.checkpoint``, so
only the units' inputs stay alive for the backward pass and each unit's
activations are recomputed.

Block kinds:
  attn    — RMSNorm -> GQA attention -> RMSNorm -> SwiGLU
  local   — same, sliding-window attention (cfg.window)
  moe     — RMSNorm -> GQA attention -> RMSNorm -> MoE (+ shared experts)
  dense0  — 'attn' with the MoE config's dense_d_ff (DeepSeekMoE layer 0)
  rwkv    — RWKV-6 time-mix -> channel-mix (attention-free)
  rec     — RG-LRU recurrent block -> SwiGLU
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard_map as sm
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (Params, batch_split, embed_init,
                                       gather_param, ones_init, rms_norm,
                                       shard, split_tree)
from repro_torch.sharding import rules as shrules

PORTED_KINDS = ("attn", "local", "moe", "dense0", "rwkv", "rec")
_ATTENTION_KINDS = ("attn", "local", "moe", "dense0")


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Segments (kept for the weight converter)
# ---------------------------------------------------------------------------

def compute_segments(cfg: ArchConfig) -> list[tuple[tuple[str, ...], int]]:
    kinds = cfg.layer_kinds()
    if cfg.moe and cfg.moe.first_k_dense:
        for i in range(cfg.moe.first_k_dense):
            kinds[i] = "dense0"
    segs: list[tuple[tuple[str, ...], int]] = []
    i, n = 0, len(kinds)
    while i < n:
        best = (1, 1)
        for ul in (1, 2, 3, 4):
            unit = kinds[i:i + ul]
            if len(unit) < ul:
                break
            r = 1
            while kinds[i + r * ul: i + (r + 1) * ul] == unit:
                r += 1
            # Only repeating units justify a scan stack; a one-shot long
            # unit would glue heterogeneous layers into one segment.
            if r > 1 and r * ul > best[0] * best[1]:
                best = (ul, r)
        if best == (1, 1):
            # Run-length of the single kind at i.
            r = 1
            while i + r < n and kinds[i + r] == kinds[i]:
                r += 1
            best = (1, r)
        ul, r = best
        segs.append((tuple(kinds[i:i + ul]), r))
        i += ul * r
    assert sum(len(u) * r for u, r in segs) == n
    return segs


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Kinds in execution order: each segment's unit, repeat by repeat."""
    return [kind for unit, repeats in compute_segments(cfg)
            for _ in range(repeats) for kind in unit]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Layer(Params):
    """One decoder layer: its kind and its parameter groups."""

    def __init__(self, kind: str, tree: dict):
        check_kind(kind)
        super().__init__(tree)
        self.kind = kind


class Model(nn.Module):
    """Embedding, layers in execution order, final norm and LM head."""

    def __init__(self, top: dict, layers: list[Layer]):
        super().__init__()
        self.top = Params(top)
        self.layers = nn.ModuleList(layers)

    def __getitem__(self, name: str):
        return self.top[name]


def _init_sublayer(gen, kind: str, cfg: ArchConfig) -> dict:
    p: dict[str, Any] = {"ln1": ones_init(gen, (cfg.d_model,), ("embed",))}
    if kind in _ATTENTION_KINDS:
        p["attn"] = attn_mod.init_attention(gen, cfg)
        p["ln2"] = ones_init(gen, (cfg.d_model,), ("embed",))
        if kind == "moe":
            p["ffn"] = moe_mod.init_moe(gen, cfg)
        elif kind == "dense0":
            p["ffn"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.moe.dense_d_ff)
        else:
            p["ffn"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff)
    elif kind == "rwkv":
        p["tmix"] = rwkv_mod.init_rwkv(gen, cfg)
        p["ln2"] = ones_init(gen, (cfg.d_model,), ("embed",))
        p["cmix"] = rwkv_mod.init_rwkv_channel_mix(gen, cfg)
    else:
        p["rgl"] = rglru_mod.init_rglru(gen, cfg)
        p["ln2"] = ones_init(gen, (cfg.d_model,), ("embed",))
        p["ffn"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff)
    return p


def _cast(tree: dict, dtype) -> dict:
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in tree.items()}


def _init_top(gen, cfg: ArchConfig) -> dict:
    top = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed_table")),
           "ln_f": ones_init(gen, (cfg.d_model,), ("embed",))}
    if not cfg.tie_embeddings:
        top["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                    ("embed", "vocab"))
    return top


def _param_trees(cfg: ArchConfig, gen):
    """("top", tree), then (layer index, kind, tree) per layer in
    execution order: ``Param`` trees, drawn in the order of the
    reference's draws. The generator keeps no tree it has yielded."""
    yield None, "top", _init_top(gen, cfg)
    for i, kind in enumerate(layer_kinds(cfg)):
        yield i, kind, _init_sublayer(gen, kind, cfg)


def _flat(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}"
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def param_axes(cfg: ArchConfig) -> dict:
    """{parameter name: logical axes} by ``Model.named_parameters()``
    names, as each ``init_*`` records them (no layers axis: the port does
    not stack layers). Shapes only: nothing is drawn."""
    out = {}
    for i, _, tree in _param_trees(cfg, None):
        _, axes = split_tree(tree)
        out.update(_flat(axes, "top" if i is None else f"layers.{i}"))
    return out


def param_shapes(cfg: ArchConfig) -> dict:
    """{parameter name: shape}, without drawing anything."""
    out = {}
    for i, _, tree in _param_trees(cfg, None):
        values, _ = split_tree(tree)
        out.update({k: tuple(v.shape) for k, v in
                    _flat(values, "top" if i is None else
                          f"layers.{i}").items()})
    return out


def distribute(values: dict, axes: dict, mesh,
               rules: Optional[dict] = None) -> dict:
    """``values`` (whole tensors, nested like ``axes``) as DTensors holding
    this rank's shards by the rules; the whole tensors may be freed."""
    out = {}
    for k, v in values.items():
        if isinstance(v, dict):
            out[k] = distribute(v, axes[k], mesh, rules)
            continue
        spec = shrules.pspec_for(tuple(v.shape), axes[k], mesh, rules)
        local = sm.local_shard(v, spec, mesh).contiguous().clone()
        out[k] = sm.make_dtensor(local, spec, mesh, v.shape)
    return out


def init_model(cfg: ArchConfig, gen: torch.Generator,
               dtype: Optional[torch.dtype] = None, *, mesh=None,
               rules: Optional[dict] = None) -> Model:
    """Random weights with the reference's distributions, drawn on
    ``gen.device``. With ``dtype``, every float32 tensor is cast to it as
    soon as it is drawn (what the serving engine does to the whole tree),
    so a full-size model never exists in float32 at once. With ``mesh``,
    every rank draws the same weights and keeps its shards (DTensors), a
    layer at a time."""
    kinds = layer_kinds(cfg)
    for kind in kinds:          # before drawing anything
        check_kind(kind)
    top, layers = None, []
    for i, kind, tree in _param_trees(cfg, gen):
        values, axes = split_tree(tree)
        # Each tree's float32 draws are freed before the next tree is
        # drawn: at most one layer (or the embeddings) exists in float32.
        del tree
        if dtype is not None:
            values = _cast(values, dtype)
        if mesh is not None:
            values = distribute(values, axes, mesh, rules)
        if i is None:
            top = values
        else:
            layers.append(Layer(kind, values))
    return Model(top, layers)


def param_count(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Sub-layer application (single layer, full-sequence or decode)
# ---------------------------------------------------------------------------

def gathered(p: Params, mesh) -> dict:
    """A parameter group as nested dicts of the tensors a rank computes
    with: each DTensor gathered whole (``common.gather_param``)."""
    return {k: gathered(p[k], mesh) if isinstance(p[k], Params)
            else gather_param(p[k], mesh) for k in p._keys}


def _apply_layer(p: Layer, x, cfg: ArchConfig, positions, *, impl: str,
                 mode: str, cache=None, cache_len: int = 0, position=None,
                 mesh=None):
    """Returns (x, aux, new_cache); ``aux`` is the MoE load-balance loss
    (a float32 scalar) or None, ``new_cache`` None in ``mode="train"``.
    Under ``mesh`` the layer's weights are gathered here, where they are
    used; a MoE layer's experts stay sharded (``moe_layer`` runs EP)."""
    kind = p.kind
    if mesh is not None:
        p = {k: p[k] if (kind == "moe" and k == "ffn")
             else gathered(p[k], mesh) if isinstance(p[k], Params)
             else gather_param(p[k], mesh) for k in p._keys}
    aux = None
    window = cfg.window if kind == "local" else 0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in _ATTENTION_KINDS:
        new_cache = None
        if mode == "train":
            a = attn_mod.attention(p["attn"], h, cfg, positions,
                                   window=window, impl=impl)
        elif mode == "prefill":
            a, new_cache = attn_mod.attention_prefill(
                p["attn"], h, cfg, positions, cache_len=cache_len,
                window=window, impl=impl)
        else:
            a, new_cache = attn_mod.attention_decode(
                p["attn"], h, cfg, position, cache, window=window)
        x = x + a
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            f, aux = moe_mod.moe_layer(p["ffn"], h2, cfg, mesh=mesh,
                                       use_kernel=(impl == "flash_moe"))
        else:
            f = mlp_mod.mlp(p["ffn"], h2)
        return x + f, aux, new_cache
    if kind == "rwkv":
        if mode == "decode":
            a, new_cache = rwkv_mod.rwkv_time_mix_decode(p["tmix"], h, cfg,
                                                         cache)
        else:
            # Train and prefill start from zero token-shift and WKV
            # state, as in the reference.
            a, new_cache = rwkv_mod.rwkv_time_mix(
                p["tmix"], h, cfg, None, use_kernel=(impl == "flash"))
        x = x + a
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x_prev_c = new_cache.x_prev_c if mode == "decode" \
            else x.new_zeros((x.shape[0], x.shape[-1]))
        c = rwkv_mod.rwkv_channel_mix(p["cmix"], h2, x_prev_c)
        new_cache = None if mode == "train" else rwkv_mod.RwkvState(
            new_cache.wkv, new_cache.x_prev_t, h2[:, -1])
        return x + c, aux, new_cache
    if mode == "decode":
        a, new_cache = rglru_mod.rglru_block_decode(p["rgl"], h, cfg, cache)
    else:
        a, new_cache = rglru_mod.rglru_block(
            p["rgl"], h, cfg, None, use_kernel=(impl == "flash"))
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_mod.mlp(p["ffn"], h2), aux, \
        None if mode == "train" else new_cache


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               device="cuda") -> list[Any]:
    """Empty per-layer caches for decode entry, on ``device`` (the card
    by default; raises when there is none)."""
    device = resolve_device(device)
    hd = cfg.head_dim
    caches = []
    for kind in layer_kinds(cfg):
        check_kind(kind)
        if kind in _ATTENTION_KINDS:
            size = min(cfg.window, cache_len) if kind == "local" \
                else cache_len
            shape = (batch, size, cfg.num_kv_heads, hd)
            caches.append(KVCache(
                torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device), 0))
        elif kind == "rwkv":
            rd = cfg.recurrent.head_dim
            caches.append(rwkv_mod.RwkvState(
                torch.zeros((batch, cfg.d_model // rd, rd, rd),
                            dtype=torch.float32, device=device),
                torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
                torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device)))
        else:
            w = cfg.recurrent.lru_width or cfg.d_model
            caches.append(rglru_mod.RglruState(
                torch.zeros((batch, w), dtype=torch.float32, device=device),
                torch.zeros((batch, cfg.recurrent.conv_width - 1, w),
                            dtype=dtype, device=device)))
    return caches


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _top(model: Model, name: str, mesh):
    w = model[name]
    return gather_param(w, mesh) if mesh is not None else w


def _embed_inputs(model: Model, cfg: ArchConfig, batch: dict, mesh=None):
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.activation_dtype)
    else:
        x = _top(model, "embed", mesh)[batch["tokens"]].to(
            cfg.activation_dtype)
    x = shard(x, ("batch", "seq", "embed"))
    b, s = x.shape[0], x.shape[1]
    ar = torch.arange(s, device=x.device)
    if cfg.rope == "mrope":
        positions = batch.get("mrope_positions")
        if positions is None:
            positions = ar[None, None].expand(3, b, s)
    else:
        positions = ar[None].expand(b, s)
    return x, positions


def _lm_head(model: Model, cfg: ArchConfig, x, mesh=None):
    x = rms_norm(x, _top(model, "ln_f", mesh), cfg.norm_eps)
    w = _top(model, "embed", mesh).t() if cfg.tie_embeddings \
        else _top(model, "lm_head", mesh)
    return shard((x @ w).float(), ("batch", "seq", "vocab"))


def _train_unit(layers, cfg: ArchConfig, impl: str, x, aux, positions,
                mesh=None):
    """One repeat of a segment's unit in ``mode="train"``: (x, aux)."""
    for layer in layers:
        x, a, _ = _apply_layer(layer, x, cfg, positions, impl=impl,
                               mode="train", mesh=mesh)
        x = shard(x, ("batch", "seq", "embed"))
        if a is not None:
            aux = aux + a
    return x, aux


def masked_mean(nll, mask, mesh=None):
    """Sum(nll * mask) / sum(mask) over the global batch: under a mesh
    both sums are reduced over the axes the batch is split on before the
    division (a mean of per-shard means is wrong where the shards' masks
    differ; ranks holding the same rows are counted once)."""
    num = torch.sum(nll * mask)
    den = torch.sum(mask).detach()
    if mesh is not None:
        axes = batch_split(mesh)
        num = sm.reduce_out(num, mesh, axes)
        for a in axes:
            den = sm.all_reduce(den, mesh, a)
    return num / den.clamp_min(1.0)


def forward_train(model: Model, cfg: ArchConfig, batch: dict, *,
                  impl: str = "reference", mesh=None):
    """Returns (loss, {"nll", "aux"}). batch: tokens|embeds, labels,
    [mask], [mrope_positions] (under ``mesh``, the rank's batch shard;
    every rank gets the global loss). The loss is the masked mean of
    logsumexp - gold logit, plus ``router_aux_weight`` times the layers'
    summed MoE load-balance losses, as in the reference."""
    x, positions = _embed_inputs(model, cfg, batch, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    i = 0
    for unit, repeats in compute_segments(cfg):
        for _ in range(repeats):
            layers = list(model.layers[i:i + len(unit)])
            i += len(unit)
            if cfg.remat != "none":
                x, aux = checkpoint(_train_unit, layers, cfg, impl, x, aux,
                                    positions, mesh, use_reentrant=False)
            else:
                x, aux = _train_unit(layers, cfg, impl, x, aux, positions,
                                     mesh)
    logits = _lm_head(model, cfg, x, mesh)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = masked_mean(nll, mask, mesh)
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss, {"nll": loss, "aux": aux}


def forward_prefill(model: Model, cfg: ArchConfig, batch: dict,
                    cache_len: int, *, impl: str = "reference", mesh=None):
    """Returns (last_token_logits (B, V) float32, caches)."""
    x, positions = _embed_inputs(model, cfg, batch, mesh)
    caches = []
    for layer in model.layers:
        x, _, c = _apply_layer(layer, x, cfg, positions, impl=impl,
                               mode="prefill", cache_len=cache_len,
                               mesh=mesh)
        x = shard(x, ("batch", "seq", "embed"))
        caches.append(c)
    logits = _lm_head(model, cfg, x[:, -1:], mesh)
    return logits[:, 0], caches


def forward_decode(model: Model, cfg: ArchConfig, tokens, caches,
                   position: int, *, mesh=None):
    """One decode step. tokens: (B, 1) int; position: int. Returns
    (logits (B, V), new_caches). Attention caches are updated in place."""
    x = _top(model, "embed", mesh)[tokens].to(cfg.activation_dtype)
    x = shard(x, ("batch", "seq", "embed"))
    new_caches = []
    for layer, c in zip(model.layers, caches):
        x, _, c = _apply_layer(layer, x, cfg, None, impl="reference",
                               mode="decode", cache=c, position=position,
                               mesh=mesh)
        new_caches.append(c)
    logits = _lm_head(model, cfg, x, mesh)
    return logits[:, 0], new_caches
