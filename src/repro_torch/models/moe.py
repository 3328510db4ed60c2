"""Fine-grained mixture-of-experts with capacity-based token-choice routing
(the port of ``repro.models.moe``).

Two execution paths with identical math:
  * single-device: dispatch/compute/combine on the local token set;
  * expert-parallel (``_moe_ep``, under a mesh): the reference's
    ``shard_map`` path on ``torch.distributed`` (``core.shard_map``),
    experts sharded over ``"model"``. Train and prefill (S divisible by
    the model axis' size tp): each model rank routes its own sequence
    slice of the batch shard, and two ``all_to_all`` exchanges over
    ``"model"`` carry the dispatch buffers to the ranks that hold the
    experts and back (GShard EP); the output slices are all-gathered over
    ``"model"``. Decode (S = 1): every model rank dispatches the batch
    shard's tokens, runs its slice of the experts and combines against
    it, and the partial outputs are summed over ``"model"``. The aux loss
    is averaged over every mesh axis.

Routing: softmax router in float32, top-k per token (optionally
renormalized, Qwen3), capacity C = ceil(k * T / E * capacity_factor)
with token-priority dropping, plus the load-balance auxiliary loss; under
EP, T is a shard's tokens, so capacity and drops are per shard.
Positions inside an expert's buffer are assigned in token order by a
cumulative sum over the flattened (T*k, E) one-hot; slots past the
capacity drop. Dispatch is k scatter-adds into an (E, C, D) buffer, the
expert FFN runs on the stacked buffer (``moe_grouped_ffn``'s grouped-
matmul kernel under ``use_kernel``, the model's ``impl="flash_moe"``;
``einsum`` otherwise), and the combine gathers back in float32 weighted
by gate * keep. Shared experts (DeepSeekMoE) run densely beside them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core import shard_map as sm
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (batch_split, dense_init,
                                       gather_param, silu)


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> dict:
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.expert_d_ff
    p = {
        "w_router": dense_init(gen, (d, e), ("embed", "experts")),
        "w_gate": dense_init(gen, (e, d, f), ("experts", "embed", "ff")),
        "w_up": dense_init(gen, (e, d, f), ("experts", "embed", "ff")),
        "w_down": dense_init(gen, (e, f, d), ("experts", "ff", "embed"),
                             fan_in=f),
    }
    if mo.num_shared_experts:
        sf = mo.shared_d_ff or mo.expert_d_ff * mo.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (d, sf), ("embed", "ff")),
            "w_up": dense_init(gen, (d, sf), ("embed", "ff")),
            "w_down": dense_init(gen, (sf, d), ("ff", "embed"),
                                 fan_in=sf),
        }
    return p


# ---------------------------------------------------------------------------
# Routing + dispatch/combine (local token set)
# ---------------------------------------------------------------------------

def _route(params, x2d, mo: MoEConfig, norm_topk: bool):
    """x2d: (T, D) -> gates (T, k) fp32, idx (T, k), aux loss scalar."""
    logits = x2d.float() @ params["w_router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates, idx = torch.topk(probs, mo.top_k, dim=-1)           # (T, k)
    if norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch/GShard load-balance loss: E * sum_e f_e * p_e.
    e = mo.num_experts
    density = torch.bincount(idx.reshape(-1), minlength=e).float()
    density = density / density.sum().clamp_min(1.0)
    aux = e * torch.sum(density * probs.mean(dim=0))
    return gates, idx, aux


def _dispatch(x2d, gates, idx, capacity: int, num_experts: int):
    """Token-priority capacity dispatch.

    Returns xb (E, C, D), and per-slot (flat position, keep) used by
    combine. Positions are assigned in token order; overflow tokens drop.
    """
    t, k = idx.shape
    # The one-hot is kept expert-major, (E, T*k), so the cumulative sum
    # runs along contiguous rows: the same integers as the reference's
    # sum down the (T*k, E) columns. PyTorch's CUDA scan down 64 columns
    # of 98,304 took 38 ms a layer at DeepSeekMoE's serving prefill on an
    # H100, about half of the prefill.
    flat = F.one_hot(idx.reshape(1, t * k), num_experts)[0].t().contiguous()
    pos_flat = torch.cumsum(flat, dim=1) - flat                 # (E, T*k)
    pos = torch.gather(pos_flat, 0, idx.reshape(1, t * k)).reshape(t, k)
    keep = pos < capacity
    slot = idx * capacity + torch.where(keep, pos, 0)           # (T, k)
    xb = x2d.new_zeros((num_experts * capacity, x2d.shape[-1]))
    for j in range(k):   # k is small — k scatter-adds of (T, D)
        contrib = torch.where(keep[:, j, None], x2d, 0)
        xb.index_add_(0, slot[:, j], contrib)
    return xb.reshape(num_experts, capacity, -1), slot, keep


def _combine(yb, slot, keep, gates, out_dtype):
    """Gather expert outputs back to tokens with gate weighting."""
    t, k = slot.shape
    y2d = yb.reshape(-1, yb.shape[-1])
    out = torch.zeros((t, yb.shape[-1]), dtype=torch.float32,
                      device=yb.device)
    for j in range(k):
        rows = y2d[slot[:, j]].float()
        out = out + rows * (gates[:, j] * keep[:, j])[:, None]
    return out.to(out_dtype)


def _expert_ffn(params, xb, use_kernel: bool = False):
    """xb: (E, C, D): grouped matmuls over stacked expert weights."""
    if use_kernel:
        return moe_gmm.moe_grouped_ffn(xb, params["w_gate"], params["w_up"],
                                       params["w_down"])
    return kref.moe_grouped_ffn_ref(xb, params["w_gate"], params["w_up"],
                                    params["w_down"])


def _capacity(tokens: int, mo: MoEConfig) -> int:
    c = int(-(-mo.top_k * tokens * mo.capacity_factor // mo.num_experts))
    return max(c, 1)


# ---------------------------------------------------------------------------
# Public layer
# ---------------------------------------------------------------------------

def _single(params, x, cfg: ArchConfig, use_kernel: bool = False):
    """The routed experts on one device: (y, aux)."""
    mo = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, idx, aux = _route(params, x2d, mo, mo.norm_topk)
    cap = _capacity(b * s, mo)
    xb, slot, keep = _dispatch(x2d, gates, idx, cap, mo.num_experts)
    yb = _expert_ffn(params, xb, use_kernel)
    return _combine(yb, slot, keep, gates, x.dtype).reshape(b, s, d), aux


def moe_layer(params, x, cfg: ArchConfig, *, mesh=None,
              use_kernel: bool = False):
    """x: (B, S, D) -> (y, aux_loss). Under ``mesh`` (which must have a
    ``"model"`` axis) the EP path: ``x`` is the rank's batch shard, the
    parameters DTensors placed by the rules (or whole tensors every rank
    holds), and ``y`` the rank's batch shard; otherwise single-device
    math."""
    mo = cfg.moe
    b, s, d = x.shape
    if mesh is not None:
        if "model" not in sm.axis_names(mesh):
            raise ValueError("the expert-parallel MoE needs a 'model' axis; "
                             f"the mesh has {sm.axis_names(mesh)}")
        y, aux = _moe_ep(params, x, cfg, mesh, mo.norm_topk, use_kernel)
    else:
        y, aux = _single(params, x, cfg, use_kernel)
    if mo.num_shared_experts:
        sp = {k: gather_param(v, mesh) if mesh is not None else v
              for k, v in ((k, params["shared"][k])
                           for k in ("w_gate", "w_up", "w_down"))}
        gate = torch.einsum("bsd,df->bsf", x, sp["w_gate"])
        up = torch.einsum("bsd,df->bsf", x, sp["w_up"])
        y = y + torch.einsum("bsf,fd->bsd", silu(gate) * up, sp["w_down"])
    return y, aux


def per_shard_layer(dp: int, tp: int):
    """A drop-in ``moe_layer`` for one device with the EP path's
    per-shard semantics on a mesh of ``dp`` batch shards and ``tp`` model
    ranks: each batch shard (and, where S divides over tp, each sequence
    slice of it) routed with its own capacity, the aux loss the mean of
    the shards' (the reference's ``pmean``). The oracle the sharded layer
    is held to; drops and all."""
    def layer(params, x, cfg: ArchConfig, *, mesh=None,
              use_kernel: bool = False):
        routed = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_shared_experts=0))
        b, s, _ = x.shape
        rows, auxes = [], []
        for xs in x.split(b // dp, 0):
            if s % tp == 0:
                parts = [_single(params, xm, routed, use_kernel)
                         for xm in xs.split(s // tp, 1)]
                rows.append(torch.cat([p[0] for p in parts], 1))
                auxes += [p[1] for p in parts]
            else:
                y, a = _single(params, xs, routed, use_kernel)
                rows.append(y)
                auxes += [a] * tp
        y = torch.cat(rows, 0)
        if cfg.moe.num_shared_experts:
            sp = params["shared"]
            gate = torch.einsum("bsd,df->bsf", x, sp["w_gate"])
            up = torch.einsum("bsd,df->bsf", x, sp["w_up"])
            y = y + torch.einsum("bsf,fd->bsd", silu(gate) * up,
                                 sp["w_down"])
        return y, torch.stack(auxes).mean()
    return layer


def _local_experts(w, mesh):
    """The rank's experts of a stacked expert weight, whole in D and F:
    a DTensor gathered over every axis but ``"model"``, or the rank's
    slice of a tensor every rank holds whole."""
    if isinstance(w, sm.DTensor):
        return gather_param(w, mesh, keep=("model",))
    return sm.local_shard(w, ("model",), mesh)


def _to_experts(xb, mesh, tp: int):
    """(E, C, D) -> (E/tp, tp*C, D): each rank receives, from every peer
    in rank order, the slots bound for its own experts (the reference's
    tiled ``all_to_all(split_axis=0, concat_axis=1)``)."""
    e, c, d = xb.shape
    got = sm.all_to_all(xb.reshape(tp, e // tp, c, d), mesh, "model")
    return got.transpose(0, 1).reshape(e // tp, tp * c, d)


def _from_experts(yb, mesh, tp: int):
    """The inverse of ``_to_experts``: (E/tp, tp*C, D) -> (E, C, D) in
    the layout the rank dispatched, so the combine's slots index it."""
    el, tc, d = yb.shape
    send = yb.reshape(el, tp, tc // tp, d).transpose(0, 1).contiguous()
    return sm.all_to_all(send, mesh, "model").reshape(el * tp, tc // tp, d)


def _moe_ep(params, x, cfg: ArchConfig, mesh, norm_topk: bool,
            use_kernel: bool):
    """Expert parallelism over the 'model' axis (the reference's
    ``_moe_ep``, ``src/repro/models/moe.py:153``).

    Train/prefill (S divisible by tp): tokens sharded batch x sequence,
    dispatch buffers exchanged with two all_to_alls (GShard EP).
    Decode (S=1): dispatch is computed per data-shard, each model rank runs
    its expert slice, partial combines are summed over 'model' -- no
    all_to_all on a 1-token sequence.
    """
    mo = cfg.moe
    tp = sm.axis_size(mesh, "model")
    if mo.num_experts % tp:
        raise ValueError(f"{mo.num_experts} experts over {tp} model ranks")
    split = batch_split(mesh)
    if "model" in split:
        raise ValueError("the MoE's expert-parallel path splits tokens over "
                         "'model' itself; a batch already split over "
                         "'model' is not supported (ROADMAP C.6)")
    b, s, d = x.shape
    # Each model rank routes other tokens: the router's gradient is the
    # sum of the ranks' parts.
    wr = gather_param(params["w_router"], mesh, model="sum")
    experts = {k: _local_experts(params[k], mesh)
               for k in ("w_gate", "w_up", "w_down")}

    if s % tp == 0:
        x_loc = sm.split(x, 1, mesh, "model")
        bl, sl = b, s // tp
        x2d = x_loc.reshape(bl * sl, d)
        gates, idx, aux = _route({"w_router": wr}, x2d, mo, norm_topk)
        cap = _capacity(bl * sl, mo)
        xb, slot, keep = _dispatch(x2d, gates, idx, cap, mo.num_experts)
        yb = _expert_ffn(experts, _to_experts(xb, mesh, tp), use_kernel)
        yb = _from_experts(yb, mesh, tp)
        y = _combine(yb, slot, keep, gates, x.dtype).reshape(bl, sl, d)
        y = sm.gather(y, 1, mesh, "model")
    else:
        x2d = sm.copy_in(x, mesh, "model").reshape(b * s, d)
        gates, idx, aux = _route({"w_router": wr}, x2d, mo, norm_topk)
        cap = _capacity(b * s, mo)
        xb, slot, keep = _dispatch(x2d, gates, idx, cap, mo.num_experts)
        e_local = mo.num_experts // tp
        rank = sm.axis_index(mesh, "model")
        yb_loc = _expert_ffn(experts,
                             xb[rank * e_local:(rank + 1) * e_local],
                             use_kernel)
        # Partial combine against the local expert slice only, then
        # reduce partial token outputs across the model axis.
        lo, hi = rank * e_local * cap, (rank + 1) * e_local * cap
        in_range = (slot >= lo) & (slot < hi)
        y = _combine(yb_loc, torch.where(in_range, slot - lo, 0),
                     keep & in_range, gates, torch.float32)
        y = sm.reduce_out(y, mesh, ("model",)).to(x.dtype).reshape(b, s, d)
    # The mean of the distinct shards' terms: ranks that hold the same
    # rows add theirs once.
    same = tuple(a for a in sm.dp_axes(mesh) if a not in split)
    axes = tuple(a for a in sm.axis_names(mesh) if a not in same)
    shards = sm.mesh_size(mesh)
    for a in same:
        shards //= sm.axis_size(mesh, a)
    aux = sm.reduce_out(aux, mesh, axes) / shards
    return y, aux
