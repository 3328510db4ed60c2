"""Fine-grained mixture-of-experts with capacity-based token-choice routing
(the port of ``repro.models.moe``, single-device path).

Routing: softmax router in float32, top-k per token (optionally
renormalized, Qwen3), capacity C = ceil(k * T / E * capacity_factor)
with token-priority dropping, plus the load-balance auxiliary loss.
Positions inside an expert's buffer are assigned in token order by a
cumulative sum over the flattened (T*k, E) one-hot; slots past the
capacity drop. Dispatch is k scatter-adds into an (E, C, D) buffer, the
expert FFN runs on the stacked buffer (``moe_grouped_ffn``'s grouped-
matmul kernel under ``use_kernel``, the model's ``impl="flash_moe"``;
``einsum`` otherwise), and the combine gathers back in float32 weighted
by gate * keep. Shared experts (DeepSeekMoE) run densely beside them.

The reference's expert-parallel path (``_moe_ep``, ``shard_map`` with
``all_to_all``) waits for the distribution slice (ROADMAP A.5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import ref as kref
from repro_torch.models.common import dense_init, silu


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> dict:
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.expert_d_ff
    p = {
        "w_router": dense_init(gen, (d, e)),
        "w_gate": dense_init(gen, (e, d, f)),
        "w_up": dense_init(gen, (e, d, f)),
        "w_down": dense_init(gen, (e, f, d), fan_in=f),
    }
    if mo.num_shared_experts:
        sf = mo.shared_d_ff or mo.expert_d_ff * mo.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (d, sf)),
            "w_up": dense_init(gen, (d, sf)),
            "w_down": dense_init(gen, (sf, d), fan_in=sf),
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

def moe_layer(params, x, cfg: ArchConfig, *, use_kernel: bool = False):
    """x: (B, S, D) -> (y, aux_loss)."""
    mo = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, idx, aux = _route(params, x2d, mo, mo.norm_topk)
    cap = _capacity(b * s, mo)
    xb, slot, keep = _dispatch(x2d, gates, idx, cap, mo.num_experts)
    yb = _expert_ffn(params, xb, use_kernel)
    y = _combine(yb, slot, keep, gates, x.dtype).reshape(b, s, d)
    if mo.num_shared_experts:
        sp = params["shared"]
        gate = torch.einsum("bsd,df->bsf", x, sp["w_gate"])
        up = torch.einsum("bsd,df->bsf", x, sp["w_up"])
        y = y + torch.einsum("bsf,fd->bsd", silu(gate) * up, sp["w_down"])
    return y, aux
