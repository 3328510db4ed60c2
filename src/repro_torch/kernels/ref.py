"""Plain PyTorch oracles for the model kernels (the port of the flash
attention and RG-LRU parts of ``repro.kernels.ref``).

Each is written independently of its kernel (a full score matrix, not
tiles; a step loop, not lanes), so agreement between the two means
something. The gmm and RWKV-6 oracles come with their kernels.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kk = k.repeat_interleave(g, dim=2)                 # (B, Skv, H, D)
    vv = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kk.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    # A row with no key in its band gives 0, as the kernel does (the
    # softmax alone would spread it evenly over every key).
    p.mul_(mask.any(dim=-1, keepdim=True))
    out =torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return out.to(q.dtype)


def rglru_scan_ref(log_a, b_in, h0):
    """Sequential h_t = exp(log_a_t) h_{t-1} + b_t.
    log_a, b_in: (B, S, W) fp32; h0: (B, W). Returns (h_all, h_last)."""
    la, bb = log_a.float(), b_in.float()
    h = h0.float()
    out = torch.empty_like(bb)
    for t in range(la.shape[1]):
        h = torch.exp(la[:, t]) * h + bb[:, t]
        out[:, t] = h
    return out, h
