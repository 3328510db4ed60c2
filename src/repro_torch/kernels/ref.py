"""Plain PyTorch oracles for the model kernels (the port of
``repro.kernels.ref``).

Each is written independently of its kernel (a full score matrix, not
tiles; a step loop, not lanes; an ``einsum``, not tiles of a product),
so agreement between the two means something.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None):
    """q: (B, Sq, H, D); k: (B, Skv, Hkv, D), v: (B, Skv, Hkv, Dv) -> (B,
    Sq, H, Dv); ``scale`` multiplies the scores (1/sqrt(D) by default)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kk = k.repeat_interleave(g, dim=2)                 # (B, Skv, H, D)
    vv = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
    logits = logits / math.sqrt(d) if scale is None else logits * scale
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
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MoE grouped matmul oracle
# ---------------------------------------------------------------------------

def gmm_ref(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) per-expert matmul."""
    return torch.einsum("ecd,edf->ecf", x, w)


def moe_grouped_ffn_ref(x, w_gate, w_up, w_down):
    gate = gmm_ref(x, w_gate)
    up = gmm_ref(x, w_up)
    h = gate * torch.sigmoid(gate) * up
    return gmm_ref(h, w_down)


# ---------------------------------------------------------------------------
# RWKV-6 WKV oracles
# ---------------------------------------------------------------------------

def rwkv6_step_ref(r, k, v, log_w, u, s0):
    """Fully sequential single-step oracle (ground truth for both the
    chunked reference and the kernel). r/k/v/log_w: (B, S, H, K);
    u: (H, K); s0: (B, H, K, V) fp32. Returns (o (B, S, H, V) in r's
    dtype, s_final (B, H, K, V) fp32)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(log_w.float())
    uf = u.float()[None, :, :, None]
    s = s0.float()
    out = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        out.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = s * wf[:, t, ..., None] + kv
    o = torch.stack(out, dim=1) if out else vf.new_zeros(vf.shape)
    return o.to(r.dtype), s


def rwkv6_chunked_ref(r, k, v, log_w, u, s0, *, chunk: int = 64):
    """Chunked evaluation with exact pairwise intra-chunk decays.

    Within a chunk: o_t = r_t S_{t-1} + sum_{i<t} (r_t . k_i decayed) v_i
    + (r_t . u . k_t) v_t; the pairwise decay tensor exp(excl_t - incl_i)
    is exact (no q'/k' factorization), so any decay magnitude is safe.
    The sequence is zero-padded to a whole number of chunks."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        zpad = lambda a: torch.nn.functional.pad(  # noqa: E731
            a, (0, 0, 0, 0, 0, pad))
        r, k, v, log_w = zpad(r), zpad(k), zpad(v), zpad(log_w)
    nc = r.shape[1] // chunk
    rc = r.reshape(b, nc, chunk, h, kd).float()
    kc = k.reshape(b, nc, chunk, h, kd).float()
    vc = v.reshape(b, nc, chunk, h, vd).float()
    lw = log_w.reshape(b, nc, chunk, h, kd).float()
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)
    state = s0.float()
    outs = []
    for c in range(nc):
        r_c, k_c, v_c, lw_c = rc[:, c], kc[:, c], vc[:, c], lw[:, c]
        incl = torch.cumsum(lw_c, dim=1)            # log prod_{j<=t}
        excl = incl - lw_c                          # log prod_{j<t}
        total = incl[:, -1]                         # (B, H, K)
        # inter-chunk: r decayed by everything before t inside the chunk
        o_inter = torch.einsum("bchk,bhkv->bchv", r_c * torch.exp(excl),
                               state)
        # intra-chunk, exact pairwise decay exp(excl_t - incl_i), i < t
        decay = torch.exp(excl[:, :, None] - incl[:, None, :])  # (B,C,C,H,K)
        scores = torch.einsum("bthk,bihk,btihk->bthi", r_c, k_c, decay)
        scores = torch.where(tri[None, :, None, :], scores, 0.0)
        o_intra = torch.einsum("bthi,bihv->bthv", scores, v_c)
        # bonus diagonal
        coef = torch.einsum("bchk,hk,bchk->bch", r_c, uf, k_c)
        o_self = coef[..., None] * v_c
        # state to next chunk
        k_dec = k_c * torch.exp(total[:, None] - incl)
        state = state * torch.exp(total)[..., None] \
            + torch.einsum("bchk,bchv->bhkv", k_dec, v_c)
        outs.append(o_inter + o_intra + o_self)
    o = torch.stack(outs, dim=1).reshape(b, nc * chunk, h, vd)[:, :s] \
        if outs else vc.new_zeros((b, 0, h, vd))
    return o.to(r.dtype), state


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
