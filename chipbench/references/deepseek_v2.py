"""Plain float32 reference of DeepSeek-V2's decoder: multi-head latent
attention (arXiv:2405.04434 section 2.1) with YaRN rotary, on DeepSeekMoE's
capacity-routed mixture of experts; and its model-FLOP count.

Attention is computed decompressed, as the paper writes it, for the prompt
and for every decode step alike: per head the query ``x wq`` split into
``qk_nope_head_dim`` dims and ``qk_rope_head_dim`` rotated ones; the
latent ``[c, k_pe] = x w_kv_a``, ``c`` RMS-normed, ``k_pe`` rotated and
shared by every head; ``[k_nope, v] = c w_kv_b`` per head; softmax over
``[q_nope, q_pe] . [k_nope, k_pe]`` times ``(dn + dr)^-1/2 mscale^2``;
``wo`` over the heads' values. The rotary turns adjacent pairs of dims
(2i, 2i + 1), the layout of the published weights, at YaRN's frequencies
(``original_max_position_embeddings`` and the ramp between ``beta_fast``
and ``beta_slow`` turns, ``factor``, and ``mscale`` over
``mscale_all_dim`` on cos and sin). The program's decode attends over a
latent cache with ``w_kv_b`` absorbed into its query and output; this
file never does, so the two are held against each other.

The feed-forward layers and what the serving engine does around the model
(prompts padded on the right, the first token from the last slot, decode
steps at the positions after the slot width, the MoE capacity worked out
over all the tokens of one call) are ``decoder.py``'s: its SwiGLU,
RMSNorm, float8 rounding and MoE are copied here unchanged (a reference
imports only ``torch`` and ``math``), and a CPU test holds the copies equal
to its functions.

Weights come from the benchmark (``weights_of``), never from the program.
Every matrix product runs in float32 with TF32 off. ``precision="fp8"`` is
the control: every operand of every product rounded to float8 e4m3 with
one scale a tensor, the step below the bfloat16 the configurations state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Query rows of one attention block, and token rows of one feed-forward
# block: they bound the reference's working set on the card.
ATTN_ROWS = 1024
FFN_ROWS = 16384


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def layer_kinds(a: dict) -> list[str]:
    """"dense" (a leading dense layer, SwiGLU of ``moe.dense_d_ff``) or
    "moe" per layer."""
    if tuple(a.get("block_pattern", ())) != ("moe",) or not a.get("moe"):
        raise ValueError("the DeepSeek-V2 reference runs moe blocks")
    first = a["moe"]["first_k_dense"]
    return ["dense" if i < first else "moe" for i in range(a["num_layers"])]


def _swiglu_specs(prefix: str, d: int, ff: int) -> list:
    return [(f"{prefix}.w_gate", (d, ff), "dense", d),
            (f"{prefix}.w_up", (d, ff), "dense", d),
            (f"{prefix}.w_down", (ff, d), "dense", ff)]


def weight_groups(a: dict) -> list[tuple[str, list]]:
    """[(group, [(name, shape, init, fan_in)])]: ``"top"``, then
    ``"layers.<i>"`` in layer order, as ``decoder.weight_groups`` gives
    them; attention's weights are MLA's: ``wq`` (D, H, dn + dr), ``w_kv_a``
    (D, r + dr), ``kv_norm`` (r,), ``w_kv_b`` (r, H, dn + dv), ``wo`` (H,
    dv, D)."""
    d, h = a["d_model"], a["num_heads"]
    r, dn, dr, dv = a["kv_lora_rank"], a["qk_nope_head_dim"], \
        a["qk_rope_head_dim"], a["v_head_dim"]
    if a.get("tie_embeddings") or a.get("qkv_bias") or a.get("window"):
        raise ValueError("the DeepSeek-V2 reference has no tied embeddings, "
                         "QKV bias or window")
    top = [("embed", (a["vocab_size"], d), "embed", None),
           ("ln_f", (d,), "norm", None),
           ("lm_head", (d, a["vocab_size"]), "embed", None)]
    groups = [("top", top)]
    for i, kind in enumerate(layer_kinds(a)):
        p = [("ln1", (d,), "norm", None),
             ("attn.wq", (d, h, dn + dr), "dense", d),
             ("attn.w_kv_a", (d, r + dr), "dense", d),
             ("attn.kv_norm", (r,), "norm", None),
             ("attn.w_kv_b", (r, h, dn + dv), "dense", r),
             ("attn.wo", (h, dv, d), "dense", h * dv),
             ("ln2", (d,), "norm", None)]
        mo = a["moe"]
        if kind == "dense":
            p += _swiglu_specs("ffn", d, mo["dense_d_ff"])
        else:
            e, f = mo["num_experts"], mo["expert_d_ff"]
            p += [("ffn.w_router", (d, e), "dense", d),
                  ("ffn.w_gate", (e, d, f), "dense", d),
                  ("ffn.w_up", (e, d, f), "dense", d),
                  ("ffn.w_down", (e, f, d), "dense", f)]
            if mo.get("num_shared_experts"):
                sf = mo.get("shared_d_ff") or f * mo["num_shared_experts"]
                p += _swiglu_specs("ffn.shared", d, sf)
        groups.append((f"layers.{i}", p))
    return groups


# ---------------------------------------------------------------------------
# Model FLOPs
# ---------------------------------------------------------------------------

def matmul_flops_per_token(a: dict) -> int:
    """2 x the parameters of the layers' matrix products that one token
    activates: MLA's four projections (``w_kv_b`` decompressing every
    token, as a prefill does), and the SwiGLU, or the router, top-k routed
    experts and shared experts (the embedding lookup and the LM head
    excluded)."""
    d, h = a["d_model"], a["num_heads"]
    r, dn, dr, dv = a["kv_lora_rank"], a["qk_nope_head_dim"], \
        a["qk_rope_head_dim"], a["v_head_dim"]
    attn = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    mo = a["moe"]
    total = 0
    for kind in layer_kinds(a):
        if kind == "dense":
            ffn = 3 * d * mo["dense_d_ff"]
        else:
            sf = mo.get("shared_d_ff") or \
                mo["expert_d_ff"] * mo.get("num_shared_experts", 0)
            ffn = d * mo["num_experts"] + 3 * d * (
                mo["top_k"] * mo["expert_d_ff"] + sf)
        total += attn + ffn
    return 2 * total


def attention_flops(a: dict, seq: int) -> int:
    """QK^T at dn + dr and PV at dv over the causal band of one sequence,
    all layers."""
    dqk = a["qk_nope_head_dim"] + a["qk_rope_head_dim"]
    return 2 * a["num_layers"] * a["num_heads"] * (dqk + a["v_head_dim"]) \
        * seq * (seq + 1) // 2


def prompt_flops(a: dict, prompt_len: int) -> int:
    """Model FLOPs of one prompt's prefill: its tokens' matrix products,
    its causal band, and the LM head at its last token."""
    return matmul_flops_per_token(a) * prompt_len \
        + attention_flops(a, prompt_len) + 2 * a["d_model"] * a["vocab_size"]


# ---------------------------------------------------------------------------
# Rotary: YaRN over adjacent pairs
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def inv_freq(a: dict, device=None) -> torch.Tensor:
    """(dr/2,) inverse frequencies: extrapolated (theta^-2i/dr) for the
    fast pairs, interpolated (divided by ``rope_factor``) for the slow
    ones, a linear ramp between the pair indices at which ``beta_fast``
    and ``beta_slow`` turns fit in ``rope_original_max`` positions."""
    dim, theta = a["qk_rope_head_dim"], a["rope_theta"]
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    extra = 1.0 / base
    if a.get("rope_scaling", "none") != "yarn":
        return extra
    factor, n = a["rope_factor"], a["rope_original_max"]

    def at(turns):
        return dim * math.log(n / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(at(a["yarn_beta_fast"])), 0)
    high = min(math.ceil(at(a["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    inter = 1.0 / (factor * base)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(a: dict) -> float:
    scale = (a["qk_nope_head_dim"] + a["qk_rope_head_dim"]) ** -0.5
    if a.get("rope_scaling", "none") == "yarn" and \
            a.get("yarn_mscale_all_dim"):
        scale *= yarn_mscale(a["rope_factor"], a["yarn_mscale_all_dim"]) ** 2
    return scale


def _rope_pairs(x, pos, a: dict):
    """Rotate dims (2i, 2i + 1) of x (B, S, H, dr) by pos * inv_freq[i],
    cos and sin times mscale / mscale_all_dim."""
    ang = pos.float()[:, None] * inv_freq(a, x.device)       # (S, dr/2)
    m = 1.0
    if a.get("rope_scaling", "none") == "yarn":
        m = yarn_mscale(a["rope_factor"], a["yarn_mscale"]) / \
            yarn_mscale(a["rope_factor"], a["yarn_mscale_all_dim"])
    cos, sin = (torch.cos(ang) * m)[:, None], (torch.sin(ang) * m)[:, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                       -1).flatten(-2)


# ---------------------------------------------------------------------------
# decoder.py's feed-forward helpers, copied unchanged
# ---------------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale (its largest magnitude
    at e4m3's 448), back in float32."""
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _mm(x, w, q):
    return q(x) @ q(w)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _swiglu(w, prefix, x, q):
    """SwiGLU over the rows of ``x`` (..., D), in blocks of rows."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat)
    for s0 in range(0, flat.shape[0], FFN_ROWS):
        xs = flat[s0:s0 + FFN_ROWS]
        g = _mm(xs, w[f"{prefix}.w_gate"], q)
        u = _mm(xs, w[f"{prefix}.w_up"], q)
        out[s0:s0 + FFN_ROWS] = _mm(F.silu(g) * u, w[f"{prefix}.w_down"], q)
    return out.reshape(x.shape)


def capacity(mo: dict, tokens: int) -> int:
    """Slots an expert keeps for ``tokens`` routed together: ceil(k T cf /
    E), at least 1."""
    k, cf, e = mo["top_k"], mo.get("capacity_factor", 1.25), \
        mo["num_experts"]
    return max(int(-((-k * tokens * cf) // e)), 1)


def _moe(w, x, mo: dict, q):
    """Routed experts over the tokens of one call, x: (T, D): float32
    softmax router, top-k, capacity in token order (a token's k choices
    in rank order), each expert's kept tokens through its SwiGLU, summed
    weighted by their gates; plus the shared experts. Returns (out,
    dropped assignments)."""
    t = x.shape[0]
    e, k = mo["num_experts"], mo["top_k"]
    probs = torch.softmax(_mm(x, w["ffn.w_router"], q), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if mo.get("norm_topk"):
        gates = gates / gates.sum(-1, keepdim=True)
    flat = idx.reshape(-1)                                # token-major
    onehot = F.one_hot(flat, e)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = before < capacity(mo, t)
    out = torch.zeros_like(x)
    for j in range(e):
        sel = torch.nonzero((flat == j) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        tok = sel // k
        xe = x[tok]
        g = _mm(xe, w["ffn.w_gate"][j], q)
        u = _mm(xe, w["ffn.w_up"][j], q)
        ye = _mm(F.silu(g) * u, w["ffn.w_down"][j], q)
        out.index_add_(0, tok, ye * gates.reshape(-1)[sel, None])
    if mo.get("num_shared_experts"):
        out = out + _swiglu(w, "ffn.shared", x, q)
    return out, int((~keep).sum())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attend(qn, qr, kn, kr, v, scale, qz):
    """Causal softmax attention of every position over those at or before
    it, per row and in blocks of query rows, each block over the keys it
    can see. qn, kn: (B, S, H, dn); qr: (B, S, H, dr); kr: (B, S, dr),
    every head's; v: (B, S, H, dv) -> (B, S, H, dv)."""
    b, s, h, _ = qn.shape
    out = qn.new_empty((b, s, h, v.shape[-1]))
    pos = torch.arange(s, device=qn.device)
    for r in range(b):
        kn_r = qz(kn[r].transpose(0, 1))                      # (H, S, dn)
        kr_r = qz(kr[r])                                      # (S, dr)
        v_r = qz(v[r].transpose(0, 1))                        # (H, S, dv)
        for s0 in range(0, s, ATTN_ROWS):
            s1 = min(s0 + ATTN_ROWS, s)
            qn_b = qz(qn[r, s0:s1].transpose(0, 1))           # (H, R, dn)
            qr_b = qz(qr[r, s0:s1].transpose(0, 1))
            scores = (qn_b @ kn_r[:, :s1].transpose(1, 2)
                      + qr_b @ kr_r[:s1].T) * scale           # (H, R, s1)
            seen = pos[None, :s1] <= pos[s0:s1, None]
            scores = scores.masked_fill(~seen, float("-inf"))
            p = torch.softmax(scores, dim=-1)
            out[r, s0:s1] = (qz(p) @ v_r[:, :s1]).transpose(0, 1)
    return out


def _mla(a, w, h, pos, q):
    """Decompressed multi-head latent attention over the rows h (B, S, D)."""
    dn, dr = a["qk_nope_head_dim"], a["qk_rope_head_dim"]
    r, dv = a["kv_lora_rank"], a["v_head_dim"]
    eps = a.get("norm_eps", 1e-6)
    qh = torch.einsum("bsd,dhk->bshk", q(h), q(w["attn.wq"]))
    qn, qr = qh[..., :dn], _rope_pairs(qh[..., dn:], pos, a)
    del qh
    kv = _mm(h, w["attn.w_kv_a"], q)
    c = _rms(kv[..., :r], w["attn.kv_norm"], eps)
    kr = _rope_pairs(kv[..., None, r:], pos, a)[:, :, 0]
    del kv
    kvb = torch.einsum("bsc,chk->bshk", q(c), q(w["attn.w_kv_b"]))
    kn, v = kvb[..., :dn], kvb[..., dn:dn + dv]
    att = _attend(qn, qr, kn, kr, v, softmax_scale(a), q)
    del qn, qr, kn, kr, v, kvb
    return torch.einsum("bshk,hkd->bsd", q(att), q(w["attn.wo"]))


def _layer(a, kind, w, x, y, q, stats):
    """One layer over the prompt rows x (B, S, D) and the decode tokens y
    (B, T, D), which attend to the prompt and to each other."""
    eps = a.get("norm_eps", 1e-6)
    s, t = x.shape[1], y.shape[1]
    pos = torch.arange(s + t, device=x.device)
    both = torch.cat([x, y], 1)
    both = both + _mla(a, w, _rms(both, w["ln1"], eps), pos, q)
    h2 = _rms(both, w["ln2"], eps)
    if kind != "moe":
        both = both + _swiglu(w, "ffn", h2, q)
    else:
        b, _, d = both.shape
        mo = a["moe"]
        # The prefill routes the whole padded batch at once; each decode
        # step routes the batch's one token each.
        ff = torch.empty_like(h2)
        out, drop = _moe(w, h2[:, :s].reshape(b * s, d), mo, q)
        ff[:, :s] = out.reshape(b, s, d)
        stats["dropped"] += drop
        for j in range(t):
            ff[:, s + j], drop = _moe(w, h2[:, s + j], mo, q)
            stats["dropped_decode"] += drop
        both = both + ff
    return both[:, :s], both[:, s:]


def forward(a: dict, weights_of, tokens: torch.Tensor,
            decode_tokens: torch.Tensor, precision: str = "fp32"):
    """The engine's prefill of ``tokens`` (B, S), as padded, and its decode
    steps fed ``decode_tokens`` (B, T), layer by layer.

    ``weights_of(group)`` gives the benchmark's tensors of ``"top"`` or
    ``"layers.<i>"`` by name, in any dtype, on the device to run on.
    Returns (prefill logits (B, V), decode logits (B, T, V), stats): the
    last slot's logits, each decode step's, float32; ``stats`` counts the
    routed assignments dropped over capacity."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(precision)
    q = _fp8 if precision == "fp8" else (lambda t: t)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {"dropped": 0, "dropped_decode": 0}
    try:
        with torch.no_grad():
            top = {k: v.float() for k, v in weights_of("top").items()}
            x = top["embed"][tokens.long()]
            y = top["embed"][decode_tokens.long()]
            for i, kind in enumerate(layer_kinds(a)):
                w = {k: v.float() for k, v in
                     weights_of(f"layers.{i}").items()}
                x, y = _layer(a, kind, w, x, y, q, stats)
                del w
            eps = a.get("norm_eps", 1e-6)

            def head(z):
                return _mm(_rms(z, top["ln_f"], eps), top["lm_head"], q)
            return head(x[:, -1]), head(y), stats
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
