"""Plain float32 reference of the decoder models the benchmark serves, and
its model-FLOP count.

It follows the architecture as this repository defines it (a stack of
RMSNorm -> rotary multi-head attention -> RMSNorm -> SwiGLU blocks, or a
capacity-routed mixture of experts in place of the SwiGLU), not only the
published model; a configuration file lists where the two part. It also
reproduces what the serving engine does around the model, quirks
included: prompts padded on the right to the slot width with token 0, the
first served token read from the last slot's logits, every decode step at
the positions after the slot width, and the MoE capacity
``ceil(k * T * capacity_factor / E)`` worked out over all the tokens of
one call: the whole padded batch in the prefill, the batch's one token
each in a decode step, with tokens kept in token order.

It imports ``torch`` and ``math`` only: nothing of the program. Weights
come from the benchmark (``weights_of``), never from the program. Every
matrix product runs in float32 with TF32 off. ``precision="fp8"`` is the
control: every operand of every product rounded to float8 e4m3 with one
scale a tensor, the step below the bfloat16 the configurations state.
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
# Layout: the weights the benchmark draws, in the names the engine's model
# gives its parameters, with each one's initialisation.
# ---------------------------------------------------------------------------

def layer_kinds(a: dict) -> list[str]:
    """"attn" (attention + SwiGLU), "dense" (a leading dense layer of an
    MoE model, SwiGLU of ``moe.dense_d_ff``) or "moe" per layer."""
    pattern = tuple(a.get("block_pattern", ("attn",)))
    if pattern not in (("attn",), ("moe",)):
        raise ValueError(f"the decoder reference runs attn or moe blocks, "
                         f"not {pattern}")
    moe = a.get("moe")
    if pattern == ("attn",):
        return ["attn"] * a["num_layers"]
    return ["dense" if i < moe["first_k_dense"] else "moe"
            for i in range(a["num_layers"])]


def _swiglu_specs(prefix: str, d: int, ff: int) -> list:
    return [(f"{prefix}.w_gate", (d, ff), "dense", d),
            (f"{prefix}.w_up", (d, ff), "dense", d),
            (f"{prefix}.w_down", (ff, d), "dense", ff)]


def weight_groups(a: dict) -> list[tuple[str, list]]:
    """[(group, [(name, shape, init, fan_in)])]: ``"top"``, then
    ``"layers.<i>"`` in layer order. ``init`` is ``"embed"`` (0.02 N(0,
    1)), ``"dense"`` (N(0, 1) / sqrt(fan_in)) or ``"norm"`` (1 + 0.1 N(0,
    1)); ``group.name`` is the engine's parameter name."""
    d, h, hkv, dh = a["d_model"], a["num_heads"], a["num_kv_heads"], \
        a["head_dim"]
    if a.get("qkv_bias") or a.get("tie_embeddings") or a.get("window") \
            or a.get("rope", "rope") != "rope":
        raise ValueError("the decoder reference has no QKV bias, tied "
                         "embeddings, window or M-RoPE")
    top = [("embed", (a["vocab_size"], d), "embed", None),
           ("ln_f", (d,), "norm", None),
           ("lm_head", (d, a["vocab_size"]), "embed", None)]
    groups = [("top", top)]
    for i, kind in enumerate(layer_kinds(a)):
        p = [("ln1", (d,), "norm", None),
             ("attn.wq", (d, h, dh), "dense", d),
             ("attn.wk", (d, hkv, dh), "dense", d),
             ("attn.wv", (d, hkv, dh), "dense", d),
             ("attn.wo", (h, dh, d), "dense", h * dh),
             ("ln2", (d,), "norm", None)]
        if kind == "attn":
            p += _swiglu_specs("ffn", d, a["d_ff"])
        elif kind == "dense":
            p += _swiglu_specs("ffn", d, a["moe"]["dense_d_ff"])
        else:
            mo = a["moe"]
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
    activates: attention's four projections, and the SwiGLU, or the
    router, top-k routed experts and shared experts (the embedding lookup
    and the LM head excluded)."""
    d, h, hkv, dh = a["d_model"], a["num_heads"], a["num_kv_heads"], \
        a["head_dim"]
    attn = d * dh * (2 * h + 2 * hkv)
    total = 0
    for kind in layer_kinds(a):
        if kind == "attn":
            ffn = 3 * d * a["d_ff"]
        elif kind == "dense":
            ffn = 3 * d * a["moe"]["dense_d_ff"]
        else:
            mo = a["moe"]
            sf = mo.get("shared_d_ff") or \
                mo["expert_d_ff"] * mo.get("num_shared_experts", 0)
            ffn = d * mo["num_experts"] + 3 * d * (
                mo["top_k"] * mo["expert_d_ff"] + sf)
        total += attn + ffn
    return 2 * total


def attention_flops(a: dict, seq: int) -> int:
    """QK^T and PV over the causal band of one sequence, all layers."""
    return 4 * a["num_layers"] * a["num_heads"] * a["head_dim"] \
        * seq * (seq + 1) // 2


def prompt_flops(a: dict, prompt_len: int) -> int:
    """Model FLOPs of one prompt's prefill: its tokens' matrix products,
    its causal band, and the LM head at its last token."""
    return matmul_flops_per_token(a) * prompt_len \
        + attention_flops(a, prompt_len) + 2 * a["d_model"] * a["vocab_size"]


# ---------------------------------------------------------------------------
# Forward
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


def _rope(x, pos, theta):
    """Rotary embedding over the whole head dim, split halves. x: (B, S,
    H, Dh); pos: (S,) positions."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = pos.float()[:, None] * inv                     # (S, Dh/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attend(q, k, v, q_pos, qz):
    """Softmax attention of queries at ``q_pos`` over keys at positions 0,
    1, ... (each query sees the keys at or before its position), per row
    and in blocks of query rows. q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh)
    -> (B, Sq, H, Dh)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    out = torch.empty_like(q)
    k_pos = torch.arange(sk, device=q.device)
    for r in range(b):
        kr = qz(k[r].transpose(0, 1))                     # (H, Sk, Dh)
        vr = qz(v[r].transpose(0, 1))
        for s0 in range(0, sq, ATTN_ROWS):
            qr = qz(q[r, s0:s0 + ATTN_ROWS].transpose(0, 1))
            scores = qr @ kr.transpose(1, 2) / math.sqrt(dh)
            seen = k_pos[None, :] <= q_pos[s0:s0 + ATTN_ROWS, None]
            scores = scores.masked_fill(~seen, float("-inf"))
            p = torch.softmax(scores, dim=-1)
            out[r, s0:s0 + ATTN_ROWS] = (qz(p) @ vr).transpose(0, 1)
    return out


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


def _layer(a, kind, w, x, y, q, stats):
    """One layer over the prompt rows x (B, S, D) and the decode tokens y
    (B, T, D), which attend to the prompt and to each other."""
    eps, theta = a.get("norm_eps", 1e-6), a.get("rope_theta", 10000.0)
    s, t = x.shape[1], y.shape[1]
    pos = torch.arange(s + t, device=x.device)
    both = torch.cat([x, y], 1)
    h = _rms(both, w["ln1"], eps)
    qh = _rope(torch.einsum("bsd,dhk->bshk", q(h), q(w["attn.wq"])), pos,
               theta)
    kh = _rope(torch.einsum("bsd,dhk->bshk", q(h), q(w["attn.wk"])), pos,
               theta)
    vh = torch.einsum("bsd,dhk->bshk", q(h), q(w["attn.wv"]))
    del h
    att = _attend(qh, kh, vh, pos, q)
    del qh, kh, vh
    both = both + torch.einsum("bshk,hkd->bsd", q(att), q(w["attn.wo"]))
    del att
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
