"""A second forward of the decoder models, written apart from
``chipbench/references/decoder.py`` to check it: NumPy in float64, one
token at a time. Attention is a loop over each query's keys; the MoE
capacity is a counter of slots per expert, filled token by token in the
order the engine lays tokens out (batch row, then position), each token's
choices in rank order. It shares nothing with the reference but the
weights' names."""
from __future__ import annotations

import math

import numpy as np


def _rms(x, w, eps):
    return x / math.sqrt(float(np.mean(x * x)) + eps) * w


def _rotate(v, pos, theta):
    """Rotary embedding of one head's vector ``v`` at position ``pos``:
    element i pairs with element i + Dh/2."""
    half = v.shape[0] // 2
    out = np.empty_like(v)
    for i in range(half):
        ang = pos / theta ** (2 * i / v.shape[0])
        c, s = math.cos(ang), math.sin(ang)
        out[i] = v[i] * c - v[i + half] * s
        out[i + half] = v[i] * s + v[i + half] * c
    return out


def _silu(z):
    return z / (1.0 + np.exp(-z))


def _swiglu(x, gate, up, down):
    return (_silu(x @ gate) * (x @ up)) @ down


def _moe_call(w, xs, mo):
    """The routed and shared experts over the tokens ``xs`` of one call,
    a list in the engine's order. Returns (outputs, dropped)."""
    e, k, cf = mo["num_experts"], mo["top_k"], mo["capacity_factor"]
    slots = max(math.ceil(k * len(xs) * cf / e), 1)
    used = [0] * e
    dropped = 0
    outs = []
    for x in xs:
        logits = x @ w["ffn.w_router"]
        p = np.exp(logits - logits.max())
        p /= p.sum()
        choice = sorted(range(e), key=lambda j: -p[j])[:k]
        gates = [p[j] for j in choice]
        if mo.get("norm_topk"):
            total = sum(gates)
            gates = [g / total for g in gates]
        y = np.zeros_like(x)
        for j, g in zip(choice, gates):
            if used[j] >= slots:
                dropped += 1
                continue
            used[j] += 1
            y += g * _swiglu(x, w["ffn.w_gate"][j], w["ffn.w_up"][j],
                             w["ffn.w_down"][j])
        if mo.get("num_shared_experts"):
            y += _swiglu(x, w["ffn.shared.w_gate"], w["ffn.shared.w_up"],
                         w["ffn.shared.w_down"])
        outs.append(y)
    return outs, dropped


def forward(a: dict, weights: dict, tokens: np.ndarray,
            decode_tokens: np.ndarray):
    """``weights``: {group: {name: float64 array}}; ``tokens`` (B, S),
    ``decode_tokens`` (B, T). Returns (prefill logits (B, V) at the last
    position, decode logits (B, T, V), routed assignments dropped in the
    prefill and in the decode steps)."""
    b, s = tokens.shape
    t = decode_tokens.shape[1]
    h, hkv, dh = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    eps, theta = a["norm_eps"], a["rope_theta"]
    mo = a.get("moe")
    top = weights["top"]
    # x[r][p]: row r's hidden state at position p, prompt then decode.
    x = [[top["embed"][tok]
          for tok in list(tokens[r]) + list(decode_tokens[r])]
         for r in range(b)]
    dropped = [0, 0]
    for i in range(a["num_layers"]):
        w = weights[f"layers.{i}"]
        for r in range(b):
            hs = [_rms(v, w["ln1"], eps) for v in x[r]]
            q = [[_rotate(v @ w["attn.wq"][:, j], p, theta)
                  for j in range(h)] for p, v in enumerate(hs)]
            k = [[_rotate(v @ w["attn.wk"][:, j], p, theta)
                  for j in range(hkv)] for p, v in enumerate(hs)]
            v_ = [[v @ w["attn.wv"][:, j] for j in range(hkv)] for v in hs]
            for p in range(s + t):
                acc = np.zeros(x[r][p].shape)
                for j in range(h):
                    g = j // (h // hkv)
                    scores = [q[p][j] @ k[p2][g] / math.sqrt(dh)
                              for p2 in range(p + 1)]
                    m = max(scores)
                    ex = [math.exp(sc - m) for sc in scores]
                    o = sum(e_ * v_[p2][g]
                            for p2, e_ in enumerate(ex)) / sum(ex)
                    acc += o @ w["attn.wo"][j]
                x[r][p] = x[r][p] + acc
        h2 = [[_rms(v, w["ln2"], eps) for v in row] for row in x]
        moe_layer = mo is not None and i >= mo["first_k_dense"]
        if not moe_layer:
            for r in range(b):
                for p in range(s + t):
                    x[r][p] = x[r][p] + _swiglu(
                        h2[r][p], w["ffn.w_gate"], w["ffn.w_up"],
                        w["ffn.w_down"])
            continue
        # The prefill routes all B x S prompt tokens in one call; each
        # decode step routes the batch's one token each.
        calls = [[(r, p) for r in range(b) for p in range(s)]]
        calls += [[(r, s + j) for r in range(b)] for j in range(t)]
        for call in calls:
            ys, drop = _moe_call(w, [h2[r][p] for r, p in call], mo)
            dropped[call is not calls[0]] += drop
            for (r, p), y in zip(call, ys):
                x[r][p] = x[r][p] + y

    def head(v):
        return _rms(v, top["ln_f"], eps) @ top["lm_head"]
    prefill = np.stack([head(x[r][s - 1]) for r in range(b)])
    decode = np.stack([np.stack([head(x[r][s + j]) for j in range(t)])
                       for r in range(b)]).reshape(b, t, -1)
    return prefill, decode, tuple(dropped)
