"""The DeepSeek-V2 reference (``chipbench/references/deepseek_v2.py``) on
the CPU at a tiny size, the MLA widths shrunk here: against the port's
float32 model (its prefill, then decode steps through the latent cache,
on both attention routes), against a token-by-token NumPy forward in
float64 written apart from it, and against ``decoder.py``'s helpers it
copies; its FLOP counts and the new readers' bounds by hand."""
import math

import numpy as np
import pytest
import torch

from chipbench.harness import arch_config
from chipbench.manifest import load_cell, load_module, reader, HERE
from chipbench.tests import loop_decoder
from chipbench.traffic import Traffic
from chipbench.weights import Weights

CELL = "deepseek-v2-lite.score-32k"
# float32 on both sides, sums in other orders (and the port's decode
# absorbs w_kv_b where the reference decompresses): as the decoder's TOL.
TOL = 1e-4


def tiny_mla(dtype="float32", batch=3, prompt_len=12, new_tokens=3,
             requests=6):
    """The cell at a CPU size: every width and depth small, the MLA
    widths too (latent 32, 16 + 8 query/key dims, 16 value dims), YaRN's
    settings as published."""
    cell = load_cell(CELL)
    a = cell.config["arch"]
    a.update(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
             head_dim=24, vocab_size=256, dtype=dtype, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    a["moe"].update(num_experts=8, top_k=2, expert_d_ff=32,
                    num_shared_experts=1, shared_d_ff=64, dense_d_ff=128)
    cell.traffic.update(batch=batch, prompt_len=prompt_len,
                        new_tokens=new_tokens)
    cell.traffic["check"]["requests"] = requests
    return cell


def _port_logits(cfg, weights, tokens, decode_tokens, impl):
    from repro_torch.models import transformer as tfm
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    weights.load_into(model)
    s, steps = tokens.shape[1], decode_tokens.shape[1]
    logits, caches = tfm.forward_prefill(model, cfg, {"tokens": tokens},
                                         s + steps, impl=impl)
    out = [logits]
    for t in range(steps):
        logits, caches = tfm.forward_decode(
            model, cfg, decode_tokens[:, t:t + 1], caches, s + t)
        out.append(logits)
    return torch.stack(out, 1)


@pytest.mark.parametrize("impl", ["reference", "flash_moe"])
@pytest.mark.parametrize("lens, steps", [(12, 3), (16, 4)])
def test_port_prefill_and_latent_decode_match_the_reference(impl, lens,
                                                            steps):
    cell = tiny_mla(prompt_len=lens, new_tokens=steps)
    a = cell.config["arch"]
    ref = cell.reference()
    weights = Weights(ref.weight_groups(a), 2**33 + 7, torch.device("cpu"),
                      torch.float32)
    traffic = Traffic(cell.traffic, a["vocab_size"], 11)
    tokens = torch.as_tensor(traffic.prompts("window", 0))
    dec = torch.randint(0, a["vocab_size"], (traffic.batch, steps),
                        generator=torch.Generator().manual_seed(3))
    p, d, stats = ref.forward(a, weights, tokens, dec)
    want = torch.cat([p[:, None], d], 1)
    got = _port_logits(arch_config(a), weights, tokens, dec, impl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    # The capacity drops some assignments, as the port's does.
    assert stats["dropped"] > 0


# ---------------------------------------------------------------------------
# A token-by-token forward, NumPy float64
# ---------------------------------------------------------------------------

def _yarn_freqs(a):
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` inverse
    frequencies, in float64."""
    dim, base = a["qk_rope_head_dim"], a["rope_theta"]
    factor, orig = a["rope_factor"], a["rope_original_max"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(corr(a["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(a["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    out = []
    for i in range(dim // 2):
        extra = 1.0 / base ** (2 * i / dim)
        inter = extra / factor
        mask = 1.0 - min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(inter * (1 - mask) + extra * mask)
    return out


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _turn(v, pos, a):
    """Dims (2i, 2i + 1) of ``v`` turned by pos * freq_i, cos and sin
    times mscale / mscale_all_dim."""
    m = _mscale(a["rope_factor"], a["yarn_mscale"]) / \
        _mscale(a["rope_factor"], a["yarn_mscale_all_dim"])
    out = np.empty_like(v)
    for i, f in enumerate(_yarn_freqs(a)):
        c, s = m * math.cos(pos * f), m * math.sin(pos * f)
        out[2 * i] = v[2 * i] * c - v[2 * i + 1] * s
        out[2 * i + 1] = v[2 * i + 1] * c + v[2 * i] * s
    return out


def loop_forward(a, weights, tokens, decode_tokens):
    b, s = tokens.shape
    t = decode_tokens.shape[1]
    h, r = a["num_heads"], a["kv_lora_rank"]
    dn, dr = a["qk_nope_head_dim"], a["qk_rope_head_dim"]
    eps, mo = a["norm_eps"], a["moe"]
    scale = (dn + dr) ** -0.5 * _mscale(a["rope_factor"],
                                        a["yarn_mscale_all_dim"]) ** 2
    top = weights["top"]
    x = [[top["embed"][tok]
          for tok in list(tokens[i]) + list(decode_tokens[i])]
         for i in range(b)]
    dropped = [0, 0]
    for li in range(a["num_layers"]):
        w = weights[f"layers.{li}"]
        for row in range(b):
            hs = [loop_decoder._rms(v, w["ln1"], eps) for v in x[row]]
            qs, keys, vals = [], [], []
            for p, v in enumerate(hs):
                q = [v @ w["attn.wq"][:, j] for j in range(h)]
                qs.append([np.concatenate([qj[:dn], _turn(qj[dn:], p, a)])
                           for qj in q])
                kv = v @ w["attn.w_kv_a"]
                c = loop_decoder._rms(kv[:r], w["attn.kv_norm"], eps)
                kpe = _turn(kv[r:], p, a)
                up = [c @ w["attn.w_kv_b"][:, j] for j in range(h)]
                keys.append([np.concatenate([u[:dn], kpe]) for u in up])
                vals.append([u[dn:] for u in up])
            for p in range(s + t):
                acc = np.zeros(x[row][p].shape)
                for j in range(h):
                    sc = [qs[p][j] @ keys[p2][j] * scale
                          for p2 in range(p + 1)]
                    m = max(sc)
                    ex = [math.exp(z - m) for z in sc]
                    o = sum(e * vals[p2][j] for p2, e in enumerate(ex)) \
                        / sum(ex)
                    acc += o @ w["attn.wo"][j]
                x[row][p] = x[row][p] + acc
        h2 = [[loop_decoder._rms(v, w["ln2"], eps) for v in rw] for rw in x]
        if li < mo["first_k_dense"]:
            for row in range(b):
                for p in range(s + t):
                    x[row][p] = x[row][p] + loop_decoder._swiglu(
                        h2[row][p], w["ffn.w_gate"], w["ffn.w_up"],
                        w["ffn.w_down"])
            continue
        calls = [[(i, p) for i in range(b) for p in range(s)]]
        calls += [[(i, s + j) for i in range(b)] for j in range(t)]
        for call in calls:
            ys, drop = loop_decoder._moe_call(
                w, [h2[i][p] for i, p in call], mo)
            dropped[call is not calls[0]] += drop
            for (i, p), y in zip(call, ys):
                x[i][p] = x[i][p] + y

    def head(v):
        return loop_decoder._rms(v, top["ln_f"], eps) @ top["lm_head"]
    prefill = np.stack([head(x[i][s - 1]) for i in range(b)])
    decode = np.stack([np.stack([head(x[i][s + j]) for j in range(t)])
                       for i in range(b)]).reshape(b, t, -1)
    return prefill, decode, tuple(dropped)


@pytest.mark.parametrize("lens, steps", [(9, 1), (6, 3)])
def test_reference_matches_a_token_by_token_forward(lens, steps):
    cell = tiny_mla(prompt_len=lens, new_tokens=steps, batch=2)
    a = cell.config["arch"]
    # Positions past the original 4,096 where the ramp matters: a small
    # original window puts these short prompts across YaRN's range.
    a["rope_original_max"] = 64
    ref = cell.reference()
    weights = Weights(ref.weight_groups(a), 2**35 + 9, torch.device("cpu"),
                      torch.float32)
    traffic = Traffic(cell.traffic, a["vocab_size"], 2**32 + 5)
    tokens = torch.as_tensor(traffic.prompts("window", 0))
    dec = torch.randint(0, a["vocab_size"], (traffic.batch, steps),
                        generator=torch.Generator().manual_seed(5))
    p, d, stats = ref.forward(a, weights, tokens, dec)
    plain = {g: {k: v.double().numpy() for k, v in weights(g).items()}
             for g, _ in ref.weight_groups(a)}
    lp, ld, dropped = loop_forward(a, plain, tokens.numpy(), dec.numpy())
    np.testing.assert_allclose(p.numpy(), lp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d.numpy(), ld, rtol=TOL, atol=TOL)
    assert dropped == (stats["dropped"], stats["dropped_decode"])


def test_copied_helpers_are_the_decoders():
    """The MoE, SwiGLU, RMSNorm and float8 copies give decoder.py's
    results to the bit, drops included."""
    v2 = load_module(HERE / "references" / "deepseek_v2.py")
    dec = load_module(HERE / "references" / "decoder.py")
    g = torch.Generator().manual_seed(4)
    # A capacity of 0.5 makes sure some assignments drop.
    mo = {"num_experts": 8, "top_k": 2, "capacity_factor": 0.5,
          "num_shared_experts": 1, "norm_topk": False}
    d, f = 16, 8
    w = {"ffn.w_router": torch.randn(d, 8, generator=g),
         "ffn.w_gate": torch.randn(8, d, f, generator=g),
         "ffn.w_up": torch.randn(8, d, f, generator=g),
         "ffn.w_down": torch.randn(8, f, d, generator=g),
         "ffn.shared.w_gate": torch.randn(d, f, generator=g),
         "ffn.shared.w_up": torch.randn(d, f, generator=g),
         "ffn.shared.w_down": torch.randn(f, d, generator=g)}
    x = torch.randn(40, d, generator=g)
    for q in ((lambda t: t), dec._fp8):
        got, want = v2._moe(w, x, mo, q), dec._moe(w, x, mo, q)
        assert torch.equal(got[0], want[0]) and got[1] == want[1] > 0
    assert torch.equal(v2._fp8(x), dec._fp8(x))
    assert torch.equal(v2._rms(x, x[0], 1e-6), dec._rms(x, x[0], 1e-6))
    assert v2.capacity(mo, 40) == dec.capacity(mo, 40)


def test_fp8_control_departs_from_the_reference():
    cell = tiny_mla(batch=2, prompt_len=16, new_tokens=1)
    a = cell.config["arch"]
    ref = cell.reference()
    weights = Weights(ref.weight_groups(a), 7, torch.device("cpu"),
                      torch.float32)
    tokens = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    p32, _, _ = ref.forward(a, weights, tokens, tokens[:, -1:])
    p8, _, _ = ref.forward(a, weights, tokens, tokens[:, -1:],
                           precision="fp8")
    assert 1e-3 < (p8 - p32).abs().max() < 1.0


# ---------------------------------------------------------------------------
# FLOPs and the readers
# ---------------------------------------------------------------------------

def test_matmul_flops_a_token_and_the_band():
    cell = load_cell(CELL)
    ref, a = cell.reference(), cell.config["arch"]
    # MLA: wq 2048 x 16 x 192, w_kv_a 2048 x 576, w_kv_b 512 x 16 x 256,
    # wo 16 x 128 x 2048. Layer 0: SwiGLU 10944; layers 1-26: router
    # 2048 x 64, 6 routed experts of 1408 and the shared pair (2816).
    mla = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    dense = mla + 3 * 2048 * 10944
    moe = mla + 2048 * 64 + 3 * 2048 * (6 * 1408 + 2816)
    assert ref.matmul_flops_per_token(a) == 2 * (dense + 26 * moe) \
        == 4_483_186_688
    band = 2 * 27 * 16 * (192 + 128) * 32768 * 32769 // 2
    assert ref.attention_flops(a, 32768) == band == 148_438_599_598_080
    head = 2 * 2048 * 102400
    assert ref.prompt_flops(a, 32768) == 4_483_186_688 * 32768 + band + head
    # Attention is about half the work of a 32k prompt.
    assert 0.49 < band / ref.prompt_flops(a, 32768) < 0.51
    # 65,536 tokens a prefill: 7,680 slots an expert.
    assert ref.capacity(a["moe"], 2 * 32768) == 7680


def test_mla_flash_roofline_bound_counts_the_useful_work():
    cell = load_cell(CELL)
    a, t = cell.config["arch"], cell.traffic
    mod = load_module(HERE / "metrics" / "mla_flash_roofline.py")
    peaks = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    flops = 2 * 2 * 16 * (192 + 128) * 32768 * 32769 // 2
    assert mod.bound_s(a, t["batch"], t["prompt_len"], peaks) == \
        pytest.approx(flops / 989e12)
    # Bytes bind only at a short prompt: q, k at 192, v, out at 128.
    nbytes = 2 * 2 * 16 * 16 * (2 * 192 + 2 * 128)
    assert mod.bound_s(a, 2, 16, peaks) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("metric", ["mla_core_ms", "mla_kv_up_ms",
                                    "mla_flash_roofline"])
def test_mla_readers_read_nothing_without_a_trace_or_spans(metric):
    from repro_torch.core import tracing
    tracing.clear()

    class Run:
        trace = None
        peaks = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
        arch = load_cell(CELL).config["arch"]
    assert reader(metric)(Run()) is None
    tracing.clear()
