"""The plain reference on the CPU at a tiny size, against two others: a
forward written apart from it (``loop_decoder``: NumPy in float64, token
by token, the MoE capacity as per-expert slot counters), and the port's
own float32 model (the benchmark's weights written into it, its prefill
and then its decode steps through the cache). Both give the reference's
logits on the same prompts, MoE drops and all."""
import numpy as np
import pytest
import torch

from chipbench.harness import arch_config
from chipbench.tests import loop_decoder
from chipbench.tests.tiny import DENSE, MOE, tiny_cell
from chipbench.traffic import Traffic
from chipbench.weights import Weights

TOL = 1e-4   # float32 on both sides, sums in other orders


def _port_logits(cfg, weights, tokens, decode_tokens):
    from repro_torch.models import transformer as tfm
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    weights.load_into(model)
    s, steps = tokens.shape[1], decode_tokens.shape[1]
    logits, caches = tfm.forward_prefill(model, cfg, {"tokens": tokens},
                                         s + steps, impl="reference")
    out = [logits]
    for t in range(steps):
        logits, caches = tfm.forward_decode(
            model, cfg, decode_tokens[:, t:t + 1], caches, s + t)
        out.append(logits)
    return torch.stack(out, 1)


@pytest.mark.parametrize("name, lens, steps", [
    (DENSE, 16, 1), (DENSE, 12, 3), (MOE, 16, 1), (MOE, 12, 2)])
def test_reference_matches_the_port_in_float32(name, lens, steps):
    cell = tiny_cell(name, dtype="float32", prompt_len=lens,
                     new_tokens=steps, batch=6)
    a = cell.config["arch"]
    ref = cell.reference()
    weights = Weights(ref.weight_groups(a), 7, torch.device("cpu"),
                      torch.float32)
    traffic = Traffic(cell.traffic, a["vocab_size"], 11)
    tokens = torch.as_tensor(traffic.prompts("window", 0))
    dec = torch.randint(0, a["vocab_size"], (traffic.batch, steps),
                        generator=torch.Generator().manual_seed(3))
    p, d, stats = ref.forward(a, weights, tokens, dec)
    want = torch.cat([p[:, None], d], 1)
    got = _port_logits(arch_config(a), weights, tokens, dec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    if a.get("moe"):
        # The capacity drops some assignments, as the port's does.
        assert stats["dropped"] > 0


@pytest.mark.parametrize("name, lens, steps", [
    (DENSE, 9, 1), (DENSE, 6, 3), (MOE, 9, 1), (MOE, 7, 2)])
def test_reference_matches_a_token_by_token_forward(name, lens, steps):
    cell = tiny_cell(name, dtype="float32", prompt_len=lens,
                     new_tokens=steps, batch=4)
    a = cell.config["arch"]
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
    lp, ld, dropped = loop_decoder.forward(a, plain, tokens.numpy(),
                                           dec.numpy())
    np.testing.assert_allclose(p.numpy(), lp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d.numpy(), ld, rtol=TOL, atol=TOL)
    assert dropped == (stats["dropped"], stats["dropped_decode"])
    if a.get("moe"):
        # Tiny enough that the capacity drops assignments in the prefill.
        assert dropped[0] > 0


def test_fp8_control_departs_from_the_reference():
    cell = tiny_cell(DENSE, dtype="float32")
    a = cell.config["arch"]
    ref = cell.reference()
    weights = Weights(ref.weight_groups(a), 7, torch.device("cpu"),
                      torch.float32)
    tokens = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    dec = tokens[:, -1:]
    p32, d32, _ = ref.forward(a, weights, tokens, dec)
    p8, d8, _ = ref.forward(a, weights, tokens, dec, precision="fp8")
    err = (p8 - p32).abs().max()
    assert 1e-3 < err < 1.0


def test_weights_draw_again_to_the_bit():
    cell = tiny_cell(MOE)
    ref = cell.reference()
    groups = ref.weight_groups(cell.config["arch"])
    one = Weights(groups, 2**40 + 5, torch.device("cpu"), torch.bfloat16)
    two = Weights(groups, 2**40 + 5, torch.device("cpu"), torch.bfloat16)
    other = Weights(groups, 2**40 + 6, torch.device("cpu"), torch.bfloat16)
    for g, _ in groups:
        a, b, c = one(g), two(g), other(g)
        for k in a:
            assert a[k].dtype == torch.bfloat16
            assert torch.equal(a[k], b[k])
            assert not torch.equal(a[k], c[k])
