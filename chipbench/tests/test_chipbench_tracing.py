"""The readers of the program's spans and counters: the MoE counters
equal the plain reference's drops on the same tokens and weights, a
traced tiny run on the CPU reads the host-clock and counter metrics and
no device time, and each reader gives no reading where the program keeps
no spans (an empty trace, or a program without ``tracing``)."""
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chipbench.harness import arch_config, run_cell
from chipbench.manifest import reader
from chipbench.tests.tiny import DENSE, MOE, tiny_cell
from chipbench.traffic import Traffic
from chipbench.weights import Weights
from repro_torch.core import tracing

SPAN_METRICS = ("first_token_ms", "attention_ms", "mlp_ms", "block_self_ms",
                "moe_ms", "moe_routing_ms", "moe_drop_share")
DEVICE_METRICS = ("attention_ms", "mlp_ms", "block_self_ms", "moe_ms",
                  "moe_routing_ms")


@pytest.fixture(autouse=True)
def empty():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("seed, batch, prompt_len", [
    (7, 6, 16), (2**31 + 5, 4, 24), (2**33 + 1, 8, 12)])
def test_moe_counters_equal_the_reference_drops(seed, batch, prompt_len):
    from repro_torch.serve.engine import Request, ServingEngine
    cell = tiny_cell(MOE, dtype="float32", batch=batch,
                     prompt_len=prompt_len)
    a = cell.config["arch"]
    ref = cell.reference()
    weights = Weights(ref.weight_groups(a), seed, torch.device("cpu"),
                      torch.float32)
    traffic = Traffic(cell.traffic, a["vocab_size"], seed)
    prompts = traffic.prompts("window", 0)
    engine = ServingEngine(arch_config(a), batch, prompt_len, prompt_len + 1,
                           impl=cell.config["impl"], device="cpu")
    weights.load_into(engine.model)
    reqs = [Request(i, p, max_new_tokens=1) for i, p in enumerate(prompts)]
    with profile(activities=[ProfilerActivity.CPU]):
        engine.serve(reqs)
    rows, got = tracing.records(), tracing.counters()
    step = {rows[s].name: s for s, _ in got}
    pre, dec = step["serve.prefill"], step["serve.decode"]
    served = torch.as_tensor(np.stack([r.completion for r in reqs]))
    _, _, stats = ref.forward(a, weights, torch.as_tensor(prompts), served)
    assert stats["dropped"] > 0
    assert got[pre, "moe.assignments"] - got[pre, "moe.kept"] == \
        stats["dropped"]
    assert got[dec, "moe.assignments"] - got[dec, "moe.kept"] == \
        stats["dropped_decode"]
    mo, moe_layers = a["moe"], a["num_layers"] - a["moe"]["first_k_dense"]
    tokens = batch * prompt_len
    assert got[pre, "moe.assignments"] == moe_layers * tokens * mo["top_k"]
    assert got[pre, "moe.slots"] == moe_layers * mo["num_experts"] * \
        ref.capacity(mo, tokens)
    assert got[dec, "moe.slots"] == moe_layers * mo["num_experts"] * \
        ref.capacity(mo, batch)


def test_readers_see_only_the_last_profiled_session():
    """Two profiled ``serve()`` calls in one process, each read after its
    profiler stops (as ``run_cell`` reads its traced tail): the second
    reading holds the second call's batch alone."""
    from repro_torch.serve.engine import Request, ServingEngine
    seed, batch, prompt_len = 2**31 + 9, 4, 16
    cell = tiny_cell(MOE, dtype="float32", batch=batch,
                     prompt_len=prompt_len)
    a = cell.config["arch"]
    weights = Weights(cell.reference().weight_groups(a), seed,
                      torch.device("cpu"), torch.float32)
    traffic = Traffic(cell.traffic, a["vocab_size"], seed)
    engine = ServingEngine(arch_config(a), batch, prompt_len, prompt_len + 1,
                           impl=cell.config["impl"], device="cpu")
    weights.load_into(engine.model)

    def session(i):
        reqs = [Request(100 * i + r, p, max_new_tokens=1)
                for r, p in enumerate(traffic.prompts("window", i))]
        with profile(activities=[ProfilerActivity.CPU]):
            engine.serve(reqs)
        got = {m: reader(m)(None) for m in SPAN_METRICS}
        return got, [r.batch for r in tracing.records()
                     if r.name == "serve.batch"]
    one, first = session(0)
    two, second = session(1)
    assert (first, second) == ([0], [100])
    for got in (one, two):
        assert got["first_token_ms"] > 0 and 0 < got["moe_drop_share"] < 100
    tracing.clear()
    alone, _ = session(1)
    assert two["moe_drop_share"] == alone["moe_drop_share"]


def _traced_run(name):
    cell = tiny_cell(name)
    cell.traffic["check"]["limits"] = {"token_gap": 0.05, "logit_err": 0.05}
    return run_cell(cell, 2**31 + 17, 0.2, True, device="cpu",
                    t_start=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_traced_tiny_run_reads_host_and_counter_metrics_only(name):
    out = _traced_run(name)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["first_token_ms"]["value"] > 0
    assert got["first_token_ms"]["unit"] == "ms"
    if name == MOE:
        assert 0 < got["moe_drop_share"]["value"] < 100
    else:
        assert "moe_drop_share" not in got
    # No device time on the CPU, so no device-time metric.
    assert not set(DEVICE_METRICS) & set(got)
    # The program's ranges are host ranges of the trace; none of them is
    # counted as a device operation.
    assert out["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_without_spans_reads_nothing(metric):
    assert reader(metric)(None) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_of_a_program_without_tracing_reads_nothing(metric,
                                                           monkeypatch):
    # A checkout of the program from before the spans has no
    # ``repro_torch.core.tracing``: an import of it fails there.
    monkeypatch.setitem(sys.modules, "repro_torch.core.tracing", None)
    assert reader(metric)(None) is None


def test_device_readers_on_made_up_device_times(monkeypatch):
    """Two prefills (and a decode the readers pass over), with device
    times as the spans' CUDA events would give them."""
    S = tracing.Span
    rows = []

    def add(name, parent, step, ms):
        rows.append(S(name, parent, step, 0, {}, device_ms=ms))
        return len(rows) - 1
    for scale in (1.0, 3.0):
        p = add("serve.prefill", None, len(rows), 100 * scale)
        b = add("model.block", p, p, 40 * scale)
        add("model.attention", b, p, 20 * scale)
        add("model.mlp", b, p, 15 * scale)
        b = add("model.block", p, p, 50 * scale)
        add("model.attention", b, p, 10 * scale)
        m = add("model.moe", b, p, 35 * scale)
        for part, ms in (("moe.route", 2), ("moe.dispatch", 5),
                         ("moe.experts", 20), ("moe.combine", 4),
                         ("moe.shared", 3)):
            add(part, m, p, ms * scale)
        d = add("serve.decode", None, len(rows), 9.0)
        add("model.attention", d, d, 1000.0)
    monkeypatch.setattr(tracing, "records", lambda: rows)
    want = {"attention_ms": 60.0, "mlp_ms": 30.0, "moe_ms": 70.0,
            "moe_routing_ms": 22.0, "block_self_ms": 20.0}
    for metric, value in want.items():
        assert reader(metric)(None) == pytest.approx(value), metric
