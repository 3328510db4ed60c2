"""The port's spans and counters (``repro_torch.core.tracing``): nothing
kept, and no profiler range entered, while no profiler runs; under a CPU
profiler, rows that nest with their parents, steps and batch ids, self
times, counters keyed by the engine step, and the serving engine's span
tree and request latencies."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import ARCHS
from repro_torch.core import tracing
from repro_torch.serve.engine import Request, ServingEngine


@pytest.fixture(autouse=True)
def empty():
    tracing.clear()
    yield
    tracing.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = tracing.span("serve.batch", batch=3), tracing.span("model.mlp")
    assert a is b
    with a:
        with tracing.span("serve.prefill"):
            tracing.count("moe.kept", torch.tensor(5))
    assert not tracing.enabled()
    assert tracing.records() == [] and tracing.counters() == {}


def test_spanned_function_runs_with_and_without_a_profiler():
    @tracing.spanned("moe.route")
    def f(x, *, y=1):
        return x + y
    assert f(1, y=2) == 3 and f.__name__ == "f"
    assert tracing.records() == []
    with _profiled():
        assert f(2) == 3
    assert [r.name for r in tracing.records()] == ["moe.route"]


def _tree():
    """batch 7 > prefill > (block > attention, mlp) ; batch 7 > readback;
    batch 7 > decode > block; then a second batch 9."""
    for first in (7, 9):
        with tracing.span("serve.batch", batch=first, size=2):
            with tracing.span("serve.prefill"):
                with tracing.span("model.block", layer=0):
                    with tracing.span("model.attention"):
                        tracing.count("moe.kept", torch.tensor(3))
                    with tracing.span("model.mlp"):
                        tracing.count("moe.kept", 2)
                        tracing.count("moe.assignments", 6)
            with tracing.span("serve.readback"):
                pass
            with tracing.span("serve.decode"):
                with tracing.span("model.block", layer=0):
                    tracing.count("moe.kept", 1)
        tracing.count("moe.kept", 100)      # outside any step


def test_rows_nest_with_parents_steps_and_batches():
    with _profiled() as prof:
        _tree()
    rows = tracing.records()
    got = [(r.name, r.parent, r.step, r.batch) for r in rows[:8]]
    assert got == [("serve.batch", None, None, 7),
                   ("serve.prefill", 0, 1, 7),
                   ("model.block", 1, 1, 7),
                   ("model.attention", 2, 1, 7),
                   ("model.mlp", 2, 1, 7),
                   ("serve.readback", 0, None, 7),
                   ("serve.decode", 0, 6, 7),
                   ("model.block", 6, 6, 7)]
    assert [r.batch for r in rows[8:]] == [9] * 8
    assert rows[0].ids == {"batch": 7, "size": 2} and \
        rows[2].ids == {"layer": 0}
    for r in rows:
        assert r.end_ns >= r.start_ns and r.device_ms is None
        if r.parent is not None:
            up = rows[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    # The profiler's own trace holds the ranges, on the host.
    names = {e.name for e in prof.events()}
    assert {"serve.batch", "serve.prefill", "model.block",
            "model.attention"} <= names


def test_self_time_is_the_span_less_its_children():
    """Device times as CUDA events would give them, on made-up rows; on
    the CPU no row has one, so self times are None, not host times."""
    S = tracing.Span
    rows = [S("serve.prefill", None, 0, 1, {}, device_ms=100.0),
            S("model.block", 0, 0, 1, {}, device_ms=40.0),
            S("model.attention", 1, 0, 1, {}, device_ms=25.0),
            S("model.mlp", 1, 0, 1, {}, device_ms=10.0),
            S("model.block", 0, 0, 1, {}, device_ms=30.0),
            S("model.moe", 4, 0, 1, {}, device_ms=None)]
    assert tracing.self_ms(rows) == [30.0, 5.0, 25.0, 10.0, None, None]
    with _profiled():
        _tree()
    rows = tracing.records()
    assert tracing.self_ms(rows) == [None] * len(rows)
    assert tracing.step_ms("model.attention") == []


class _FakeEvent:
    """A CUDA timing event on the host clock."""
    made = 0

    def __init__(self, enable_timing):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_only_a_prefill_spans_keep_device_times(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _FakeEvent.made = 0
    with _profiled():
        _tree()
    rows = tracing.records()
    timed = [r.name for r in rows if r.device_ms is not None]
    assert timed == ["serve.prefill", "model.block", "model.attention",
                     "model.mlp"] * 2
    assert _FakeEvent.made == 2 * len(timed)
    for i, r in enumerate(rows):
        in_prefill = r.step is not None and rows[r.step].name == \
            "serve.prefill"
        assert (r.device_ms is not None) == in_prefill, (i, r.name)
        if in_prefill:
            assert r.device_ms >= 0
    # Each prefill's own time is its span less its one block.
    own = tracing.self_ms(rows)
    assert own[1] == pytest.approx(rows[1].device_ms - rows[2].device_ms)
    assert len(tracing.step_ms("model.attention")) == 2


def test_counters_are_keyed_by_the_open_step():
    with _profiled():
        _tree()
    got = tracing.counters()
    assert got == {(1, "moe.kept"): 5, (1, "moe.assignments"): 6,
                   (6, "moe.kept"): 1, (9, "moe.kept"): 5,
                   (9, "moe.assignments"): 6, (14, "moe.kept"): 1,
                   (None, "moe.kept"): 200}
    assert all(type(v) is int for v in got.values())


def test_step_ms_sums_each_step_and_own_time(monkeypatch):
    """Device times as CUDA events would give them, on made-up rows."""
    S = tracing.Span
    rows = [S("serve.prefill", None, 0, 1, {}, device_ms=100.0),
            S("model.block", 0, 0, 1, {}, device_ms=40.0),
            S("model.attention", 1, 0, 1, {}, device_ms=25.0),
            S("model.mlp", 1, 0, 1, {}, device_ms=10.0),
            S("model.block", 0, 0, 1, {}, device_ms=30.0),
            S("model.attention", 4, 0, 1, {}, device_ms=20.0),
            S("serve.decode", None, 6, 1, {}, device_ms=9.0),
            S("model.attention", 6, 6, 1, {}, device_ms=4.0),
            S("serve.prefill", None, 8, 2, {}, device_ms=50.0),
            S("model.attention", 8, 8, 2, {}, device_ms=11.0)]
    monkeypatch.setattr(tracing, "records", lambda: rows)
    # The decode's attention (4 ms) is no prefill's.
    assert tracing.step_ms("model.attention") == [45.0, 11.0]
    assert tracing.step_ms(("model.attention", "model.mlp")) == [55.0, 11.0]
    assert tracing.step_ms("model.block", own=True) == [15.0]
    assert tracing.step_ms("model.moe") == []


def _engine(batch=2, prompt=8, new=3):
    cfg = ARCHS["internlm2-1.8b"].reduced()
    return ServingEngine(cfg, batch_size=batch, max_prompt=prompt,
                         max_len=prompt + new + 1, device="cpu"), cfg


def _requests(vocab, news, first=40):
    rng = np.random.default_rng(5)
    return [Request(first + i, rng.integers(0, vocab, 8).astype(np.int32),
                    max_new_tokens=m) for i, m in enumerate(news)]


def test_engine_span_tree_under_a_profiler():
    eng, cfg = _engine()
    with _profiled():
        done = eng.serve(_requests(cfg.vocab_size, [2, 1, 1]))
    assert [r.request_id for r in done] == [40, 41, 42]
    rows = tracing.records()
    batches = [i for i, r in enumerate(rows) if r.name == "serve.batch"]
    assert [rows[i].ids for i in batches] == [{"batch": 40, "size": 2},
                                              {"batch": 42, "size": 1}]
    kids = [r.name for r in rows if r.parent == batches[0]]
    assert kids == ["serve.prefill", "serve.readback", "serve.decode",
                    "serve.readback", "serve.decode"]
    prefill = batches[0] + 1
    inside = [r.name for r in rows if r.parent == prefill]
    assert inside == ["model.embed"] + ["model.block"] * cfg.num_layers + \
        ["model.lm_head"]
    blocks = [i for i, r in enumerate(rows) if r.name == "model.block"
              and r.step == prefill]
    assert [rows[i].ids["layer"] for i in blocks] == \
        list(range(cfg.num_layers))
    for i in blocks:
        assert [r.name for r in rows if r.parent == i] == \
            ["model.attention", "model.mlp"]
    assert {r.batch for r in rows[batches[1]:]} == {42}


def test_latency_ends_when_the_request_last_token_is_on_the_host():
    eng, cfg = _engine(batch=3, new=4)
    with _profiled():
        done = eng.serve(_requests(cfg.vocab_size, [1, 4, 2]))
    rows = tracing.records()
    batch = rows[0]
    backs = [r for r in rows if r.name == "serve.readback"]
    assert len(backs) == 4
    lat = {r.request_id: r.latency_s for r in done}
    assert 0 < lat[40] < lat[42] < lat[41] < \
        (batch.end_ns - batch.start_ns) / 1e9
    # Each request's latency ends right after its last token's readback
    # (the batch span opens a moment before the engine's clock starts).
    for rid, n in ((40, 1), (42, 2), (41, 4)):
        to_back = (backs[n - 1].end_ns - batch.start_ns) / 1e9
        assert to_back - 0.02 <= lat[rid] <= to_back + 0.02
        if n < 4:
            assert lat[rid] < (backs[n].start_ns - batch.start_ns) / 1e9


def _batches():
    return [r.ids["batch"] for r in tracing.records()
            if r.name == "serve.batch"]


def test_a_session_read_after_the_profiler_stops_ends_there():
    eng, cfg = _engine()
    with _profiled():
        eng.serve(_requests(cfg.vocab_size, [1, 1]))
        assert _batches() == [40]    # read while profiling: it goes on
        eng.serve(_requests(cfg.vocab_size, [1], first=50))
    assert _batches() == [40, 50]
    first = tracing.records()
    assert tracing.records() == first and tracing.counters() == {}
    eng.serve(_requests(cfg.vocab_size, [1], first=55))  # not profiled
    assert tracing.records() == first
    with _profiled():
        eng.serve(_requests(cfg.vocab_size, [1, 1], first=60))
    rows = tracing.records()
    assert _batches() == [60]
    assert rows[0].name == "serve.batch" and rows[0].parent is None
    assert rows[1].name == "serve.prefill" and rows[1].step == 1


def test_sessions_not_read_in_between_are_kept_together():
    eng, cfg = _engine()
    for first in (40, 60):
        with _profiled():
            eng.serve(_requests(cfg.vocab_size, [1, 1], first=first))
    assert _batches() == [40, 60]
    tracing.clear()
    assert tracing.records() == []
