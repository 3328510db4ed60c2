"""What a ``torch.profiler`` trace of the traced batches says: the device's
operations, the busy union of their intervals, the benchmark's own spans
(``record_function`` ranges named ``chipbench.*``), and the breakdown.

Reads the profiler's raw events (``kineto_results.events()``) and never
builds its per-operator tables, which take minutes on traces this size.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

SPAN_PREFIX = "chipbench."
# Idle gaps that are labelled by the host operation running at their
# start, longest first.
LABELLED_GAPS = 4000


@dataclasses.dataclass
class Trace:
    ops: list            # (name, start_ns, end_ns) of every device operation
    spans: dict          # span name -> [(start_ns, end_ns)]
    host: tuple          # (starts, ends, names) of host operations
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """The union of the device operations' intervals inside the
        window, as sorted, disjoint (start, end) rows."""
        if not self.ops:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, e) for _, s, e in self.ops], np.int64)
        iv = np.clip(iv, self.start_ns, self.end_ns)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        out = []
        cs, ce = iv[0]
        for s, e in iv[1:]:
            if s > ce:
                out.append((cs, ce))
                cs, ce = s, e
            elif e > ce:
                ce = e
        out.append((cs, ce))
        return np.array(out, np.int64)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def ops_in(self, span: str, pattern) -> list:
        """The device operations whose name matches ``pattern`` (a
        compiled regex) and that start inside a ``span`` range."""
        ranges = self.spans.get(span, [])
        return [(n, s, e) for n, s, e in self.ops if pattern.search(n)
                and any(a <= s <= b for a, b in ranges)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations by total seconds, and the idle gaps'
        seconds by what the host was doing at each gap's start (the
        innermost host operation running then, after the innermost
        benchmark span)."""
        by_op = defaultdict(float)
        for n, s, e in self.ops:
            by_op[n[:120]] += (e - s) / 1e9
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        iv = self.busy_intervals()
        edges = np.concatenate([[self.start_ns], iv.ravel(), [self.end_ns]])
        gaps = edges.reshape(-1, 2)                   # (idle start, end)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:LABELLED_GAPS]
        starts, ends, names = self.host
        by_gap = defaultdict(float)
        for g0, g1 in gaps:
            by_gap[self._label(g0, starts, ends, names)] += (g1 - g0) / 1e9
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in idle]}

    def _label(self, t, starts, ends, names) -> str:
        span = "outside spans"
        for name, ranges in self.spans.items():
            if name != "chipbench.tail" and any(a <= t < b for a, b in ranges):
                span = name
        inside = np.nonzero((starts <= t) & (ends > t))[0]
        if inside.size == 0:
            return span
        return f"{span} {names[inside[np.argmax(starts[inside])]]}"


def read(prof, window_span: str = "chipbench.tail") -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``: its window is
    the one range named ``window_span``."""
    from torch.autograd import DeviceType
    ops, spans = [], defaultdict(list)
    hs, he, hn = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # The device's copies of the benchmark's own ranges
            # (gpu_user_annotation) are no operations.
            if not (name.startswith(SPAN_PREFIX) or ev.is_user_annotation()):
                ops.append((name, s, e))
        elif name.startswith(SPAN_PREFIX):
            spans[name].append((s, e))
        else:
            hs.append(s)
            he.append(e)
            hn.append(name)
    (start, end), = spans[window_span]
    host = (np.array(hs, np.int64), np.array(he, np.int64), hn)
    return Trace(sorted(ops, key=lambda o: o[1]), dict(spans), host, start,
                 end)
