"""Spans and counters on the serving path, kept only while
``torch.profiler`` runs.

``span(name, **ids)`` marks a piece of work (``spanned(name)`` every call
of a function). With no profiler running it returns one shared no-op
context: one flag read, no range, no row, no clock. Under a profiler it
opens a ``torch.profiler.record_function`` range of that name, so the
profiler's trace holds it beside the device's operations, and keeps a
row (``Span``): its parent span, the engine step it ran in
(``serve.prefill`` or ``serve.decode``), the batch's first request id
and its host start and end. A span inside a prefill (``TIMED``), where
the process has initialised CUDA, also records a pair of timing events
on the current stream, with no synchronisation; the decode's spans keep
the range and the row only, since nothing reads a decode span's device
time and the events would lengthen the host-bound decode step.
``count(name, value)`` adds an int, or a 0-dim device tensor (never read
back while counting), to a counter of the innermost open step.

``records()`` and ``counters()`` synchronise once and resolve the events
to device milliseconds and the tensors to ints. The rows and counters
are those of one profiled session: once they have been read with no
profiler running, the next span or count under a profiler starts
afresh. ``clear()`` forgets them at once. An operator traces the engine
by running it under ``torch.profiler``; nothing else switches the spans
on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

# The engine's step spans: each row names the innermost one it ran in,
# and the counters are kept per step.
STEPS = ("serve.prefill", "serve.decode")
# The step whose spans keep device times: the only one a reader times.
TIMED = "serve.prefill"
_OFF = contextlib.nullcontext()

_rows: list = []        # Span rows, in the order they opened
_open: list = []        # indices of the open rows, innermost last
_events: dict = {}      # row index -> (start, end) CUDA events
_counts: dict = {}      # (step row index or None, name) -> int or tensor
_read = False           # read with no profiler running: the session ended


@dataclasses.dataclass
class Span:
    name: str
    parent: Optional[int]       # row index of the enclosing span
    step: Optional[int]         # row index of the enclosing engine step
    batch: Optional[int]        # the batch's first request id
    ids: dict
    start_ns: int = 0           # host clock, time.perf_counter_ns
    end_ns: int = 0
    device_ms: Optional[float] = None   # CUDA events, set by records()


_TOP = Span("", None, None, None, {})   # what a span outside any inherits


def enabled() -> bool:
    """Whether spans and counters are kept: a profiler is running."""
    return _profiler._is_profiler_enabled


def span(name: str, **ids):
    """A context that marks ``name`` (see the module's docstring);
    ``batch=`` among ``ids`` sets the row's batch id, which the spans
    inside it inherit."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _span(name, ids)


def spanned(name: str):
    """A decorator: every call of the function runs inside
    ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _session() -> None:
    """Start afresh where the rows were read after their session."""
    if _read and not _open:
        clear()


@contextlib.contextmanager
def _span(name: str, ids: dict):
    _session()
    i = len(_rows)
    parent = _open[-1] if _open else None
    up = _rows[parent] if parent is not None else _TOP
    step = i if name in STEPS else up.step
    row = Span(name, parent, step, ids.get("batch", up.batch), ids)
    _rows.append(row)
    ev = None
    if step is not None and _rows[step].name == TIMED and \
            torch.cuda.is_initialized():
        ev = _events[i] = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
    _open.append(i)
    with torch.profiler.record_function(name):
        row.start_ns = time.perf_counter_ns()
        if ev:
            ev[0].record()
        try:
            yield
        finally:
            if ev:
                ev[1].record()
            row.end_ns = time.perf_counter_ns()
            _open.pop()


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` of the innermost open step
    (of no step outside one)."""
    if not _profiler._is_profiler_enabled:
        return
    _session()
    key = (_rows[_open[-1]].step if _open else None, name)
    _counts[key] = _counts.get(key, 0) + value


def _ended() -> None:
    """A read with no profiler running ends the rows' session."""
    global _read
    if not _profiler._is_profiler_enabled:
        _read = True


def records() -> list:
    """The rows kept so far, the closed ones' device milliseconds
    resolved."""
    _ended()
    done = [i for i in _events if i not in _open]
    if done:
        torch.cuda.synchronize()
    for i in done:
        start, end = _events.pop(i)
        _rows[i].device_ms = start.elapsed_time(end)
    return list(_rows)


def counters() -> dict:
    """{(row index of the step, or None, counter name): int}."""
    _ended()
    keys = [k for k, v in _counts.items() if isinstance(v, torch.Tensor)]
    if keys:
        vals = torch.stack([_counts[k].reshape(()) for k in keys]).tolist()
        _counts.update(zip(keys, vals))
    return {k: int(v) for k, v in _counts.items()}


def clear() -> None:
    """Forget every row and counter (call with no span open)."""
    global _read
    _rows.clear()
    _events.clear()
    _counts.clear()
    _read = False


def self_ms(rows: list) -> list:
    """Each row's device milliseconds less those of its direct children
    (None where the row, or a child, has no device time)."""
    own = [r.device_ms for r in rows]
    for r in rows:
        if r.parent is not None and own[r.parent] is not None:
            own[r.parent] = None if r.device_ms is None else \
                own[r.parent] - r.device_ms
    return own


def step_ms(names, *, own: bool = False):
    """Device milliseconds of the spans named in ``names`` (their own
    time, less their direct children's, with ``own``), summed over each
    prefill (``TIMED``) that holds any: one sum a prefill, in order.
    Empty where none ran or none has a device time (a run on the CPU)."""
    rows = records()
    ms = self_ms(rows) if own else [r.device_ms for r in rows]
    names = (names,) if isinstance(names, str) else tuple(names)
    sums: dict = {}
    for r, t in zip(rows, ms):
        if r.name in names and r.step is not None and \
                rows[r.step].name == TIMED:
            if t is None:
                return []
            sums[r.step] = sums.get(r.step, 0.0) + t
    return list(sums.values())
