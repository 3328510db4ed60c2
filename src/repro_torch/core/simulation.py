"""Minimal discrete-event simulation clock for the evaluation platform.

The paper runs against real AWS; this container has no cloud fabric, so the
benchmarks execute the same engine logic against calibrated service models
driven by this clock (DESIGN.md §2, "changed assumptions")."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class SimClock:
    """Priority-queue discrete-event loop with a monotonically advancing now()."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._counter = itertools.count()

    def now(self) -> float:
        return self._now

    def at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self._now:
            raise ValueError(f"cannot schedule in the past: {t} < {self._now}")
        heapq.heappush(self._events, (t, next(self._counter), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self._now + dt, fn)

    def advance(self, dt: float) -> None:
        """Advance time without events (used by sequential simulations)."""
        self._now += dt

    def peek(self) -> Optional[float]:
        """Time of the next pending event, or None when the queue is empty."""
        return self._events[0][0] if self._events else None

    def pending(self) -> int:
        return len(self._events)

    def run(self, until: Optional[float] = None) -> float:
        while self._events:
            t, _, fn = self._events[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._events)
            self._now = max(self._now, t)
            fn()
        if until is not None:
            self._now = max(self._now, until)
        return self._now
