"""Per-worker memory budget accounting (ROADMAP item 4, paper §3.1).

Serverless workers run inside a hard memory cap (the paper sizes Skyrise
workers against exactly this constraint) while their inputs do not — so
every operator that materializes data must account for it. This module is
the reservation layer the out-of-core engine hangs off:

* ``MemoryBudget(cap_bytes)`` — one per fragment execution, tracking the
  worker-wide cap. ``cap_bytes=None`` means accounting without
  enforcement (every reservation succeeds).
* ``OperatorGrant`` — a named slice of the budget handed to one operator
  (scan accumulation, join build, partition buffers). Operators call
  ``try_reserve`` before materializing and *spill instead of reserving*
  when it fails; ``release`` returns bytes as buffers are dropped.

Invariants (property-tested in ``tests/test_out_of_core.py``):

* ``budget.reserved_bytes == sum(g.used for g in grants)`` at all times;
* ``try_reserve`` never takes ``reserved_bytes`` past the cap (or a
  grant's own cap) — it refuses, and the caller spills;
* ``peak_bytes <= cap_bytes`` unless a *forced* reservation happened;
  barrier operators (a full hash aggregate, a UDF that needs the whole
  fragment) may ``reserve(..., force=True)`` because their working set
  is irreducible — the overshoot is recorded in ``overcommit_bytes``
  and surfaced into ``FragmentMetrics`` instead of hidden.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class MemoryBudgetExceeded(RuntimeError):
    """A non-forced ``reserve`` would have pushed accounting past the cap."""


class MemoryBudget:
    """Reservation-style accounting of one worker's memory cap."""

    def __init__(self, cap_bytes: Optional[float] = None):
        if cap_bytes is not None and cap_bytes <= 0:
            raise ValueError(f"cap_bytes must be positive, got {cap_bytes}")
        self.cap_bytes: Optional[int] = \
            None if cap_bytes is None or cap_bytes == float("inf") \
            else int(cap_bytes)
        self.reserved_bytes = 0
        self.peak_bytes = 0
        self.overcommit_bytes = 0     # peak of forced overshoot past the cap
        self.grants: dict[str, "OperatorGrant"] = {}

    def grant(self, name: str,
              cap_bytes: Optional[float] = None) -> "OperatorGrant":
        """Hand a named operator its slice of the budget. Without an
        explicit per-operator cap the grant is bounded by the worker cap
        alone (operators share the headroom)."""
        if name in self.grants:
            raise ValueError(f"duplicate grant {name!r}")
        g = OperatorGrant(self, name,
                          None if cap_bytes is None else int(cap_bytes))
        self.grants[name] = g
        return g

    @property
    def remaining_bytes(self) -> Optional[int]:
        if self.cap_bytes is None:
            return None
        return max(0, self.cap_bytes - self.reserved_bytes)

    def _reserve(self, n: int, force: bool) -> bool:
        if n < 0:
            raise ValueError(f"cannot reserve {n} bytes")
        if self.cap_bytes is not None \
                and self.reserved_bytes + n > self.cap_bytes and not force:
            return False
        self.reserved_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.reserved_bytes)
        if self.cap_bytes is not None:
            self.overcommit_bytes = max(
                self.overcommit_bytes,
                self.reserved_bytes - self.cap_bytes)
        return True

    def _release(self, n: int) -> None:
        if n < 0:
            raise ValueError(f"cannot release {n} bytes")
        if n > self.reserved_bytes:
            raise ValueError(
                f"release of {n} bytes exceeds the {self.reserved_bytes} "
                "bytes reserved — double release")
        self.reserved_bytes -= n


class OperatorGrant:
    """One operator's named reservation window on a ``MemoryBudget``."""

    def __init__(self, budget: MemoryBudget, name: str,
                 cap_bytes: Optional[int]):
        self.budget = budget
        self.name = name
        self.cap_bytes = cap_bytes
        self.used = 0
        self.peak = 0

    def try_reserve(self, n: int) -> bool:
        """Reserve ``n`` bytes if both the grant and the worker cap allow
        it; refuse (returning False) otherwise — the caller spills."""
        if self.cap_bytes is not None and self.used + n > self.cap_bytes:
            return False
        if not self.budget._reserve(int(n), force=False):
            return False
        self.used += int(n)
        self.peak = max(self.peak, self.used)
        return True

    def reserve(self, n: int, force: bool = False) -> None:
        """Reserve or die. ``force=True`` is the barrier-operator escape
        hatch: the bytes are charged past the cap and the overshoot is
        recorded in ``budget.overcommit_bytes``."""
        if force:
            self.budget._reserve(int(n), force=True)
            self.used += int(n)
            self.peak = max(self.peak, self.used)
            return
        if not self.try_reserve(int(n)):
            raise MemoryBudgetExceeded(
                f"grant {self.name!r}: reserving {int(n)} bytes would "
                f"exceed the budget (used {self.used}, worker reserved "
                f"{self.budget.reserved_bytes}, cap {self.budget.cap_bytes})")

    def release(self, n: int) -> None:
        n = int(n)
        if n > self.used:
            raise ValueError(
                f"grant {self.name!r}: release of {n} bytes exceeds the "
                f"{self.used} bytes it holds")
        self.used -= n
        self.budget._release(n)

    def release_all(self) -> None:
        if self.used:
            self.release(self.used)


@dataclasses.dataclass
class BudgetSnapshot:
    """Point-in-time accounting summary, surfaced into fragment metrics."""
    cap_bytes: Optional[int]
    peak_bytes: int
    overcommit_bytes: int

    @staticmethod
    def of(budget: MemoryBudget) -> "BudgetSnapshot":
        return BudgetSnapshot(budget.cap_bytes, budget.peak_bytes,
                              budget.overcommit_bytes)
