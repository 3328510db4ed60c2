"""Elastic stateless-worker pool (FaaS analog) and provisioned pool (IaaS).

Models the paper's §2.1/§3.2 execution substrate:
  * cold starts: sandbox creation + binary download/initialization; the
    paper keeps binaries < 10 MiB so artifacts stay cached and reusable,
  * warm starts: an existing sandbox is routed the payload,
  * two-level invocation: scheduling >= 256 workers, the coordinator fans
    invocation calls out through a subset of workers (Müller et al. [96]),
  * idle lifetime: sandboxes are reclaimed after an idle window,
  * burst scaling limits: an initial burst of up to 3,000 instances, then
    +500 instances per minute (AWS Lambda documented scaling [37]).

The same interface runs the query engine's workers and the elastic trainer's
step executors; ``ProvisionedPool`` is the IaaS deployment (paper Fig 4,
lower path) with no startup cost after boot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

MIB = 1024.0 ** 2


@dataclasses.dataclass(frozen=True)
class FaasLimits:
    initial_burst: int = 3000
    scale_per_minute: int = 500
    max_concurrency: int = 10000       # paper's raised account quota
    idle_lifetime_s: float = 420.0     # measured idle sandbox lifetime
    max_duration_s: float = 900.0


@dataclasses.dataclass(frozen=True)
class ColdStartModel:
    """Cold start = platform placement + binary fetch + runtime init."""

    placement_s: float = 0.080
    fetch_bw_bytes_s: float = 64.0 * MIB
    init_s: float = 0.060
    warm_route_s: float = 0.015
    fanout_rtt_s: float = 0.030        # per-call invocation RTT
    fanout_threshold: int = 256        # two-level invocation cutoff
    fanout_width: int = 16             # workers invoking workers

    def cold_s(self, binary_bytes: float) -> float:
        return self.placement_s + binary_bytes / self.fetch_bw_bytes_s + self.init_s


@dataclasses.dataclass
class Worker:
    worker_id: int
    ready_at: float
    cold: bool
    last_used: float = 0.0


class InvokeFailedError(RuntimeError):
    """An invocation kept failing past the capped-backoff retry schedule.

    Terminal for the stage attempt: the recovery ladder (stage re-run,
    then a structured query failure) owns what happens next."""


class ElasticPool:
    """FaaS-style pool: workers acquired per stage, released after, reused
    while warm. Purely time-model driven (no threads); the engine passes the
    simulation clock's now()."""

    # Capped exponential backoff for failed invocations (cold-start
    # errors): per-attempt draws are independent, so any failure
    # probability < 1 converges; past ``invoke_max_attempts`` the
    # invocation is terminal (``InvokeFailedError``).
    invoke_max_attempts = 6
    invoke_backoff_base_s = 0.1
    invoke_backoff_cap_s = 2.0

    def __init__(self, binary_bytes: float = 8 * MIB,
                 limits: FaasLimits = FaasLimits(),
                 coldstart: ColdStartModel = ColdStartModel(),
                 rng_seed: int = 0, chaos=None):
        self.binary_bytes = binary_bytes
        self.limits = limits
        self.coldstart = coldstart
        self._warm: list[Worker] = []
        self._next_id = 0
        self._invoke_seq = 0
        self._scale_anchor_t: Optional[float] = None
        self._started_since_anchor = 0
        self._rng = np.random.default_rng(rng_seed)
        self.chaos = chaos
        self.stats = {"cold_starts": 0, "warm_starts": 0, "invocations": 0,
                      "worker_seconds": 0.0, "peak_warm": 0, "expired": 0,
                      "invoke_faults": 0, "invoke_retry_s": 0.0,
                      "speculative_denied": 0}

    # -- acquisition ---------------------------------------------------------
    def acquire(self, n: int, t: float) -> list[Worker]:
        """Acquire ``n`` workers at time ``t``; returns them with ready_at
        set according to warm/cold starts, invocation fan-out, and platform
        scaling limits."""
        if n > self.limits.max_concurrency:
            raise RuntimeError(f"concurrency quota exceeded: {n}")
        self._expire_idle(t)
        self.stats["invocations"] += n

        # Invocation latency: two-level fan-out beyond the threshold.
        cs = self.coldstart
        if n >= cs.fanout_threshold:
            depth_calls = math.ceil(n / cs.fanout_width)
            invoke_latency = cs.fanout_rtt_s * (1 + depth_calls / n)
        else:
            invoke_latency = cs.fanout_rtt_s

        out: list[Worker] = []
        warm_available = list(self._warm)
        self._warm.clear()
        try:
            for i in range(n):
                retry_s = self._invoke_retry_delay()
                if warm_available:
                    w = warm_available.pop()
                    w.cold = False
                    w.ready_at = t + invoke_latency + retry_s + \
                        cs.warm_route_s
                    self.stats["warm_starts"] += 1
                else:
                    delay = self._scaling_delay(t)
                    jitter = float(self._rng.lognormal(0.0, 0.35))
                    w = Worker(self._next_id,
                               t + invoke_latency + retry_s + delay +
                               cs.cold_s(self.binary_bytes) * jitter,
                               cold=True)
                    self._next_id += 1
                    self.stats["cold_starts"] += 1
                out.append(w)
        except InvokeFailedError:
            # A terminally-failed acquire must not leak fleet capacity:
            # workers already started for it go back to the warm set.
            self._warm.extend(out)
            raise
        finally:
            self._warm.extend(warm_available)
        return out

    def _invoke_retry_delay(self) -> float:
        """Injected invocation failures, retried with capped backoff.

        Returns the accumulated backoff (added to the worker's ready_at)
        once an attempt lands; raises ``InvokeFailedError`` when the
        schedule is exhausted. Each invocation draws from its own
        sequence number so the fault schedule is order-deterministic."""
        seq = self._invoke_seq
        self._invoke_seq += 1
        if self.chaos is None:
            return 0.0
        delay = 0.0
        for attempt in range(self.invoke_max_attempts):
            if not self.chaos.invoke_fail(seq, attempt):
                return delay
            self.stats["invoke_faults"] += 1
            backoff = min(self.invoke_backoff_base_s * (2 ** attempt),
                          self.invoke_backoff_cap_s)
            delay += backoff
            self.stats["invoke_retry_s"] += backoff
        raise InvokeFailedError(
            f"invocation {seq} failed {self.invoke_max_attempts} attempts")

    def release(self, workers: list[Worker], t: float,
                busy_s: float = 0.0) -> None:
        for w in workers:
            w.last_used = t
            self.stats["worker_seconds"] += busy_s
            self._warm.append(w)
        # Fleet high-water mark: scale-up is visible as peak_warm growth,
        # scale-down as the expired counter (idle lifetime reclaim).
        self.stats["peak_warm"] = max(self.stats["peak_warm"],
                                      len(self._warm))

    # -- internals -----------------------------------------------------------
    def _scaling_delay(self, t: float) -> float:
        """AWS Lambda scaling: initial burst, then +500/min."""
        if self._scale_anchor_t is None or \
                t - self._scale_anchor_t > 15 * 60.0:
            self._scale_anchor_t = t
            self._started_since_anchor = 0
        self._started_since_anchor += 1
        over = self._started_since_anchor - self.limits.initial_burst
        if over <= 0:
            return 0.0
        return over / self.limits.scale_per_minute * 60.0

    def _expire_idle(self, t: float) -> None:
        keep = [w for w in self._warm
                if t - w.last_used <= self.limits.idle_lifetime_s]
        self.stats["expired"] += len(self._warm) - len(keep)
        self._warm = keep

    def warm_count(self) -> int:
        return len(self._warm)


class ProvisionedPool:
    """IaaS deployment: a fixed fleet, booted once; fragments queue on slots
    (paper Fig 4, lower path: same binary behind a Lambda-compatible shim)."""

    def __init__(self, slots: int, boot_s: float = 45.0):
        self.slots = slots
        self.boot_s = boot_s
        self._free_at = [boot_s] * slots
        self.stats = {"invocations": 0, "worker_seconds": 0.0,
                      "speculative_denied": 0}

    def acquire(self, n: int, t: float) -> list[Worker]:
        self.stats["invocations"] += n
        out = []
        # Spread one call over distinct slots, earliest-free first (an
        # idle slot must not absorb the whole stage just because it is
        # the argmin); cycle only when n exceeds the fleet. The
        # authoritative occupancy is recorded by release().
        free = list(self._free_at)
        order = sorted(range(self.slots), key=lambda s: (free[s], s))
        for i in range(n):
            slot = order[i % self.slots]
            start = max(t, free[slot])
            out.append(Worker(slot, start, cold=False))
        return out

    def schedule_fragment(self, t: float, duration_s: float) -> float:
        """Queue one fragment; returns its completion time."""
        self.stats["invocations"] += 1
        slot = int(np.argmin(self._free_at))
        start = max(t, self._free_at[slot])
        end = start + duration_s
        self._free_at[slot] = end
        self.stats["worker_seconds"] += duration_s
        return end

    def release(self, workers: list[Worker], t: float,
                busy_s: float = 0.0) -> None:
        # Mirror ElasticPool.release: bill busy time per worker AND record
        # slot occupancy, so the next stage queues behind busy slots
        # instead of seeing an always-idle fleet (cost under-billing).
        for w in workers:
            self.stats["worker_seconds"] += busy_s
            self._free_at[w.worker_id] = max(
                self._free_at[w.worker_id], w.ready_at + busy_s)
