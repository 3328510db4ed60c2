"""Network token-bucket model (paper 4.2, Figs 5-7).

The paper's measurements identify, for Lambda functions:
  * independent inbound and outbound buckets,
  * initial capacity ~300 MiB each = ~150 MiB one-off budget (never refills)
    + ~150 MiB rechargeable capacity,
  * burst bandwidth ~1.2 GiB/s inbound (sustainable ~250 ms from full),
  * once empty, a baseline drip of 7.5 MiB per 100 ms interval (75 MiB/s),
  * the rechargeable half refills as soon as the function stops using the
    network (or terminates).

EC2 instances use the same mechanism with size-dependent parameters
(Fig 6); the catalog lives in ``core.pricing.EC2_CATALOG``.

This model is a first-class framework component: the data pipeline and the
checkpoint writer use ``plan_transfer``/``burst_budget_bytes`` to size their
reads so scans finish inside the burst (paper Fig 14), and the dry-run
roofline reuses the same abstraction for ICI/DCN link budgets.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

MIB = 1024.0 ** 2
GIB = 1024.0 ** 3


@dataclasses.dataclass
class TokenBucketConfig:
    burst_bw: float                    # bytes/s while tokens remain
    baseline_interval_bytes: float     # bytes deliverable per baseline interval
    baseline_interval_s: float         # interval length (100 ms for Lambda)
    oneoff_bytes: float                # non-rechargeable budget
    rechargeable_bytes: float          # refills (to full) when idle

    @property
    def initial_bytes(self) -> float:
        return self.oneoff_bytes + self.rechargeable_bytes

    @property
    def baseline_bw(self) -> float:
        return self.baseline_interval_bytes / self.baseline_interval_s


LAMBDA_INBOUND = TokenBucketConfig(
    burst_bw=1.2 * GIB, baseline_interval_bytes=7.5 * MIB,
    baseline_interval_s=0.1, oneoff_bytes=150 * MIB,
    rechargeable_bytes=150 * MIB)

# Outbound shows reduced burst bandwidth and higher variance (iPerf3 data
# generation overhead, paper 4.2.1); the bucket parameters match inbound.
LAMBDA_OUTBOUND = TokenBucketConfig(
    burst_bw=0.9 * GIB, baseline_interval_bytes=7.5 * MIB,
    baseline_interval_s=0.1, oneoff_bytes=150 * MIB,
    rechargeable_bytes=150 * MIB)


def ec2_bucket(instance) -> TokenBucketConfig:
    """Token bucket for an EC2 instance spec (Fig 6)."""
    burst = instance.net_burst_gbps * 1e9 / 8.0
    base = instance.net_baseline_gbps * 1e9 / 8.0
    bucket = instance.net_bucket_gib * GIB
    return TokenBucketConfig(
        burst_bw=burst, baseline_interval_bytes=base * 0.1,
        baseline_interval_s=0.1,
        oneoff_bytes=0.0, rechargeable_bytes=bucket)


class TokenBucket:
    """Continuous-time token bucket with idle refill (rechargeable part only)."""

    def __init__(self, config: TokenBucketConfig):
        self.config = config
        self._tokens = config.initial_bytes
        self._oneoff_left = config.oneoff_bytes
        self._recharge_ceiling = config.rechargeable_bytes

    @property
    def tokens(self) -> float:
        return self._tokens

    def notify_idle(self) -> None:
        """Paper 4.2.1: the bucket refills halfway to the *initial* capacity
        (i.e. the rechargeable half refills fully) as soon as the function
        stops utilizing the network."""
        self._tokens = max(self._tokens, self._recharge_ceiling)

    def consume(self, nbytes: float) -> float:
        """Consume ``nbytes``; returns the transfer duration in seconds.

        Tokens are spent at burst bandwidth; once exhausted, the remainder
        drips at baseline in fixed intervals.
        """
        cfg = self.config
        burst_bytes = min(nbytes, self._tokens)
        t = burst_bytes / cfg.burst_bw
        spent_oneoff = min(burst_bytes, self._oneoff_left)
        self._oneoff_left -= spent_oneoff
        self._tokens -= burst_bytes
        rest = nbytes - burst_bytes
        if rest > 0:
            intervals = rest / cfg.baseline_interval_bytes
            t += intervals * cfg.baseline_interval_s
        return t

    def throughput_trace(self, duration_s: float, dt: float = 0.02,
                         idle_windows: Iterable[tuple[float, float]] = ()
                         ) -> list[tuple[float, float]]:
        """Simulated (t, bytes/s) samples under full demand, with optional
        idle windows — reproduces the shape of paper Fig 5."""
        idle = list(idle_windows)
        out: list[tuple[float, float]] = []
        cfg = self.config
        interval_credit = 0.0
        t = 0.0
        while t < duration_s:
            if any(a <= t < b for a, b in idle):
                self.notify_idle()
                out.append((t, 0.0))
                t += dt
                continue
            if self._tokens > 0:
                sent = min(cfg.burst_bw * dt, self._tokens)
                spent_oneoff = min(sent, self._oneoff_left)
                self._oneoff_left -= spent_oneoff
                self._tokens -= sent
            else:
                # Baseline drip: credit arrives in 100 ms quanta.
                interval_credit += dt
                if interval_credit >= cfg.baseline_interval_s:
                    interval_credit -= cfg.baseline_interval_s
                    sent = cfg.baseline_interval_bytes
                else:
                    sent = 0.0
            out.append((t, sent / dt))
            t += dt
        return out


# ---------------------------------------------------------------------------
# Burst-aware transfer planning (the framework-facing API)
# ---------------------------------------------------------------------------

def burst_budget_bytes(config: TokenBucketConfig = LAMBDA_INBOUND) -> float:
    """The per-worker ingress budget a planner should not exceed (Fig 14)."""
    return config.initial_bytes


def transfer_time(nbytes: float, config: TokenBucketConfig = LAMBDA_INBOUND,
                  fresh: bool = True) -> float:
    """Time to move ``nbytes`` through a (fresh or drained) bucket."""
    b = TokenBucket(config)
    if not fresh:
        b._tokens = 0.0
        b._oneoff_left = 0.0
    return b.consume(nbytes)


def effective_throughput(nbytes: float,
                         config: TokenBucketConfig = LAMBDA_INBOUND) -> float:
    """Average bytes/s for a transfer of ``nbytes`` from a fresh bucket.

    This is the paper's Fig-14 'network model' curve: flat at burst bandwidth
    until the budget is exceeded, then decaying toward baseline.
    """
    return nbytes / transfer_time(nbytes, config)


def plan_transfer(total_bytes: float, workers: int,
                  config: TokenBucketConfig = LAMBDA_INBOUND
                  ) -> dict[str, float]:
    """Split a scan of ``total_bytes`` across workers, reporting whether each
    worker stays inside its burst budget and the expected scan time."""
    per_worker = total_bytes / max(workers, 1)
    budget = burst_budget_bytes(config)
    return {
        "per_worker_bytes": per_worker,
        "within_burst": float(per_worker <= budget),
        "expected_seconds": transfer_time(per_worker, config),
        "expected_bw": effective_throughput(per_worker, config),
        "min_workers_for_burst": total_bytes / budget,
    }


# ---------------------------------------------------------------------------
# Admission control (serving layer)
# ---------------------------------------------------------------------------
#
# The network buckets above model bandwidth; the serving layer reuses the
# same token-bucket mechanism for per-tenant ADMISSION control: each
# tenant holds a budget of worker invocations (a query's cost = its total
# fragment count) that refills continuously, so one tenant saturating its
# bucket queues its own queries without starving another tenant's.

@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Per-tenant invocation budget: ``capacity`` tokens burst, refilling
    at ``refill_per_s`` tokens per model-time second."""

    capacity: float = 256.0
    refill_per_s: float = 8.0


class AdmissionBucket:
    """Continuous-refill token bucket over worker invocations.

    Deterministic and clocked in model time (the caller passes ``t``), so
    the serving event loop can compute exactly when a queued query becomes
    admissible (``time_until``) instead of polling."""

    def __init__(self, config: AdmissionConfig = AdmissionConfig()):
        self.config = config
        self._tokens = float(config.capacity)
        self._t = 0.0
        self.admitted = 0
        self.denied = 0

    def _advance(self, t: float) -> None:
        if t > self._t:
            self._tokens = min(
                self.config.capacity,
                self._tokens + (t - self._t) * self.config.refill_per_s)
            self._t = t

    def tokens_at(self, t: float) -> float:
        self._advance(t)
        return self._tokens

    def try_acquire(self, n: float, t: float) -> bool:
        """Take ``n`` tokens at model time ``t``; consumes only on
        success. Costs above ``capacity`` clamp to the full bucket —
        an over-wide query admits when the bucket is full rather than
        never."""
        self._advance(t)
        n = min(float(n), self.config.capacity)
        if self._tokens >= n:
            self._tokens -= n
            self.admitted += 1
            return True
        self.denied += 1
        return False

    def time_until(self, n: float, t: float) -> float:
        """Model-time delay until ``n`` tokens are available (0 if now)."""
        self._advance(t)
        n = min(float(n), self.config.capacity)
        if self._tokens >= n:
            return 0.0
        return (n - self._tokens) / self.config.refill_per_s
