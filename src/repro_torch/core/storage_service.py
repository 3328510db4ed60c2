"""Serverless storage service performance models + a functional object store.

Two layers:

1. *Performance models* calibrated to the paper's measurements (Figs 8-10):
   throughput scaling with client count, IOPS quotas, and request latency
   distributions for S3 Standard, S3 Express, DynamoDB, and EFS.

2. ``ObjectStore`` — a working in-memory/disk-backed object store with the
   S3 API shape (put/get/list/delete over string keys) used by the query
   engine for base tables and shuffles and by the checkpoint layer. Every
   request is metered (count + bytes, including failures/retries, mirroring
   the paper's client-hook accounting) and can be priced via
   ``core.pricing.storage_request_cost``. Optionally a
   ``PartitionModel`` throttles requests like real S3 prefix partitions.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Optional

import numpy as np

from repro_torch.core import pricing
from repro_torch.core.partition_scaling import PartitionModel

MIB = 1024.0 ** 2
GIB = 1024.0 ** 3


# ---------------------------------------------------------------------------
# 1) Calibrated performance models (Figs 8, 9, 10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServiceProfile:
    """Measured performance characteristics of one storage service."""

    name: str
    # Fig 8: aggregated throughput = min(linear-in-clients, ceiling); a
    # rejection threshold models DynamoDB/EFS collapse under contention.
    read_bw_per_client: float          # bytes/s contributed per client VM
    write_bw_per_client: float
    read_bw_ceiling: float             # bytes/s
    write_bw_ceiling: float
    max_clients: Optional[int]         # requests rejected beyond this
    # Fig 9: operations per second (1 KiB requests, fresh containers).
    read_iops: float
    write_iops: float
    iops_shards: bool                  # whether extra containers double IOPS
    # Fig 10: latency quantiles in seconds (median, p95, max) for 1 KiB.
    read_latency_q: tuple[float, float, float]
    write_latency_q: tuple[float, float, float]


S3_STANDARD_PROFILE = ServiceProfile(
    "s3-standard",
    read_bw_per_client=2.0 * GIB, write_bw_per_client=1.6 * GIB,
    read_bw_ceiling=250.0 * GIB, write_bw_ceiling=250.0 * GIB,
    max_clients=None,
    read_iops=8000.0, write_iops=4000.0, iops_shards=True,
    read_latency_q=(0.027, 0.075, 10.1),
    write_latency_q=(0.040, 0.110, 12.0))

S3_EXPRESS_PROFILE = ServiceProfile(
    "s3-express",
    read_bw_per_client=2.0 * GIB, write_bw_per_client=2.0 * GIB,
    read_bw_ceiling=250.0 * GIB, write_bw_ceiling=250.0 * GIB,
    max_clients=None,
    read_iops=220000.0, write_iops=42000.0, iops_shards=False,
    read_latency_q=(0.005, 0.006, 0.28),
    write_latency_q=(0.006, 0.008, 0.35))

DYNAMODB_PROFILE = ServiceProfile(
    "dynamodb",
    read_bw_per_client=380.0 * MIB, write_bw_per_client=30.0 * MIB,
    read_bw_ceiling=380.0 * MIB, write_bw_ceiling=30.0 * MIB,
    max_clients=16,
    read_iops=16000.0, write_iops=9600.0, iops_shards=False,
    read_latency_q=(0.004, 0.009, 0.95),
    write_latency_q=(0.005, 0.012, 1.10))

EFS_PROFILE = ServiceProfile(
    "efs",
    read_bw_per_client=320.0 * MIB, write_bw_per_client=80.0 * MIB,
    read_bw_ceiling=20.0 * GIB, write_bw_ceiling=5.0 * GIB,
    max_clients=64,
    read_iops=20000.0, write_iops=2500.0, iops_shards=True,
    read_latency_q=(0.005, 0.008, 0.30),
    write_latency_q=(0.012, 0.022, 0.60))

# Memory-grade KV exchange tier (ElastiCache/Momento-class): sub-millisecond
# request latencies with a tight tail, per-client bandwidth comparable to S3
# so byte-heavy shuffles gain nothing — only the per-request fixed latency
# shrinks. Paired with ``pricing.KV_MEMORY`` (per-request + per-GiB-hour rent).
KV_MEMORY_PROFILE = ServiceProfile(
    "kv-memory",
    read_bw_per_client=2.0 * GIB, write_bw_per_client=2.0 * GIB,
    read_bw_ceiling=100.0 * GIB, write_bw_ceiling=100.0 * GIB,
    max_clients=None,
    read_iops=250000.0, write_iops=200000.0, iops_shards=False,
    read_latency_q=(0.0004, 0.0012, 0.050),
    write_latency_q=(0.0005, 0.0015, 0.060))

PROFILES = {p.name: p for p in [
    S3_STANDARD_PROFILE, S3_EXPRESS_PROFILE, DYNAMODB_PROFILE, EFS_PROFILE,
    KV_MEMORY_PROFILE]}


def aggregated_throughput(profile: ServiceProfile, clients: int,
                          read: bool = True) -> float:
    """Fig 8: expected aggregate bytes/s for ``clients`` loader VMs."""
    if profile.max_clients is not None and clients > profile.max_clients:
        # Requests get throttled / time out under contention; effective
        # goodput collapses back to the ceiling served to early clients.
        clients = profile.max_clients
    per = profile.read_bw_per_client if read else profile.write_bw_per_client
    cap = profile.read_bw_ceiling if read else profile.write_bw_ceiling
    return min(per * clients, cap)


def iops(profile: ServiceProfile, containers: int = 1, read: bool = True) -> float:
    """Fig 9: ops/s; sharding over containers only helps some services."""
    base = profile.read_iops if read else profile.write_iops
    if profile.iops_shards and containers > 1:
        # EFS read IOPS double via two filesystems but do not scale further
        # (paper 4.3.2); S3 scales per-prefix (see partition_scaling).
        return base * min(containers, 2)
    return base


class LatencyModel:
    """Lognormal body + Pareto tail fitted to (median, p95, max) quantiles."""

    def __init__(self, quantiles: tuple[float, float, float],
                 tail_fraction: float = 0.005):
        med, p95, mx = quantiles
        self.mu = math.log(med)
        # p95 of lognormal: exp(mu + 1.645 sigma)
        self.sigma = max(1e-6, (math.log(p95) - self.mu) / 1.645)
        self.tail_fraction = tail_fraction
        self.p95 = p95
        self.max_latency = mx
        # Pareto over [p95, max]: choose alpha so that the max-of-N draw with
        # N ~ 1e6 * tail_fraction lands near the observed maximum.
        n_tail = 1e6 * tail_fraction
        self.alpha = max(0.6, math.log(n_tail) / max(1e-9, math.log(mx / p95)))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        body = rng.lognormal(self.mu, self.sigma, size=n)
        tail_mask = rng.random(n) < self.tail_fraction
        u = rng.random(n)
        tail = self.p95 * (1.0 - u) ** (-1.0 / self.alpha)
        out = np.where(tail_mask, np.minimum(tail, self.max_latency), body)
        return out

    def quantile(self, q: float) -> float:
        from math import erf, sqrt
        # Invert the body lognormal (tail ignored below ~p99).
        # scipy-free probit via Acklam-lite approximation:
        z = _probit(q)
        return math.exp(self.mu + self.sigma * z)


def _probit(p: float) -> float:
    # Beasley-Springer-Moro approximation of the inverse normal CDF.
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= phigh:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = math.sqrt(-2 * math.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
        ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


# ---------------------------------------------------------------------------
# 2) Functional object store (S3 API shape) with request metering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestStats:
    reads: int = 0
    writes: int = 0
    lists: int = 0
    deletes: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    throttled: int = 0
    retried: int = 0

    def merge(self, other: "RequestStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def cost(self, prices=pricing.S3_STANDARD,
             capacity_gib_s: float = 0.0) -> float:
        # Failures and retries are billed too (the paper's client hook counts
        # them); throttled requests are charged as reads conservatively.
        # ``capacity_gib_s`` adds residency rent (GiB x seconds resident) for
        # tiers billed per GiB-hour, e.g. the memory KV exchange tier.
        usd = pricing.storage_request_cost(
            prices, self.reads + self.throttled + self.lists,
            self.writes, self.read_bytes, self.write_bytes)
        if capacity_gib_s:
            usd += pricing.storage_capacity_cost(
                prices, 1.0, capacity_gib_s / 3600.0)
        return usd


class ThrottledError(RuntimeError):
    """Raised when the partition model rejects a request (HTTP 503 analog)."""


class UnavailableError(RuntimeError):
    """Raised when a tier browns out (HTTP 500/503 storm analog).

    Retryable — a backoff loop may succeed — but unlike ``ThrottledError``
    it also feeds the tier's circuit breaker: enough of these in a row and
    the breaker trips open, converting further requests into fast-failing
    ``CircuitOpenError`` so callers stop camping on backoff."""


class CircuitOpenError(RuntimeError):
    """Fast-fail raised while a tier's circuit breaker is open. Terminal:
    retrying the same tier cannot help; callers should re-place the work
    on a healthy tier (the adaptive boundary demotes KV shuffles to the
    object store)."""


class CircuitBreaker:
    """Classic three-state breaker over a storage tier.

    * ``closed`` — requests flow; ``failure_threshold`` *consecutive*
      ``UnavailableError``s trip it open.
    * ``open`` — every request fast-fails with ``CircuitOpenError`` (no
      latency, no billed request) until ``reset_timeout_s`` of model time
      passes.
    * ``half_open`` — one probe request is let through; success closes the
      breaker, failure re-opens it immediately.

    Only ``UnavailableError`` counts as a breaker failure: throttles are
    the partition model doing its job and missing keys are the caller's
    problem, neither says the tier is down.
    """

    def __init__(self, failure_threshold: int = 4,
                 reset_timeout_s: float = 30.0):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self.failures = 0
        self.trips = 0
        self.fast_fails = 0
        self.probes = 0

    def allow(self, t: float) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open" and \
                t - self._opened_at >= self.reset_timeout_s:
            self.state = "half_open"
            self.probes += 1
            return True
        self.fast_fails += 1
        return False

    def record_success(self) -> None:
        self._consecutive = 0
        if self.state == "half_open":
            self.state = "closed"

    def record_failure(self, t: float) -> None:
        self.failures += 1
        self._consecutive += 1
        if self.state == "half_open" or \
                self._consecutive >= self.failure_threshold:
            if self.state != "open":
                self.trips += 1
            self.state = "open"
            self._opened_at = t

    def stats(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "trips": self.trips, "fast_fails": self.fast_fails,
                "probes": self.probes}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + full jitter (paper cites Brooker [53]).

    Factored out of ``ObjectStore.retrying_get`` so each exchange tier gets
    its own profile: the object store tolerates multi-second 503 storms, the
    memory KV tier has sub-millisecond medians so waiting 50 ms between
    attempts would cost more than the request itself.
    """

    max_attempts: int = 6
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 5.0

    def backoff_s(self, attempt: int) -> float:
        return min(self.backoff_base_s * (2 ** attempt), self.backoff_cap_s)

    def is_retryable(self, exc: BaseException) -> bool:
        """Classify an error: retryable (transient — throttles, brownouts)
        vs terminal (missing key, open circuit breaker). Terminal errors
        must fail fast instead of burning the full backoff schedule."""
        return isinstance(exc, (ThrottledError, UnavailableError))


OBJECT_RETRY = RetryPolicy(max_attempts=6, backoff_base_s=0.05,
                           backoff_cap_s=5.0)
# The KV tier fails fast: tighter cap, fewer attempts — a throttled memory
# store stays throttled; callers should respill to the object tier instead
# of camping on backoff.
KV_RETRY = RetryPolicy(max_attempts=4, backoff_base_s=0.005,
                       backoff_cap_s=0.25)


class ObjectStore:
    """In-memory object store with optional partition-quota throttling.

    Thread-safe; used concurrently by query-engine workers. ``clock`` supplies
    simulated time for the partition model (defaults to a step counter).
    """

    tier = "object"

    def __init__(self, partition_model: Optional[PartitionModel] = None,
                 clock: Optional[Callable[[], float]] = None,
                 chaos=None):
        self._objects: dict[str, bytes] = {}
        self._etags: dict[str, int] = {}
        self._put_seq = 0
        self._lock = threading.Lock()
        self.stats = RequestStats()
        self.partitions = partition_model
        self._clock = clock or (lambda: 0.0)
        self.profile = S3_STANDARD_PROFILE
        self.prices = pricing.S3_STANDARD
        self.retry = OBJECT_RETRY
        # Optional fault injection (core.chaos.ChaosPolicy); assignable
        # after construction so a shared store can be perturbed per run.
        self.chaos = chaos
        # Optional circuit breaker over this tier (the KV tier ships one
        # by default). ``None`` means requests never fast-fail.
        self.breaker: Optional[CircuitBreaker] = None

    # -- fault gate ---------------------------------------------------------
    def _guard(self, key: str) -> None:
        """Breaker fast-fail + injected brownouts, before the request."""
        if self.breaker is not None and not self.breaker.allow(self._clock()):
            raise CircuitOpenError(key)
        if self.chaos is not None and self.chaos.unavailable(key):
            if self.breaker is not None:
                self.breaker.record_failure(self._clock())
            with self._lock:
                self.stats.throttled += 1  # billed like any failed request
            raise UnavailableError(key)
        if self.breaker is not None:
            self.breaker.record_success()

    # -- S3-shaped API ------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        self._guard(key)
        self._admit(key, write=True, nbytes=len(data))
        if self.chaos is not None and self.chaos.drop_write(key):
            # Lost write: billed and acknowledged to the caller (its
            # partition bitmap will claim the object exists) but never
            # stored — the fault the shuffle-hardening layer detects.
            with self._lock:
                self.stats.writes += 1
                self.stats.write_bytes += len(data)
            return
        with self._lock:
            self._objects[key] = bytes(data)
            self._put_seq += 1
            self._etags[key] = self._put_seq
            self.stats.writes += 1
            self.stats.write_bytes += len(data)

    def etag(self, key: str) -> int:
        """Monotonic per-store version of the object at ``key`` (S3 ETag
        analog): changes on every overwrite, so caches can validate that
        an input is byte-identical without re-reading it. Raises KeyError
        for missing objects."""
        with self._lock:
            if key not in self._etags:
                raise KeyError(key)
            return self._etags[key]

    def get(self, key: str, byte_range: Optional[tuple[int, int]] = None) -> bytes:
        self._guard(key)
        if self.chaos is not None and self.chaos.throttle(key, self._clock()):
            with self._lock:
                self.stats.throttled += 1
            raise ThrottledError(key)
        with self._lock:
            if key not in self._objects:
                # A GET on a missing key is still a billed request with
                # real latency (S3 404) — shuffle readers probing
                # skipped-empty partitions must pay for the probe.
                self.stats.reads += 1
                raise KeyError(key)
            data = self._objects[key]
        self._admit(key, write=False, nbytes=len(data))
        if byte_range is not None:
            lo, hi = byte_range
            data = data[lo:hi]
        with self._lock:
            self.stats.reads += 1
            self.stats.read_bytes += len(data)
        return data

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            self.stats.lists += 1
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)
            self._etags.pop(key, None)
            self.stats.deletes += 1

    def size(self, key: str) -> int:
        with self._lock:
            return len(self._objects[key])

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())

    # -- admission ----------------------------------------------------------
    def _admit(self, key: str, write: bool, nbytes: int) -> None:
        if self.partitions is None:
            return
        ok = self.partitions.offer(self._clock(), write=write)
        if not ok:
            with self._lock:
                self.stats.throttled += 1
            raise ThrottledError(key)

    def retrying_get(self, key: str, max_attempts: Optional[int] = None,
                     backoff_base_s: Optional[float] = None,
                     sleep: Callable[[float], None] = lambda s: None) -> bytes:
        """Get with capped exponential backoff + full jitter (paper cites
        Brooker [53]; the engine's stragglers come from exactly this loop).

        Defaults come from the store's ``retry`` policy, so the KV tier
        retries on its own (much tighter) schedule; explicit arguments
        still override per call.
        """
        policy = self.retry
        if max_attempts is not None or backoff_base_s is not None:
            policy = dataclasses.replace(
                policy,
                max_attempts=(max_attempts if max_attempts is not None
                              else policy.max_attempts),
                backoff_base_s=(backoff_base_s if backoff_base_s is not None
                                else policy.backoff_base_s))
        attempt = 0
        while True:
            try:
                return self.get(key)
            except (ThrottledError, UnavailableError, CircuitOpenError,
                    KeyError) as exc:
                if not policy.is_retryable(exc):
                    # Terminal: a missing key after a confirmed commit or
                    # an open breaker won't heal by waiting — fail fast
                    # instead of burning the full backoff schedule.
                    raise
                attempt += 1
                if attempt >= policy.max_attempts:
                    raise
                with self._lock:
                    self.stats.retried += 1
                sleep(policy.backoff_s(attempt))


class KVStore(ObjectStore):
    """Memory-grade KV exchange tier (the fast-but-expensive shuffle path).

    Same S3-shaped API and request metering as ``ObjectStore`` — workers are
    tier-agnostic — but carries the ``kv-memory`` performance profile,
    per-request + per-GiB-hour pricing (``pricing.KV_MEMORY``) and a
    fail-fast retry policy. The coordinator's runtime model and the
    optimizer's break-even placement (``core.breakeven.place_exchange``)
    read those attributes rather than hard-coding tier constants.
    """

    tier = "kv"

    def __init__(self, partition_model: Optional[PartitionModel] = None,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(partition_model, clock)
        self.profile = KV_MEMORY_PROFILE
        self.prices = pricing.KV_MEMORY
        self.retry = KV_RETRY
        # The memory tier is the one that browns out under contention in
        # the paper's measurements — it ships with a breaker so a dark
        # tier degrades to fast CircuitOpenError + object-store demotion
        # instead of stalling every request on the backoff schedule.
        self.breaker = CircuitBreaker()


def copy_objects(src, dst, prefix: str = "tables/") -> list[str]:
    """Copy every object under ``prefix`` from ``src`` into ``dst`` byte
    for byte; returns the copied keys. Duck-typed on ``list``/``get``/
    ``put``, so ``src`` may be any store with that API — e.g. the
    reference package's ``ObjectStore``, so that both engines read the
    very same bytes."""
    keys = list(src.list(prefix))
    for key in keys:
        dst.put(key, bytes(src.get(key)))
    return keys
