"""Seeded fault-injection harness (chaos mode).

The paper's variability section (§4.6, Table 5) and the shuffle-hardening
layer both exist because real serverless runs see invocation-tail
stragglers, throttled requests, and lost writes. This module injects those
faults deterministically so the adaptive execution layer
(``engine.adaptive``) can be tested and *gated* against them:

* **slow fragments** — a lognormal slowdown multiplier applied to a
  fragment's modeled duration (``StageScheduler`` consults the policy);
* **dropped shuffle writes** — a PUT is billed and believed written by the
  worker (its partition bitmap records it) but never lands in storage,
  exactly the lost-write case ``worker.ShuffleRegistry`` detects;
* **throttled requests** — a GET raises ``ThrottledError`` (HTTP 503
  analog) on its first attempt; the store's retry loop absorbs it;
* **killed fragments** — a fragment dies after writing a deterministic
  prefix of its shuffle partitions (``worker.WorkerKilled``); the
  attempt-scoped commit protocol quarantines the partial attempt;
* **OOM kills** — a fragment whose input working set crosses a
  chaos-chosen threshold is killed as if by the platform's memory cgroup;
  the recovery layer re-runs it with ``memory_budget=threshold`` so the
  retry takes the spill-aware out-of-core path (``engine/spill.py``);
* **failed invocations** — worker cold starts fail and are retried with
  capped backoff inside ``core.elastic_pool.ElasticPool`` (surfaced in
  pool stats);
* **unavailable tiers** — scoped requests raise ``UnavailableError``
  repeatedly, feeding the storage circuit breaker until it trips open.

Every decision is a pure function of ``(seed, identity)`` — the storage
key or the ``(stage, fragment, attempt)`` triple — hashed with
``zlib.crc32``, never Python's salted ``hash`` and never a shared RNG
stream. That makes the fault schedule independent of draw *order* and
stable across processes: an adaptive and a static execution of the same
query see the identical faults, so modeled-runtime comparisons (the
``adaptive_chaos`` benchmark's p99 gate) are fair and reproducible.

Wiring: assign a policy to ``ObjectStore.chaos`` / ``KVStore.chaos``
(drops + throttles) and pass it to the coordinator / ``StageScheduler``
(slowdowns). Drops and throttles apply only to keys under
``scope_prefix`` (default ``"shuffle/"``): base tables and collect
results are never corrupted, mirroring the paper's observation that the
*exchange* is where faults concentrate.
"""
from __future__ import annotations

import dataclasses
import math
import zlib


def _unit(seed: int, *parts) -> float:
    """Deterministic uniform(0, 1) from a seed and an identity tuple.

    CRC32 alone is GF(2)-affine: two identities differing in one byte
    map to outputs at a seed-independent XOR offset, so their threshold
    comparisons correlate across seeds (e.g. attempt 0 and attempt 1 of
    the same invocation would fail together at p=0.5 for every seed).
    The murmur3 finalizer provides full avalanche and destroys that
    structure while staying pure and cheap.
    """
    data = "|".join(str(p) for p in parts).encode()
    h = zlib.crc32(data, seed & 0xFFFFFFFF) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h / 2.0 ** 32


def _probit(p: float) -> float:
    # Local import avoids a cycle (storage_service imports nothing from
    # here, but keep the dependency one-way and explicit).
    from repro_torch.core.storage_service import _probit as probit
    return probit(min(max(p, 1e-9), 1.0 - 1e-9))


@dataclasses.dataclass
class ChaosPolicy:
    """Deterministic, seeded fault injection for one execution.

    ``slow_prob`` of fragments draw a lognormal slowdown multiplier
    (``exp(slow_mu + slow_sigma * z)``, clamped >= 1); ``drop_prob`` of
    first-attempt shuffle PUTs are silently lost (subsequent PUTs of the
    same key land — the fault is transient, so duplicate re-execution
    heals it); ``throttle_prob`` of first-attempt shuffle GETs raise
    ``ThrottledError`` (retries succeed). Injected-fault counters are
    kept for observability and assertions.
    """

    seed: int = 0
    slow_prob: float = 0.1
    slow_mu: float = 1.2            # log-mean of the slowdown multiplier
    slow_sigma: float = 0.4
    drop_prob: float = 0.05
    throttle_prob: float = 0.0
    # Process-level faults (the worker-failure fault domain).
    kill_prob: float = 0.0          # fragment crashes mid-shuffle-write
    oom_prob: float = 0.0           # fragment OOM-killed above a threshold
    oom_frac: tuple[float, float] = (0.4, 0.9)  # threshold / working set
    invoke_fail_prob: float = 0.0   # per-invocation cold-start failure
    unavailable_prob: float = 0.0   # scoped request raises UnavailableError
    unavailable_offers: int = 0     # max failing offers per key (0 = every)
    scope_prefix: str = "shuffle/"

    def __post_init__(self):
        self._offered_puts: set[str] = set()
        self._offered_gets: set[str] = set()
        self._offered_kills: set[tuple] = set()
        self._offered_ooms: set[tuple] = set()
        self._unavailable_seen: dict[str, int] = {}
        self.slows = 0
        self.drops = 0
        self.throttles = 0
        self.kills = 0
        self.ooms = 0
        self.invoke_fails = 0
        self.unavailables = 0

    # -- fragment slowdowns -------------------------------------------------
    def slow_multiplier(self, stage: str, fragment: int,
                        attempt: int = 0) -> float:
        """Slowdown multiplier for one fragment attempt (>= 1.0).

        Keyed by (stage, fragment, attempt): a speculative duplicate
        (attempt 1) draws independently of the original, so speculation
        can actually win the race.
        """
        if _unit(self.seed, "slow", stage, fragment, attempt) \
                >= self.slow_prob:
            return 1.0
        z = _probit(_unit(self.seed, "slowmag", stage, fragment, attempt))
        self.slows += 1
        return max(1.0, float(math.exp(self.slow_mu + self.slow_sigma * z)))

    # -- storage faults -----------------------------------------------------
    def drop_write(self, key: str) -> bool:
        """True iff this PUT should be silently lost. Only the FIRST put
        of a scoped key can drop — a re-put (duplicate execution, repair)
        always lands, modeling a transient loss."""
        if not key.startswith(self.scope_prefix):
            return False
        if key in self._offered_puts:
            return False
        self._offered_puts.add(key)
        if _unit(self.seed, "drop", key) < self.drop_prob:
            self.drops += 1
            return True
        return False

    def throttle(self, key: str, t: float = 0.0) -> bool:
        """True iff this GET should be rejected (503). First attempt per
        scoped key only; the store's retry policy absorbs it."""
        if not key.startswith(self.scope_prefix):
            return False
        if key in self._offered_gets:
            return False
        self._offered_gets.add(key)
        if _unit(self.seed, "throttle", key) < self.throttle_prob:
            self.throttles += 1
            return True
        return False

    # -- process faults -----------------------------------------------------
    def kill_after(self, stage: str, fragment: int, attempt: int,
                   partitions: int) -> int | None:
        """Number of shuffle partitions this fragment attempt writes before
        the worker dies, or None to survive.

        First-offer-only per (stage, fragment): the crash is transient, so
        any re-execution — a new attempt, a stage re-run, a speculative
        duplicate — is guaranteed to survive. The prefix length is itself a
        deterministic function of the identity, so static and adaptive
        executions of the same query see the identical partial write.
        """
        ident = (stage, fragment)
        if ident in self._offered_kills:
            return None
        self._offered_kills.add(ident)
        if _unit(self.seed, "kill", stage, fragment) >= self.kill_prob:
            return None
        self.kills += 1
        u = _unit(self.seed, "killpos", stage, fragment)
        return int(u * max(1, partitions))  # 0..partitions-1 written

    def oom_threshold(self, stage: str, fragment: int, attempt: int,
                      working_set_bytes: int) -> int | None:
        """Memory threshold (bytes) this fragment attempt OOMs above, or
        None. Fires when the fragment's unbudgeted working set crosses a
        chaos-chosen fraction of itself — the recovery layer re-runs the
        attempt with ``memory_budget=threshold`` so the retry spills
        instead of re-OOMing. First-offer-only per (stage, fragment)."""
        ident = (stage, fragment)
        if ident in self._offered_ooms:
            return None
        self._offered_ooms.add(ident)
        if _unit(self.seed, "oom", stage, fragment) >= self.oom_prob:
            return None
        lo, hi = self.oom_frac
        frac = lo + _unit(self.seed, "oomfrac", stage, fragment) * (hi - lo)
        threshold = max(64 * 1024, int(frac * working_set_bytes))
        if working_set_bytes <= threshold:
            return None  # working set fits under the chosen cgroup cap
        self.ooms += 1
        return threshold

    def invoke_fail(self, invoke_seq: int, attempt: int) -> bool:
        """True iff this worker invocation (cold start) fails. Keyed by
        (invocation sequence, retry attempt): each retry draws
        independently, so capped backoff eventually succeeds for any
        probability < 1."""
        if _unit(self.seed, "invoke", invoke_seq, attempt) \
                >= self.invoke_fail_prob:
            return False
        self.invoke_fails += 1
        return True

    def unavailable(self, key: str) -> bool:
        """True iff this request should raise ``UnavailableError`` (the
        tier is browning out). Per-key offer counting: with
        ``unavailable_offers=N`` the first N requests of a scoped key fail
        and later ones succeed (transient brownout); with 0 every scoped
        request fails (hard outage — only a circuit breaker plus tier
        demotion saves the query)."""
        if not key.startswith(self.scope_prefix):
            return False
        if self.unavailable_prob <= 0.0:
            return False
        seen = self._unavailable_seen.get(key, 0)
        if self.unavailable_offers and seen >= self.unavailable_offers:
            return False
        if _unit(self.seed, "unavail", key, seen) >= self.unavailable_prob:
            return False
        self._unavailable_seen[key] = seen + 1
        self.unavailables += 1
        return True

    def stats(self) -> dict:
        return {"slows": self.slows, "drops": self.drops,
                "throttles": self.throttles, "kills": self.kills,
                "ooms": self.ooms, "invoke_fails": self.invoke_fails,
                "unavailables": self.unavailables}
