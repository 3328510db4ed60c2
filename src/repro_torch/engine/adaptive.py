"""Adaptive query execution: every stage boundary is a re-optimization
point (Skyrise-style adaptivity over the paper's §3.2 coordinator).

The static ``Coordinator`` compiles a whole plan up front and schedules
it; cardinality misestimates are locked in before the first byte moves.
``AdaptiveCoordinator`` instead drives the plan stage-at-a-time and, at
each boundary, revises the not-yet-run suffix against what the finished
stages *actually* produced:

  * **fan-out / tier re-derivation** — the next shuffle's partition count
    is re-derived from observed producer bytes (``optimizer.derive_fanout``,
    the same rule lowering used on estimates) and its exchange tier is
    re-placed through the measured break-even model
    (``breakeven.place_exchange_from_bench``);
  * **build-side flip** — when the observed build input of a shuffle join
    turns out larger than the probe side, the sides swap and a
    key-restoring rename projection keeps the downstream schema intact;
  * **elided-join demotion** — a join whose shuffle was elided because a
    base table *declared* a hash-partitioned layout is probed with the
    summarized runtime check (``worker.partition_class_bitmap``); a lying
    layout gets an explicit repartition scan injected instead of the
    fail-loud abort the static path hits.

Every decision is appended to the result's ``adaptive_trace`` as an
``adaptive:`` line (rendered by ``engine.explain``) and counted in
``QueryResult.replans``.

Straggler speculation replaces the static size-based timeout: a fragment
whose modeled duration crosses the *expected max-of-m barrier* from the
paper's Table 5 lognormal tail model (``variability.cov_sigma``) gets a
duplicate launched. Duplicates are provably idempotent — fragment
execution is deterministic, so the duplicate re-puts byte-identical
shuffle objects under identical keys and re-records the same partition
bitmap in ``worker.ShuffleRegistry``; first writer wins and nothing
downstream can tell which copy it read.

Fault recovery differs by policy: ``repair="targeted"`` (adaptive)
audits producer bitmaps against storage at the boundary and re-executes
only the writer fragments whose objects are missing; ``repair="stage"``
(the static baseline) discovers the loss when a consumer read fails and
re-executes every producer stage in full. Under ``core.chaos`` injection
the gap between the two is what the ``adaptive_chaos`` bench gates at
p99.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

from repro_torch.core import breakeven, storage_service, variability
from repro_torch.core.scheduler import Stage, StageResult, StageScheduler, \
    StragglerPolicy
from repro_torch.engine import columnar, logical, optimizer, worker
from repro_torch.engine import compile as engine_compile
from repro_torch.engine import plans as plans_mod
from repro_torch.engine.coordinator import Coordinator, QueryResult
from repro_torch.engine.plans import (Pipeline, QueryPlan, ShuffleInput,
                                ShuffleOutput, TableInput)


def expected_max_multiplier(m: int, cov_percent: float,
                            safety: float = 1.2) -> float:
    """Barrier multiplier for speculation: the expected max of ``m``
    concurrent lognormal draws at the given runtime CoV sits near the
    m/(m+1) quantile, ``exp(sigma * probit(m/(m+1)))`` relative to the
    median. A fragment slower than ``safety`` times that is beyond what
    the tail model explains — duplicate it. Small stages still use the
    m=4 quantile so a lone fragment's ordinary noise never speculates."""
    sigma = variability.cov_sigma(cov_percent)
    m = max(int(m), 4)
    q = m / (m + 1.0)
    return safety * math.exp(sigma * storage_service._probit(q))


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """Which boundary revisions the adaptive executor may take.

    ``ADAPTIVE`` enables everything with targeted fault repair;
    ``STATIC`` disables every revision and repairs by coarse lineage
    re-execution — the honest model of the static coordinator under
    faults, and the baseline the chaos bench compares against."""

    replan_fanout: bool = True
    replan_tier: bool = True
    flip_build: bool = True
    demote_elided: bool = True
    speculate: bool = True
    repair: str = "targeted"            # "targeted" | "stage"
    flip_factor: float = 1.1            # observed build/probe ratio to flip
    # Paper Table 5, us-east-1 cold-suite CoV: the tail model the
    # speculation barrier is derived from.
    barrier_cov_percent: float = 22.65
    barrier_safety: float = 1.2
    max_recover_attempts: int = 2
    # Lineage recovery: how many times ONE fragment may be re-attempted
    # in place after a worker kill/OOM before the failure escalates to a
    # stage re-run (and then, past ``max_recover_attempts``, to a
    # structured query-level failure). The static baseline has no
    # in-place retry — every kill costs it a stage re-run.
    max_fragment_attempts: int = 3
    # Cap on speculative duplicates per stage (None = unlimited); denied
    # launches surface as ``speculative_denied`` in pool stats.
    max_speculative: Optional[int] = None


ADAPTIVE = AdaptivePolicy()
STATIC = AdaptivePolicy(replan_fanout=False, replan_tier=False,
                        flip_build=False, demote_elided=False,
                        speculate=False, repair="stage")


class SpeculativeStageScheduler(StageScheduler):
    """Stage scheduler whose straggler mitigation is model-driven
    speculation: instead of the static size-based timeout, a fragment
    that crosses the lognormal expected-max barrier launches a REAL
    duplicate execution (``frag.work()`` again). Duplicate re-puts are
    byte-identical under identical keys, so first writer wins through
    the shuffle registry's partition bitmaps; the fragment completes at
    whichever copy finishes first in model time."""

    def __init__(self, pool, policy: StragglerPolicy = StragglerPolicy(),
                 straggler_prob: float = 0.02, rng_seed: int = 0,
                 chaos=None, barrier_cov_percent: float = 22.65,
                 barrier_safety: float = 1.2,
                 max_fragment_attempts: int = 3,
                 max_speculative: Optional[int] = None):
        super().__init__(pool, policy, straggler_prob, rng_seed, chaos=chaos)
        self.barrier_cov_percent = barrier_cov_percent
        self.barrier_safety = barrier_safety
        self.max_fragment_attempts = max_fragment_attempts
        self.max_speculative = max_speculative
        # Recovery trace sink: the adaptive coordinator points this at the
        # current query's trace list so ``recover:`` lines reach explain.
        self.trace: Optional[list] = None

    def _run_stage(self, stage: Stage, t: float) -> StageResult:
        n = len(stage.fragments)
        workers = self.pool.acquire(n, t)
        results: list[object] = [None] * n
        end = t
        launched = won = recovered = 0
        node_seconds = 0.0
        mult = expected_max_multiplier(n, self.barrier_cov_percent,
                                       self.barrier_safety)
        try:
            for i, (frag, w) in enumerate(zip(stage.fragments, workers)):
                start = w.ready_at
                attempt = 0
                # Lineage recovery, in place: a killed attempt is charged
                # its modeled duration, then ONLY the dead attempt re-runs
                # under a new attempt number (an OOM kill re-runs with the
                # chaos threshold as its memory budget, so the retry takes
                # the spill path). Past the attempt budget the kill
                # escalates to the coordinator's stage-level ladder.
                while True:
                    try:
                        if attempt == 0 or frag.rerun is None:
                            results[i] = frag.work()
                        else:
                            results[i] = frag.rerun(**rerun_kwargs)
                        break
                    except worker.WorkerKilled as exc:
                        dead = self._noisy_duration(frag.est_duration_s)
                        if self.chaos is not None:
                            dead *= self.chaos.slow_multiplier(
                                stage.name, frag.fragment_id,
                                attempt=attempt)
                        node_seconds += dead
                        start += dead
                        end = max(end, start)
                        attempt += 1
                        if frag.rerun is None or \
                                attempt >= self.max_fragment_attempts:
                            raise
                        recovered += 1
                        rerun_kwargs = {"attempt": attempt}
                        if isinstance(exc, worker.WorkerOOMKilled):
                            rerun_kwargs["memory_budget"] = \
                                float(exc.threshold_bytes)
                        if self.trace is not None:
                            how = ("with a "
                                   f"{exc.threshold_bytes / 2**20:.1f} "
                                   "MiB spill budget"
                                   if isinstance(exc,
                                                 worker.WorkerOOMKilled)
                                   else "under a fresh attempt key")
                            self.trace.append(
                                f"recover: fragment {frag.fragment_id} of "
                                f"'{stage.name}' killed ({exc.kind}, "
                                f"attempt {attempt - 1}); re-ran only the "
                                f"dead attempt {how}")
                dur = self._noisy_duration(frag.est_duration_s)
                if self.chaos is not None:
                    dur *= self.chaos.slow_multiplier(stage.name,
                                                      frag.fragment_id,
                                                      attempt=attempt)
                completion = start + dur
                node_seconds += dur
                barrier = frag.est_duration_s * mult
                if frag.est_duration_s > 0 and dur > barrier:
                    if self.max_speculative is not None \
                            and launched >= self.max_speculative:
                        self.pool.stats["speculative_denied"] = \
                            self.pool.stats.get("speculative_denied", 0) + 1
                    else:
                        # Beyond the expected max of n draws: duplicate
                        # the fragment for real (idempotent; see class
                        # docstring) and race it against the original.
                        launched += 1
                        frag.work()
                        dup = self._noisy_duration(frag.est_duration_s)
                        if self.chaos is not None:
                            # The duplicate is a fresh invocation: it
                            # draws its own chaos slowdown (attempt-
                            # keyed), independent of whatever slowed the
                            # original.
                            dup *= self.chaos.slow_multiplier(
                                stage.name, frag.fragment_id,
                                attempt=attempt + 1)
                        dup_completion = start + barrier + dup
                        node_seconds += min(dup, max(0.0, dur - barrier))
                        if dup_completion < completion:
                            completion = dup_completion
                            won += 1
                end = max(end, completion)
        except Exception as exc:
            # Escalation: charge what ran, release the fleet, surface the
            # elapsed model time for the stage-level recovery ladder.
            elapsed_end = max(end, t)
            self.pool.release(workers, elapsed_end,
                              busy_s=node_seconds / max(n, 1))
            exc.elapsed_s = max(0.0, elapsed_end - t)
            exc.node_seconds = node_seconds
            raise
        self.pool.release(workers, end, busy_s=node_seconds / max(n, 1))
        return StageResult(stage.name, t, end, n, results,
                           retried_fragments=launched,
                           node_seconds=node_seconds,
                           speculative_launched=launched,
                           speculative_won=won,
                           recovered_attempts=recovered)


class AdaptiveCoordinator(Coordinator):
    """Coordinator that executes stage-at-a-time, revising the plan
    suffix at every stage boundary (module docstring). ``policy=STATIC``
    turns every revision off and degrades fault repair to full lineage
    re-execution — the chaos bench's baseline — while keeping the
    identical compile/schedule path, so the two variants differ only in
    the adaptive decisions themselves."""

    def __init__(self, store, policy: AdaptivePolicy = ADAPTIVE,
                 rng_seed: int = 0, chaos=None, **kw):
        super().__init__(store, rng_seed=rng_seed, chaos=chaos, **kw)
        self.policy = policy
        if policy.speculate:
            self.scheduler = SpeculativeStageScheduler(
                self.pool, StragglerPolicy(), rng_seed=rng_seed,
                chaos=chaos,
                barrier_cov_percent=policy.barrier_cov_percent,
                barrier_safety=policy.barrier_safety,
                max_fragment_attempts=policy.max_fragment_attempts,
                max_speculative=policy.max_speculative)

    # ------------------------------------------------------------------
    def execute(self, plan: QueryPlan, query_id: Optional[str] = None
                ) -> QueryResult:
        plan.validate()
        query_id = query_id or plan.name
        plan = copy.deepcopy(plan)    # boundary revisions mutate the plan
        shape_hash, cache_hit = "", False
        if self.backend == "torch":
            shape_hash, cache_hit = engine_compile.PLAN_CACHE.lookup(plan)
        stats_before = dataclasses.replace(self.store.stats)
        kv_stats_before = dataclasses.replace(self.kv_store.stats)
        registry = worker.ShuffleRegistry()
        frag_counts: dict[str, int] = {}
        shuffle_spec: dict[str, int] = {}
        tier_spec: dict[str, str] = {}
        stages: dict[str, Stage] = {}
        results: dict[str, StageResult] = {}
        trace: list[str] = []
        # Injected repartition scans have no plan deps; they still cannot
        # start before the boundary at which demotion was decided.
        min_start: dict[str, float] = {}
        self._replan_count = 0
        if hasattr(self.scheduler, "trace"):
            self.scheduler.trace = trace
        idx = 0
        while idx < len(plan.pipelines):
            pipe = plan.pipelines[idx]
            boundary_t = max([0.0] + [results[d].end_t
                                      for d in pipe.deps() if d in results])
            # --- the stage boundary: re-optimization point -------------
            self._replan(plan, idx, query_id, registry, frag_counts,
                         shuffle_spec, tier_spec, results, trace)
            if plan.pipelines[idx] is not pipe:    # demotion inserted a scan
                pipe = plan.pipelines[idx]
                min_start[pipe.name] = boundary_t
            repair_dur = 0.0
            if self.policy.repair == "targeted":
                repair_dur = self._repair_lost(pipe, query_id, registry,
                                               frag_counts, tier_spec,
                                               stages, results, trace)
            stage = self._compile_pipeline(plan, pipe, query_id, registry,
                                           frag_counts, shuffle_spec,
                                           tier_spec)
            stages[pipe.name] = stage
            start = max([min_start.get(pipe.name, 0.0)] +
                        [results[d].end_t for d in stage.deps]) + repair_dur
            results[pipe.name] = self._run_with_recovery(
                plan, pipe, stage, start, stages, results, trace,
                query_id=query_id, registry=registry,
                frag_counts=frag_counts, shuffle_spec=shuffle_spec,
                tier_spec=tier_spec)
            idx += 1
        return self.finalize(plan, query_id, frag_counts, results,
                             stats_before, shape_hash, cache_hit,
                             kv_stats_before=kv_stats_before,
                             adaptive_trace=trace,
                             replans=self._replan_count)

    # -- fault recovery -------------------------------------------------
    def _run_with_recovery(self, plan: QueryPlan, pipe: Pipeline,
                           stage: Stage, start: float,
                           stages: dict[str, Stage],
                           results: dict[str, StageResult],
                           trace: list[str], *, query_id: str,
                           registry: worker.ShuffleRegistry,
                           frag_counts: dict[str, int],
                           shuffle_spec: dict[str, int],
                           tier_spec: dict[str, str]) -> StageResult:
        """Stage-level rung of the recovery ladder (above the in-place
        attempt retries of ``SpeculativeStageScheduler``, below the
        structured query failure):

        * **worker kill / OOM / failed invocation** — the stage's objects
          are intact (a killed attempt never commits), so only the stage
          itself re-runs;
        * **store brownout** (``UnavailableError`` / an open circuit
          breaker) — every kv exchange this stage touches (its own output
          and its deps') is demoted to the object store, the affected
          producers re-run under the demoted placement, and the stage is
          recompiled before the retry — brownout, not outage;
        * **anything else** (a lost shuffle write surfacing at read time)
          — coarse lineage recovery: every producer stage re-executes in
          full, then the stage retries.

        Past ``policy.max_recover_attempts`` the failure surfaces as a
        ``QueryFailedError`` carrying a structured failure record."""
        from repro_torch.engine.coordinator import QueryFailedError
        attempts = 0
        while True:
            try:
                return self.scheduler.run_stage(stage, start)
            except RuntimeError as exc:
                attempts += 1
                start += getattr(exc, "elapsed_s", 0.0)
                if attempts > self.policy.max_recover_attempts:
                    raise QueryFailedError(query_id, stage.name, attempts,
                                           exc) from exc
                if isinstance(exc, (storage_service.UnavailableError,
                                    storage_service.CircuitOpenError)):
                    demoted = self._demote_kv_exchanges(
                        plan, pipe, stage, start, stages, results,
                        query_id=query_id, registry=registry,
                        frag_counts=frag_counts,
                        shuffle_spec=shuffle_spec, tier_spec=tier_spec)
                    if demoted:
                        stage = self._compile_pipeline(
                            plan, pipe, query_id, registry, frag_counts,
                            shuffle_spec, tier_spec)
                        stages[pipe.name] = stage
                        self._replan_count += 1
                        trace.append(
                            f"recover: kv exchange browned out under "
                            f"stage '{stage.name}'; demoted "
                            f"{demoted} shuffle placement(s) to the "
                            "object store and retried")
                        continue
                if isinstance(exc, worker.WorkerKilled) or not stage.deps:
                    # The dead attempt never committed: inputs are
                    # intact, so only this stage re-runs.
                    trace.append(
                        f"recover: stage '{stage.name}' lost a worker "
                        f"({getattr(exc, 'kind', 'crash')}); re-ran the "
                        f"stage (attempt {attempts + 1})")
                    continue
                # Coarse lineage recovery (the static baseline): the
                # failed read cannot name which producer fragment lost a
                # write, so every producer stage re-executes in full
                # before the retry.
                rec_end = start
                for dep in stage.deps:
                    rres = self.scheduler.run_stage(stages[dep], start)
                    prev = results[dep]
                    prev.node_seconds += rres.node_seconds
                    prev.retried_fragments += rres.worker_count
                    rec_end = max(rec_end, rres.end_t)
                trace.append(
                    f"recovery: stage '{stage.name}' hit a lost shuffle "
                    f"write; re-executed producer stage(s) "
                    f"{list(stage.deps)} in full and retried ({exc})")
                start = rec_end

    def _demote_kv_exchanges(self, plan: QueryPlan, pipe: Pipeline,
                             stage: Stage, start: float,
                             stages: dict[str, Stage],
                             results: dict[str, StageResult], *,
                             query_id: str,
                             registry: worker.ShuffleRegistry,
                             frag_counts: dict[str, int],
                             shuffle_spec: dict[str, int],
                             tier_spec: dict[str, str]) -> int:
        """Move every kv exchange the failed stage touches onto the
        object store: the stage's own output placement flips, and any dep
        whose shuffle lives on the dark tier is re-produced under the
        demoted placement (idempotent re-execution, commits unchanged).
        Returns the number of demoted placements."""
        demoted = 0
        if isinstance(pipe.output, ShuffleOutput) \
                and pipe.output.tier == "kv":
            pipe.output.tier = "object"
            tier_spec[pipe.name] = "object"
            demoted += 1
        for dep in stage.deps:
            if tier_spec.get(dep) != "kv" or dep not in stages:
                continue
            dep_pipe = next(p for p in plan.pipelines if p.name == dep)
            if isinstance(dep_pipe.output, ShuffleOutput):
                dep_pipe.output.tier = "object"
            tier_spec[dep] = "object"
            dep_stage = self._compile_pipeline(plan, dep_pipe, query_id,
                                               registry, frag_counts,
                                               shuffle_spec, tier_spec)
            stages[dep] = dep_stage
            rres = self.scheduler.run_stage(dep_stage, start)
            prev = results[dep]
            prev.node_seconds += rres.node_seconds
            prev.retried_fragments += rres.worker_count
            prev.end_t = max(prev.end_t, rres.end_t)
            demoted += 1
        return demoted

    def _repair_lost(self, pipe: Pipeline, query_id: str,
                     registry: worker.ShuffleRegistry,
                     frag_counts: dict[str, int],
                     tier_spec: dict[str, str],
                     stages: dict[str, Stage],
                     results: dict[str, StageResult],
                     trace: list[str]) -> float:
        """Targeted repair: audit each producer's partition bitmap
        against storage before its consumer compiles; re-execute only the
        writer fragments whose recorded objects are missing. Duplicate
        re-execution is idempotent (deterministic byte-identical re-puts),
        so a healthy writer re-run is harmless and a lost one is healed.
        Returns the model-time delay the repair adds before the consumer
        can start."""
        repair_dur = 0.0
        for dep in pipe.deps():
            if dep not in stages:
                continue
            st = self._tier_store(tier_spec.get(dep, "object"))
            lost = []
            for w in range(frag_counts[dep]):
                bm = registry.bitmap(query_id, dep, w) or 0
                att = registry.committed_attempt(query_id, dep, w) or 0
                part = 0
                while bm:
                    if bm & 1:
                        key = worker.shuffle_key(query_id, dep, w, part,
                                                 attempt=att)
                        try:
                            st.size(key)
                        except KeyError:
                            lost.append(w)
                            break
                    bm >>= 1
                    part += 1
            if not lost:
                continue
            durs = []
            res = results[dep]
            for w in lost:
                frag = stages[dep].fragments[w]
                att = registry.committed_attempt(query_id, dep, w) or 0
                # First writer wins; the re-put is byte-identical. The
                # duplicate re-runs the COMMITTED attempt so the healed
                # object lands under the key readers will resolve.
                if att and frag.rerun is not None:
                    frag.rerun(attempt=att)
                else:
                    frag.work()
                dur = self.scheduler._noisy_duration(frag.est_duration_s)
                if self.chaos is not None:
                    dur *= self.chaos.slow_multiplier(dep, w, attempt=2)
                durs.append(dur)
                res.node_seconds += dur
                res.speculative_launched += 1
                res.speculative_won += 1
            repair_dur = max(repair_dur, max(durs))
            trace.append(
                f"adaptive: recovered {len(lost)} lost shuffle write(s) "
                f"of '{dep}' by targeted duplicate re-execution before "
                f"stage '{pipe.name}' (first writer wins)")
        return repair_dur

    # -- boundary re-planning -------------------------------------------
    def _replan(self, plan: QueryPlan, idx: int, query_id: str,
                registry: worker.ShuffleRegistry,
                frag_counts: dict[str, int], shuffle_spec: dict[str, int],
                tier_spec: dict[str, str],
                results: dict[str, StageResult],
                trace: list[str]) -> None:
        pipe = plan.pipelines[idx]
        if self.policy.demote_elided and self._maybe_demote(plan, idx,
                                                            trace):
            return    # pipelines[idx] is now the injected repartition scan
        if self.policy.flip_build:
            self._maybe_flip(plan, pipe, query_id, registry, frag_counts,
                             tier_spec, results, trace)
        if isinstance(pipe.output, ShuffleOutput) \
                and (self.policy.replan_fanout or self.policy.replan_tier):
            self._maybe_replace_exchange(plan, idx, query_id, registry,
                                         frag_counts, shuffle_spec,
                                         tier_spec, trace)

    def _observed_shuffle_bytes(self, query_id: str, name: str,
                                frag_counts: dict[str, int],
                                registry: worker.ShuffleRegistry,
                                tier_spec: dict[str, str]) -> float:
        """Bytes a finished producer actually shuffled, summed over the
        objects its writers' bitmaps recorded. A recorded-but-missing
        object (lost write) is skipped here; the repair pass owns it."""
        st = self._tier_store(tier_spec.get(name, "object"))
        total = 0.0
        for w in range(frag_counts.get(name, 0)):
            bm = registry.bitmap(query_id, name, w) or 0
            att = registry.committed_attempt(query_id, name, w) or 0
            part = 0
            while bm:
                if bm & 1:
                    try:
                        total += st.size(worker.shuffle_key(
                            query_id, name, w, part, attempt=att))
                    except KeyError:
                        pass
                bm >>= 1
                part += 1
        return total

    def _observed_input_bytes(self, pipe: Pipeline, query_id: str,
                              frag_counts: dict[str, int],
                              registry: worker.ShuffleRegistry,
                              tier_spec: dict[str, str]
                              ) -> Optional[float]:
        if isinstance(pipe.input, TableInput):
            keys = self.table_keys.get(pipe.input.table, [])
            return float(sum(self.store.size(k) for k in keys))
        src = pipe.input.from_pipeline
        if src not in frag_counts:
            return None
        return self._observed_shuffle_bytes(query_id, src, frag_counts,
                                            registry, tier_spec)

    @staticmethod
    def _scale_for_ops(est: float, pipe: Pipeline) -> float:
        """The lowering's output-size heuristics, applied to an observed
        input instead of a table estimate — so the re-derived fan-out is
        the planner's own rule evaluated on truth."""
        for op in pipe.ops:
            kind = op.get("op")
            if kind == "filter":
                est *= optimizer.FILTER_SELECTIVITY
            elif kind == "hash_agg":
                est *= optimizer.AGG_OUTPUT_FRACTION
        return est

    @staticmethod
    def _consumers(plan: QueryPlan, name: str) -> list[Pipeline]:
        out = []
        for c in plan.pipelines:
            for inp in (c.input, c.input2):
                if isinstance(inp, ShuffleInput) \
                        and inp.from_pipeline == name:
                    out.append(c)
                    break
        return out

    def _refanout_feasible(self, plan: QueryPlan, pipe: Pipeline,
                           frag_counts: dict[str, int]) -> bool:
        """A producer's fan-out may change only while every consumer —
        and every co-partitioned partner feeding the same join — is still
        un-compiled and un-pinned, so the whole co-partition group moves
        together."""
        consumers = self._consumers(plan, pipe.name)
        if not consumers:
            return False
        for c in consumers:
            if c.fragments is not None or isinstance(c.input2, TableInput) \
                    or c.name in frag_counts:
                return False
            for other in (c.input, c.input2):
                if isinstance(other, ShuffleInput) \
                        and other.from_pipeline != pipe.name:
                    if other.from_pipeline in frag_counts:
                        return False    # partner already ran at old fan-out
                    for cc in self._consumers(plan, other.from_pipeline):
                        if cc is not c:
                            return False
        return True

    def _maybe_replace_exchange(self, plan: QueryPlan, idx: int,
                                query_id: str,
                                registry: worker.ShuffleRegistry,
                                frag_counts: dict[str, int],
                                shuffle_spec: dict[str, int],
                                tier_spec: dict[str, str],
                                trace: list[str]) -> None:
        pipe = plan.pipelines[idx]
        out = pipe.output
        observed = self._observed_input_bytes(pipe, query_id, frag_counts,
                                              registry, tier_spec)
        if not observed:
            return
        est_out = self._scale_for_ops(observed, pipe)
        global_agg = any(op.get("op") == "hash_agg" and not op.get("keys")
                         for op in pipe.ops)
        if self.policy.replan_fanout and not global_agg:
            new = optimizer.derive_fanout(
                est_out, self.backend, memory_budget=self.memory_budget)
            if new != out.partitions \
                    and self._refanout_feasible(plan, pipe, frag_counts):
                old = out.partitions
                consumers = self._consumers(plan, pipe.name)
                partners = []
                for c in consumers:
                    for other in (c.input, c.input2):
                        if isinstance(other, ShuffleInput) \
                                and other.from_pipeline != pipe.name:
                            p2 = next(p for p in plan.pipelines
                                      if p.name == other.from_pipeline)
                            if isinstance(p2.output, ShuffleOutput) \
                                    and p2 not in partners:
                                partners.append(p2)
                out.partitions = new
                srcs = {pipe.name}
                for p2 in partners:
                    p2.output.partitions = new
                    srcs.add(p2.name)
                for c in plan.pipelines:
                    for inp, attr in ((c.input, "partitioning"),
                                      (c.input2, "partitioning2")):
                        part = getattr(c, attr)
                        if part and isinstance(inp, ShuffleInput) \
                                and inp.from_pipeline in srcs:
                            setattr(c, attr, {**part, "fanout": new})
                plan.validate()
                self._replan_count += 1
                trace.append(
                    f"adaptive: re-derived fan-out of '{pipe.name}' "
                    f"shuffle from observed {observed / 2**20:.1f} MiB "
                    f"input: {old} -> {new} partitions"
                    + (f" (co-partitioned with "
                       f"{sorted(p.name for p in partners)})"
                       if partners else ""))
        if self.policy.replan_tier:
            writers, _ = self._parallelism(pipe, frag_counts, query_id,
                                           shuffle_spec)
            placed = breakeven.place_exchange_from_bench(
                est_out, writers, out.partitions)
            target = placed.tier
            breaker = getattr(self.kv_store, "breaker", None)
            if target == "kv" and breaker is not None \
                    and breaker.state != "closed":
                # The kv tier's circuit is open (or probing): break-even
                # or not, new placements stay off the dark tier.
                trace.append(
                    f"adaptive: kv tier circuit {breaker.state}; pinned "
                    f"'{pipe.name}' exchange to the object store")
                target = "object"
            if target != out.tier:
                old_tier = out.tier
                out.tier = target
                self._replan_count += 1
                trace.append(
                    f"adaptive: moved '{pipe.name}' exchange {old_tier} "
                    f"-> {target} tier at observed "
                    f"{est_out / 2**20:.1f} MiB (break-even re-placement)")

    def _maybe_flip(self, plan: QueryPlan, pipe: Pipeline, query_id: str,
                    registry: worker.ShuffleRegistry,
                    frag_counts: dict[str, int],
                    tier_spec: dict[str, str],
                    results: dict[str, StageResult],
                    trace: list[str]) -> None:
        """Flip a shuffle join's build side when the observed sizes
        inverted the planner's estimate. Only un-elided joins qualify
        (both sides ShuffleInput, no relied partitioning): the inputs are
        co-partitioned on the join keys, so swapping which side builds
        the hash table is local to each fragment. A rename projection
        restores the planned output schema (the probe-side key name
        survives a join, and after the flip that is the other key)."""
        join_ops = [op for op in pipe.ops if op.get("op") == "hash_join"]
        if len(join_ops) != 1 or pipe.join is not None:
            return
        if not (isinstance(pipe.input, ShuffleInput)
                and isinstance(pipe.input2, ShuffleInput)):
            return
        if pipe.partitioning2 is not None:
            return
        # A relied input partitioning (a downstream shuffle was elided
        # against the join's co-partitioning) survives a flip: the sides
        # are equi-join co-partitioned at one fan-out, so fragment i
        # holds key class i either way — only the property's key NAME
        # follows the new probe producer's partition key.
        probe_src = pipe.input.from_pipeline
        build_src = pipe.input2.from_pipeline
        if probe_src not in results or build_src not in results:
            return
        probe_b = self._observed_shuffle_bytes(query_id, probe_src,
                                               frag_counts, registry,
                                               tier_spec)
        build_b = self._observed_shuffle_bytes(query_id, build_src,
                                               frag_counts, registry,
                                               tier_spec)
        if probe_b <= 0 or build_b <= probe_b * self.policy.flip_factor:
            return
        op = join_ops[0]
        a, b = op["left_key"], op["right_key"]
        schemas = plans_mod.pipeline_schemas(plan)
        probe_schema = schemas.get(probe_src)
        build_schema = schemas.get(build_src)
        if probe_schema is None or build_schema is None:
            trace.append(
                f"adaptive: build side of '{pipe.name}' observed "
                f"{build_b / 2**20:.1f} MiB > probe "
                f"{probe_b / 2**20:.1f} MiB, but an opaque upstream op "
                "hides the schema; kept planned sides")
            return
        out_schema = logical.join_output_schema(probe_schema, build_schema,
                                                b)
        pipe.input, pipe.input2 = pipe.input2, pipe.input
        op["left_key"], op["right_key"] = b, a
        if pipe.partitioning is not None:
            new_prod = next(p for p in plan.pipelines
                            if p.name == pipe.input.from_pipeline)
            pipe.partitioning = {**pipe.partitioning,
                                 "key": new_prod.output.partition_by}
        j = pipe.ops.index(op)
        pipe.ops.insert(
            j + 1,
            {"op": "project",
             "columns": [c if c != a else [a, b] for c in out_schema]})
        plan.validate()
        self._replan_count += 1
        trace.append(
            f"adaptive: flipped build side of '{pipe.name}': planned "
            f"build '{build_src}' observed {build_b / 2**20:.1f} MiB vs "
            f"probe '{probe_src}' {probe_b / 2**20:.1f} MiB; now "
            f"building on '{probe_src}'")

    def _maybe_demote(self, plan: QueryPlan, idx: int,
                      trace: list[str]) -> bool:
        """Demote an elided co-partition join whose *declared* base-table
        layout lies: probe each stored partition slice with the
        summarized ``key % fanout`` bitmap check and, on a violation,
        inject an explicit repartition scan in front of the join instead
        of letting the worker's fail-loud validation abort the stage.
        The probe reads are billed to the store like any other request;
        they overlap planning in model time."""
        pipe = plan.pipelines[idx]
        demoted = False
        for side, inp, part in (("probe", pipe.input, pipe.partitioning),
                                ("build", pipe.input2, pipe.partitioning2)):
            if not (isinstance(inp, TableInput) and part):
                continue
            key, fanout = part["key"], part["fanout"]
            keys = self.table_keys.get(inp.table, [])
            if len(keys) != fanout:
                continue    # _parallelism raises its own error for this
            violated = None
            for i, k in enumerate(keys):
                batch = columnar.deserialize(self.store.get(k), [key])
                bm = worker.partition_class_bitmap(batch, key, fanout)
                if bm & ~(1 << i):
                    violated = i
                    break
            if violated is None:
                continue
            scan_name = f"{pipe.name}__repart_{side}"
            while any(p.name == scan_name for p in plan.pipelines):
                scan_name += "_"
            plan.pipelines.insert(idx, Pipeline(
                name=scan_name,
                input=TableInput(inp.table, list(inp.columns)),
                ops=[],
                output=ShuffleOutput(key, fanout)))
            if side == "probe":
                pipe.input = ShuffleInput(scan_name)
                pipe.partitioning = None
                pipe.fragments = None
            else:
                pipe.input2 = ShuffleInput(scan_name)
                pipe.partitioning2 = None
            demoted = True
            self._replan_count += 1
            trace.append(
                f"adaptive: demoted elided co-partition join in "
                f"'{pipe.name}': stored partition {violated} of table "
                f"'{inp.table}' holds keys outside class {violated} "
                f"(hash({key}) % {fanout}); injected repartition scan "
                f"'{scan_name}'")
        if demoted:
            plan.validate()
        return demoted
