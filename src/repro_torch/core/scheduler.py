"""Stage-wise DAG scheduler with straggler mitigation (paper §3.2).

The Skyrise coordinator compiles a plan into pipelines of fragments with
dependencies and schedules them stage-wise; straggling storage requests are
re-triggered after a size-based timeout, and retries use capped exponential
backoff with jitter. The same scheduler drives the query engine and the
elastic trainer's stage execution (data prep / step / checkpoint stages).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.elastic_pool import ElasticPool, InvokeFailedError, \
    ProvisionedPool


def _recoverable(exc: BaseException) -> bool:
    """Failures the multi-query recovery ladder owns: worker kills/OOMs,
    terminally-failed invocations, and store brownouts. Anything else
    (a real bug, a validation error) propagates untouched."""
    from repro_torch.core.storage_service import CircuitOpenError, \
        ThrottledError, UnavailableError
    from repro_torch.engine.worker import WorkerKilled
    return isinstance(exc, (WorkerKilled, InvokeFailedError,
                            CircuitOpenError, ThrottledError,
                            UnavailableError))


@dataclasses.dataclass
class Fragment:
    """One data-parallel task of a pipeline stage."""

    fragment_id: int
    work: Callable[[], object]          # executes the real operator work
    est_duration_s: float = 0.1         # model-time duration (simulation)
    input_bytes: float = 0.0
    # Optional kwargs-accepting re-execution hook (``attempt=``,
    # ``memory_budget=``): the engine coordinator sets it so the recovery
    # layer can re-run exactly the dead attempt under a new attempt
    # number (and a spill budget after an OOM kill) without the base
    # ``work`` signature changing for non-engine callers.
    rerun: Optional[Callable] = None


@dataclasses.dataclass
class Stage:
    name: str
    fragments: list[Fragment]
    deps: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StageResult:
    name: str
    start_t: float
    end_t: float
    worker_count: int
    results: list[object]
    retried_fragments: int = 0
    node_seconds: float = 0.0
    # Speculative duplicate executions (engine.adaptive): launched when a
    # fragment crossed the lognormal expected-max barrier, won when the
    # duplicate finished first. Zero under the base scheduler.
    speculative_launched: int = 0
    speculative_won: int = 0
    # Fragment attempts re-run in place after a worker kill/OOM
    # (engine.adaptive lineage recovery). Zero under the base scheduler.
    recovered_attempts: int = 0


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Size-based timeout + duplicate re-trigger (paper §3.2)."""

    timeout_per_mib_s: float = 0.25     # size-based timeout slope
    timeout_floor_s: float = 1.0
    slowdown_factor: float = 3.0        # x median considered straggling
    max_retries: int = 2

    def timeout_s(self, input_bytes: float) -> float:
        return max(self.timeout_floor_s,
                   input_bytes / (1024.0 ** 2) * self.timeout_per_mib_s)


class StageScheduler:
    """Executes a stage DAG on an elastic or provisioned pool.

    Work functions run for real (they produce the actual data); durations in
    model time come from ``est_duration_s`` plus a lognormal noise term with
    occasional stragglers, which the policy re-triggers. Deterministic per
    seed."""

    def __init__(self, pool, policy: StragglerPolicy = StragglerPolicy(),
                 straggler_prob: float = 0.02, rng_seed: int = 0,
                 chaos=None):
        self.pool = pool
        self.policy = policy
        self.straggler_prob = straggler_prob
        self._rng = np.random.default_rng(rng_seed)
        # Optional fault injection (core.chaos.ChaosPolicy): multiplies
        # fragment durations by a per-(stage, fragment) lognormal draw.
        self.chaos = chaos

    def run(self, stages: Sequence[Stage], t0: float = 0.0
            ) -> dict[str, StageResult]:
        done: dict[str, StageResult] = {}
        remaining = list(stages)
        t = t0
        while remaining:
            ready = [s for s in remaining if all(d in done for d in s.deps)]
            if not ready:
                raise RuntimeError("dependency cycle in stage DAG")
            for stage in ready:
                start = max([t] + [done[d].end_t for d in stage.deps])
                res = self._run_stage(stage, start)
                done[stage.name] = res
                remaining.remove(stage)
            t = max(r.end_t for r in done.values())
        return done

    # -- single stage ---------------------------------------------------------
    def run_stage(self, stage: Stage, t: float) -> StageResult:
        """Acquire workers at model time ``t``, execute the stage's
        fragments (real work, modeled durations), release. Public entry
        for schedulers that interleave stages from many DAGs."""
        return self._run_stage(stage, t)

    def _run_stage(self, stage: Stage, t: float) -> StageResult:
        n = len(stage.fragments)
        workers = self.pool.acquire(n, t)
        results: list[object] = [None] * n
        end_times = np.zeros(n)
        retried = 0
        node_seconds = 0.0
        for i, (frag, w) in enumerate(zip(stage.fragments, workers)):
            try:
                results[i] = frag.work()
            except Exception as exc:
                # A fragment died (worker kill, OOM, terminal store
                # error). The fleet still ran until the failure: charge
                # the dead attempt's modeled duration, release every
                # worker, and surface the elapsed model time so the
                # recovery layer restarts after it instead of for free.
                dur = self._noisy_duration(frag.est_duration_s)
                if self.chaos is not None:
                    dur *= self.chaos.slow_multiplier(stage.name,
                                                      frag.fragment_id)
                end_times[i] = w.ready_at + dur
                node_seconds += dur
                elapsed_end = float(end_times.max()) if n else t
                self.pool.release(workers, elapsed_end,
                                  busy_s=node_seconds / max(n, 1))
                exc.elapsed_s = max(0.0, elapsed_end - t)
                exc.node_seconds = node_seconds
                raise
            dur = self._noisy_duration(frag.est_duration_s)
            if self.chaos is not None:
                dur *= self.chaos.slow_multiplier(stage.name,
                                                  frag.fragment_id)
            timeout = max(self.policy.timeout_s(frag.input_bytes),
                          self.policy.slowdown_factor * frag.est_duration_s)
            start = w.ready_at
            completion = start + dur
            node_seconds += dur
            attempts = 0
            while completion - start > timeout * (attempts + 1) and \
                    attempts < self.policy.max_retries:
                # Straggler: re-trigger a duplicate after the timeout; the
                # duplicate RACES the original (paper §3.2) — the fragment
                # finishes at whichever copy completes first.
                attempts += 1
                retried += 1
                dup = self._noisy_duration(frag.est_duration_s)
                dup_completion = start + timeout * attempts + dup
                node_seconds += min(dup, max(0.0,
                                             completion - start
                                             - timeout * attempts))
                completion = min(completion, dup_completion)
            end_times[i] = completion
        self.pool.release(workers, float(end_times.max()) if n else t,
                          busy_s=node_seconds / max(n, 1))
        return StageResult(stage.name, t, float(end_times.max()) if n else t,
                           n, results, retried, node_seconds)

    def _noisy_duration(self, est: float) -> float:
        noise = float(self._rng.lognormal(0.0, 0.08))
        if float(self._rng.random()) < self.straggler_prob:
            noise *= float(self._rng.uniform(
                self.policy.slowdown_factor, 3 * self.policy.slowdown_factor))
        return est * noise


# ---------------------------------------------------------------------------
# Multi-query scheduling (serving layer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueryJob:
    """One query's stage DAG as the multi-query scheduler sees it."""

    job_id: str
    stages: list[Stage]
    submit_t: float = 0.0
    tenant: str = "default"
    cost: int = 0                       # admission cost (worker invocations)
    results: dict[str, StageResult] = dataclasses.field(default_factory=dict)
    started: set = dataclasses.field(default_factory=set)
    admit_t: Optional[float] = None
    finish_t: Optional[float] = None
    # Worker-failure recovery bookkeeping: failed stage attempts so far,
    # the earliest time each failed stage may be retried (the dead
    # attempt's elapsed model time is charged), and the structured
    # failure record once the retry budget is exhausted — the serving
    # layer surfaces it as ``QueryResult.failure`` instead of raising.
    stage_attempts: dict = dataclasses.field(default_factory=dict)
    retry_at: dict = dataclasses.field(default_factory=dict)
    failure: Optional[dict] = None

    def __post_init__(self):
        if not self.cost:
            self.cost = sum(len(s.fragments) for s in self.stages)

    @property
    def done(self) -> bool:
        return self.finish_t is not None


class MultiQueryScheduler(StageScheduler):
    """Interleaves ready stages from MANY query DAGs onto one shared pool.

    Unlike ``StageScheduler.run`` (one DAG, stages started as their deps
    complete), this is an event loop over a heap of running stages: at
    each model-time step every admitted job's ready stages are dispatched
    FIFO while they fit the worker ``budget`` (a stage wider than the
    whole budget runs alone rather than starving), then time advances to
    the next stage completion or query arrival. Queries denied by the
    ``admitter`` (per-tenant admission control) queue and are re-offered
    as capacity frees. Same noise model and pool accounting as the
    single-query scheduler; deterministic per seed.
    """

    def __init__(self, pool, policy: StragglerPolicy = StragglerPolicy(),
                 budget: int = 64, straggler_prob: float = 0.02,
                 rng_seed: int = 0, chaos=None,
                 speculation_headroom: int = 0, stage_retries: int = 2):
        super().__init__(pool, policy, straggler_prob, rng_seed, chaos=chaos)
        self.budget = budget
        # Workers held back from first-attempt dispatch so speculative
        # duplicates and recovery retries never starve behind a fully
        # packed budget (ROADMAP item 3 remainder).
        self.speculation_headroom = min(speculation_headroom,
                                        max(0, budget - 1))
        # Failed stage attempts tolerated per (job, stage) before the job
        # fails with a structured record instead of an exception.
        self.stage_retries = stage_retries

    def run_jobs(self, jobs: Sequence[QueryJob], admitter=None
                 ) -> list[QueryJob]:
        pending = sorted(jobs, key=lambda j: (j.submit_t, j.job_id))
        admitted: list[QueryJob] = []
        running: list = []              # heap: (end_t, seq, width, job, res)
        seq = used = done = 0
        t = pending[0].submit_t if pending else 0.0
        while done < len(jobs):
            progressed = False
            # 1. offer arrived jobs to admission control, in submit order
            waiting = []
            for job in pending:
                if job.submit_t <= t and (admitter is None
                                          or admitter.try_admit(job, t)):
                    job.admit_t = t
                    admitted.append(job)
                    progressed = True
                else:
                    waiting.append(job)
            pending = waiting
            # 2. dispatch ready stages FIFO while they fit the budget
            # (minus the speculation headroom, reserved for duplicates
            # and recovery retries)
            cap = self.budget - self.speculation_headroom
            for job in admitted:
                if job.done:
                    continue
                for stage in job.stages:
                    if stage.name in job.started or \
                            not all(d in job.results for d in stage.deps):
                        continue
                    if t < job.retry_at.get(stage.name, 0.0):
                        continue   # charged for a dead attempt; wait
                    width = len(stage.fragments)
                    if used and used + width > cap:
                        continue
                    # Deps recorded in job.results completed at <= t and
                    # admit_t <= t, so the stage starts exactly at t.
                    try:
                        res = self.run_stage(stage, t)
                    except Exception as exc:
                        if not _recoverable(exc):
                            raise
                        progressed = True
                        attempts = job.stage_attempts.get(stage.name,
                                                          0) + 1
                        job.stage_attempts[stage.name] = attempts
                        elapsed = getattr(exc, "elapsed_s", 0.0)
                        if attempts <= self.stage_retries:
                            job.retry_at[stage.name] = t + elapsed
                        else:
                            # Retry budget exhausted: the job fails with
                            # a structured record; other jobs continue.
                            job.failure = {
                                "kind": getattr(exc, "kind",
                                                type(exc).__name__),
                                "stage": stage.name,
                                "attempts": attempts,
                                "message": str(exc)}
                            job.finish_t = t + elapsed
                            done += 1
                        break
                    job.started.add(stage.name)
                    used += width
                    heapq.heappush(running, (res.end_t, seq, width, job,
                                             res))
                    seq += 1
                    progressed = True
            if progressed:
                continue
            # 3. stalled: advance model time to the next event
            events = [running[0][0]] if running else []
            for job in admitted:
                if job.done:
                    continue
                for name, at in job.retry_at.items():
                    if at > t and name not in job.started:
                        events.append(at)
            for job in pending:
                if job.submit_t > t:
                    events.append(job.submit_t)
                elif admitter is not None:
                    # Queued behind admission control: wake when the
                    # tenant's bucket has refilled enough.
                    events.append(max(admitter.next_admit_time(job, t),
                                      t + 1e-6))
            if not events or (not running and min(events) <= t):
                raise RuntimeError(
                    "multi-query scheduler stalled: queued jobs but no "
                    "running stages or future events")
            t = min(events)
            while running and running[0][0] <= t:
                end_t, _, width, job, res = heapq.heappop(running)
                used -= width
                job.results[res.name] = res
                if len(job.results) == len(job.stages):
                    job.finish_t = end_t
                    done += 1
        return list(jobs)


def make_pool(mode: str, provisioned_slots: int = 256, **kw):
    """'elastic' (FaaS path) or 'provisioned' (IaaS path) — paper Fig 4."""
    if mode == "elastic":
        return ElasticPool(**kw)
    if mode == "provisioned":
        return ProvisionedPool(provisioned_slots)
    raise ValueError(f"unknown mode {mode!r}")
