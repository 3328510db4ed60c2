"""Multi-query serving loop over one shared elastic worker pool.

``Coordinator.execute`` runs one query at a time: compile, schedule,
merge. This module is the serving layer the ROADMAP's Skyrise north star
describes — a stream of ``LogicalQuery``s from many tenants, lowered
through the existing optimizer, their stages INTERLEAVED on one shared
pool (``core.scheduler.MultiQueryScheduler``) under a fixed worker
budget, with per-tenant admission control
(``core.token_bucket.AdmissionBucket``) and two caches in front of the
pool:

* the **compiled-plan cache** (``engine.compile.PLAN_CACHE``): queries
  whose canonical plan shape (``engine.plans.plan_shape_hash``) was seen
  before skip every trace rebuild — the dominant cold-start analog — even
  when their literals or tables differ;
* a **result cache** keyed by ``(shape_hash, residue_hash)`` with
  bitmap-validated invalidation: a byte-identical repeat of a finished
  query replays its merged result straight from the object store,
  validated against the input tables' etags and the producing run's
  ``ShuffleRegistry`` partition bitmaps (every partition a writer
  recorded must still be resident; partitions a writer skipped as empty
  are legitimately absent).

The serving clock is the engine's model time: fragment work executes for
real, durations and concurrency are simulated deterministically per seed,
so throughput/latency comparisons (``ServeReport``) are reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core.scheduler import MultiQueryScheduler, QueryJob, StragglerPolicy
from repro_torch.core.storage_service import ObjectStore
from repro_torch.core.token_bucket import AdmissionBucket, AdmissionConfig
from repro_torch.engine import compile as engine_compile
from repro_torch.engine import optimizer, plans, worker
from repro_torch.engine.columnar import ColumnBatch
from repro_torch.engine.coordinator import Coordinator, QueryResult
from repro_torch.engine.logical import LogicalQuery


@dataclasses.dataclass
class QueryRequest:
    """One submitted query: logical (lowered by the server) or physical."""

    query: Union[LogicalQuery, plans.QueryPlan]
    tenant: str = "default"
    submit_t: float = 0.0


@dataclasses.dataclass
class ServedQuery:
    request: QueryRequest
    result: QueryResult
    query_id: str
    submit_t: float
    admit_t: float
    finish_t: float
    plan_cache_hit: bool
    result_cache_hit: bool

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.submit_t


@dataclasses.dataclass
class ServeReport:
    queries: list[ServedQuery]
    makespan_s: float
    throughput_qps: float
    p50_latency_s: float
    p99_latency_s: float
    plan_cache_hits: int
    plan_cache_misses: int
    result_cache_hits: int
    admission: dict[str, dict]          # tenant -> admitted/denied/queued_s
    # Adaptive-execution totals summed over the served queries' results
    # (engine.adaptive counters carried on QueryResult; zero when every
    # query ran the static path).
    replans: int = 0
    speculative_launched: int = 0
    speculative_won: int = 0
    # Queries whose recovery ladder was exhausted: served with a
    # structured ``QueryResult.failure`` record and an empty result.
    failures: int = 0

    @property
    def plan_cache_hit_rate(self) -> float:
        total = self.plan_cache_hits + self.plan_cache_misses
        return self.plan_cache_hits / total if total else 0.0


class ResultCache:
    """Scan-result/shuffle-object cache with bitmap-validated invalidation.

    An entry remembers, for one finished query: the terminal pipeline's
    result keys, the etags of every table object it scanned, and the
    producing run's ``ShuffleRegistry`` bitmaps. A lookup replays the
    merged result with zero pool work iff (1) every scanned table object
    still has the recorded etag, (2) every result object is resident, and
    (3) every shuffle partition a writer's bitmap records as written is
    still resident — the bitmaps distinguish "evicted intermediate"
    (invalidate) from "writer skipped an empty partition" (fine), exactly
    the validation the shuffle readers themselves do.
    """

    def __init__(self, store: ObjectStore, maxsize: int = 32,
                 kv_store: Optional[ObjectStore] = None):
        self.store = store
        # Exchange tier for kv-placed shuffle objects: bitmap validation
        # must consult the store a pipeline's writers actually wrote to.
        self.kv_store = kv_store
        self.maxsize = maxsize
        self._entries: dict = {}        # key -> entry dict (insert-ordered)
        self.hits = 0
        self.misses = 0
        self.invalidated = 0

    @staticmethod
    def key_for(plan: plans.QueryPlan) -> tuple[str, str]:
        return plans.plan_cache_key(plan)

    def put(self, key, query_id: str, terminal: str, n_frags: int,
            table_etags: dict[str, int],
            registry: worker.ShuffleRegistry,
            shuffle_tiers: Optional[dict[str, str]] = None) -> None:
        # Remember each writer's COMMITTED attempt alongside its bitmap:
        # recovery may have published attempt > 0, and validation must
        # probe the attempt-scoped keys that attempt actually wrote.
        bitmaps = {ident: (att, registry.bitmap(*ident))
                   for ident, att in registry._committed.items()}
        self._entries.pop(key, None)
        self._entries[key] = {
            "query_id": query_id, "terminal": terminal, "n_frags": n_frags,
            "table_etags": dict(table_etags), "bitmaps": bitmaps,
            "tiers": dict(shuffle_tiers or {}),
        }
        while len(self._entries) > self.maxsize:
            self._entries.pop(next(iter(self._entries)))

    def _shuffle_store(self, entry: dict, pipeline: str) -> ObjectStore:
        tier = entry.get("tiers", {}).get(pipeline, "object")
        if tier == "kv" and self.kv_store is not None:
            return self.kv_store
        return self.store

    def _valid(self, entry: dict) -> bool:
        for k, tag in entry["table_etags"].items():
            try:
                if self.store.etag(k) != tag:
                    return False
            except KeyError:
                return False
        qid = entry["query_id"]
        for i in range(entry["n_frags"]):
            rk = worker.result_key(qid, entry["terminal"], i)
            try:
                self.store.etag(rk)
            except KeyError:
                return False
        for (_, pipeline, writer), (att, bm) in entry["bitmaps"].items():
            st = self._shuffle_store(entry, pipeline)
            p = 0
            while bm >> p:
                if (bm >> p) & 1:
                    sk = worker.shuffle_key(qid, pipeline, writer, p, att)
                    try:
                        st.etag(sk)
                    except KeyError:
                        return False
                p += 1
        return True

    def lookup(self, key) -> Optional[dict]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        if not self._valid(entry):
            del self._entries[key]
            self.invalidated += 1
            self.misses += 1
            return None
        self.hits += 1
        return entry

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "invalidated": self.invalidated,
                "entries": len(self._entries)}


class _TenantAdmitter:
    """Adapter between ``MultiQueryScheduler``'s admitter protocol and
    one ``AdmissionBucket`` per tenant."""

    def __init__(self, config: AdmissionConfig):
        self.config = config
        self.buckets: dict[str, AdmissionBucket] = {}

    def bucket(self, tenant: str) -> AdmissionBucket:
        if tenant not in self.buckets:
            self.buckets[tenant] = AdmissionBucket(self.config)
        return self.buckets[tenant]

    def try_admit(self, job: QueryJob, t: float) -> bool:
        return self.bucket(job.tenant).try_acquire(job.cost, t)

    def next_admit_time(self, job: QueryJob, t: float) -> float:
        return t + self.bucket(job.tenant).time_until(job.cost, t)


class QueryServer:
    """Serve a stream of queries on one shared elastic worker pool.

    ``serve(requests)`` interleaves stages from all admitted queries
    under ``worker_budget``; ``serve(requests, interleave=False)`` is the
    serial baseline — the SAME machinery (same pool, caches, admission)
    with each query run to completion before the next starts, which is
    what ``Coordinator.execute`` in a loop would do.
    """

    def __init__(self, store: ObjectStore, worker_budget: int = 64,
                 backend: str = "torch", device: str = "cuda",
                 mode: str = "elastic",
                 admission: Optional[AdmissionConfig] = None,
                 result_cache: bool = True, max_workers: int = 1024,
                 rng_seed: int = 0, chaos=None,
                 speculation_headroom: int = 0, stage_retries: int = 2):
        self.store = store
        self.worker_budget = worker_budget
        self.coordinator = Coordinator(store, mode=mode, backend=backend,
                                       device=device,
                                       max_workers=min(max_workers,
                                                       worker_budget),
                                       rng_seed=rng_seed, chaos=chaos)
        self.scheduler = MultiQueryScheduler(
            self.coordinator.pool, StragglerPolicy(), budget=worker_budget,
            rng_seed=rng_seed, chaos=chaos,
            speculation_headroom=speculation_headroom,
            stage_retries=stage_retries)
        self.admission = admission or AdmissionConfig(
            capacity=max(256.0, 4.0 * worker_budget),
            refill_per_s=2.0 * worker_budget)
        self.result_cache = ResultCache(
            store, kv_store=self.coordinator.kv_store) \
            if result_cache else None
        self._seq = 0

    def register_table(self, name: str, keys: list[str]) -> None:
        self.coordinator.register_table(name, keys)

    # ------------------------------------------------------------------
    def _lower(self, query) -> plans.QueryPlan:
        if isinstance(query, LogicalQuery):
            stats = optimizer.Stats.from_store(
                self.store, self.coordinator.table_keys)
            plan, _ = optimizer.lower(query, stats=stats,
                                      backend=self.coordinator.backend)
            return plan
        return query

    def _table_etags(self, plan: plans.QueryPlan) -> dict[str, int]:
        etags: dict[str, int] = {}
        for pipe in plan.pipelines:
            for inp in (pipe.input, pipe.input2):
                if isinstance(inp, plans.TableInput):
                    for k in self.coordinator.table_keys[inp.table]:
                        etags[k] = self.store.etag(k)
        return etags

    def serve(self, requests: list, interleave: bool = True) -> ServeReport:
        reqs = [r if isinstance(r, QueryRequest) else QueryRequest(r)
                for r in requests]
        admitter = _TenantAdmitter(self.admission)
        coord = self.coordinator
        prepared = []          # (req, plan, qid, job|None, ctx)
        plan_hits = plan_misses = result_hits = 0
        for req in sorted(reqs, key=lambda r: r.submit_t):
            plan = self._lower(req.query)
            qid = f"{plan.name}-{self._seq}"
            self._seq += 1
            shape_hash, plan_hit = "", False
            if coord.backend == "torch":
                shape_hash, plan_hit = engine_compile.PLAN_CACHE.lookup(plan)
                plan_hits += plan_hit
                plan_misses += not plan_hit
            cache_key = entry = None
            if self.result_cache is not None:
                cache_key = ResultCache.key_for(plan)
                entry = self.result_cache.lookup(cache_key)
            if entry is not None:
                # Replayed from cache: no fragments, no pool, no
                # admission cost — the query is served at submit time.
                result_hits += 1
                merged = coord._merge_collect(
                    entry["query_id"], plan.pipelines[-1],
                    entry["n_frags"])
                prepared.append((req, plan, qid, None, {
                    "merged": merged, "shape_hash": shape_hash,
                    "plan_hit": plan_hit}))
                continue
            plan.validate()
            stats_before = dataclasses.replace(self.store.stats)
            kv_stats_before = dataclasses.replace(coord.kv_store.stats)
            table_etags = self._table_etags(plan)
            registry = worker.ShuffleRegistry()
            stages, frag_counts = coord.compile_stages(plan, qid, registry)
            job = QueryJob(job_id=qid, stages=stages,
                           submit_t=req.submit_t, tenant=req.tenant)
            prepared.append((req, plan, qid, job, {
                "frag_counts": frag_counts, "registry": registry,
                "stats_before": stats_before,
                "kv_stats_before": kv_stats_before,
                "table_etags": table_etags,
                "cache_key": cache_key, "shape_hash": shape_hash,
                "plan_hit": plan_hit}))

        jobs = [job for _, _, _, job, _ in prepared if job is not None]
        if interleave:
            if jobs:
                self.scheduler.run_jobs(jobs, admitter)
        else:
            cursor = 0.0
            for job in jobs:          # already in submit order
                job.submit_t = max(job.submit_t, cursor)
                self.scheduler.run_jobs([job], admitter)
                cursor = job.finish_t

        served = []
        for req, plan, qid, job, ctx in prepared:
            if job is None:
                qres = QueryResult(
                    name=plan.name, result=ctx["merged"], runtime_s=0.0,
                    cumulated_worker_s=0.0, faas_cost_usd=0.0,
                    storage_cost_usd=0.0, stage_metrics={},
                    request_stats=dataclasses.replace(self.store.stats),
                    peak_workers=0, stage_node_seconds=[],
                    plan_shape_hash=ctx["shape_hash"],
                    plan_cache_hit=ctx["plan_hit"])
                served.append(ServedQuery(
                    request=req, result=qres, query_id=qid,
                    submit_t=req.submit_t, admit_t=req.submit_t,
                    finish_t=req.submit_t, plan_cache_hit=ctx["plan_hit"],
                    result_cache_hit=True))
                continue
            if job.failure is not None:
                # Recovery ladder exhausted inside the scheduler: surface
                # a clean per-query failure record instead of raising, so
                # the rest of the batch is unaffected. No result objects
                # exist to merge and nothing is cached.
                qres = QueryResult(
                    name=plan.name, result=ColumnBatch({}),
                    runtime_s=(job.finish_t or job.submit_t) - job.submit_t,
                    cumulated_worker_s=sum(
                        r.node_seconds for r in job.results.values()),
                    faas_cost_usd=0.0, storage_cost_usd=0.0,
                    stage_metrics={},
                    request_stats=dataclasses.replace(self.store.stats),
                    peak_workers=0, stage_node_seconds=[],
                    plan_shape_hash=ctx["shape_hash"],
                    plan_cache_hit=ctx["plan_hit"],
                    failure=dict(job.failure))
                served.append(ServedQuery(
                    request=req, result=qres, query_id=qid,
                    submit_t=job.submit_t, admit_t=job.admit_t,
                    finish_t=job.finish_t, plan_cache_hit=ctx["plan_hit"],
                    result_cache_hit=False))
                continue
            qres = coord.finalize(plan, qid, ctx["frag_counts"],
                                  job.results, ctx["stats_before"],
                                  ctx["shape_hash"], ctx["plan_hit"],
                                  kv_stats_before=ctx["kv_stats_before"])
            if self.result_cache is not None:
                terminal = plan.pipelines[-1]
                self.result_cache.put(
                    ctx["cache_key"], qid, terminal.name,
                    ctx["frag_counts"][terminal.name], ctx["table_etags"],
                    ctx["registry"],
                    shuffle_tiers={
                        p.name: p.output.tier for p in plan.pipelines
                        if isinstance(p.output, plans.ShuffleOutput)})
            served.append(ServedQuery(
                request=req, result=qres, query_id=qid,
                submit_t=job.submit_t, admit_t=job.admit_t,
                finish_t=job.finish_t, plan_cache_hit=ctx["plan_hit"],
                result_cache_hit=False))

        lat = np.array([s.latency_s for s in served]) if served \
            else np.zeros(1)
        t0 = min((s.submit_t for s in served), default=0.0)
        t1 = max((s.finish_t for s in served), default=0.0)
        makespan = max(t1 - t0, 1e-9)
        return ServeReport(
            queries=served, makespan_s=makespan,
            throughput_qps=len(served) / makespan,
            p50_latency_s=float(np.percentile(lat, 50)),
            p99_latency_s=float(np.percentile(lat, 99)),
            plan_cache_hits=plan_hits, plan_cache_misses=plan_misses,
            result_cache_hits=result_hits,
            replans=sum(s.result.replans for s in served),
            speculative_launched=sum(
                s.result.speculative_launched for s in served),
            speculative_won=sum(s.result.speculative_won for s in served),
            failures=sum(1 for s in served if s.result.failure is not None),
            admission={
                tenant: {"admitted": b.admitted, "denied": b.denied}
                for tenant, b in admitter.buckets.items()})
