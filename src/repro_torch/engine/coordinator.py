"""Query coordinator (paper §3.2 + Fig 4).

The coordinator fetches input metadata, compiles the physical plan into a
distributed plan (fragments per pipeline, burst-aware partition assignment
via ``core.burst_planner``), schedules pipelines stage-wise through
``core.scheduler`` on either the elastic (FaaS) or provisioned (IaaS) pool,
and returns the result location plus runtime and cost — the same plan runs
in both modes.

Workers execute fragments on the ``torch`` backend by default, on the
device named by ``device`` (``"cuda"`` unless the caller asks for the
CPU); pass ``backend="numpy"`` for the interpreted float64 semantic
reference. The float contract and the interpreted fallbacks are those of
``engine.compile``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np

from repro_torch.core import bench_profile, burst_planner, pricing, token_bucket
from repro_torch.core.elastic_pool import ColdStartModel, ElasticPool, ProvisionedPool
from repro_torch.core.scheduler import Fragment, Stage, StageScheduler, StragglerPolicy
from repro_torch.core.storage_service import (KV_MEMORY_PROFILE, KVStore,
                                        LatencyModel, ObjectStore,
                                        RequestStats, S3_STANDARD_PROFILE)
from repro_torch.engine import columnar, optimizer, worker
from repro_torch.engine import compile as engine_compile
from repro_torch.engine.columnar import ColumnBatch
from repro_torch.engine.logical import LogicalQuery
from repro_torch.engine.plans import (CollectOutput, Pipeline, QueryPlan,
                                ShuffleInput, ShuffleOutput, TableInput)

# Paper worker sizing: 4 vCPUs, 7,076 MiB RAM.
WORKER_VCPUS = 4
WORKER_MEM_GIB = 7076.0 / 1024.0
CPU_BYTES_PER_S = 600e6 * WORKER_VCPUS / 4   # scan+decode throughput
# The fused torch backend removes per-node temporaries and the per-partition
# shuffle rescan, so a worker sustains a higher scan+decode rate. These
# hand-set constants are the graceful fallback; when BENCH_engine.json is
# present, ``_cpu_bytes_per_s`` prefers the throughput this machine
# actually measured (``core.bench_profile``).
CPU_BYTES_PER_S_BY_BACKEND = {
    "numpy": CPU_BYTES_PER_S,
    "torch": 2.5 * CPU_BYTES_PER_S,
}


def _cpu_bytes_per_s(backend: str) -> float:
    return bench_profile.cpu_bytes_per_s(
        backend, CPU_BYTES_PER_S_BY_BACKEND[backend])
IO_THREADS = 32
S3_READ_MEDIAN_S = 0.027
S3_WRITE_MEDIAN_S = 0.040

# Modeled request-latency distributions per exchange tier (the paper's
# Fig 10 quantiles via ``storage_service.LatencyModel``); the fragment
# duration model charges each storage round trip wave at the expected
# max-of-m concurrent draws, so object-store tail latency — the paper's
# dominant exchange cost — shows up in modeled runtimes, and the KV
# tier's sub-millisecond barriers are what placement buys.
_TIER_PROFILES = {"object": S3_STANDARD_PROFILE, "kv": KV_MEMORY_PROFILE}
# Residency assumed for KV capacity rent when pricing a query's exchange:
# shuffle intermediates live for (about) the query's runtime.


@functools.lru_cache(maxsize=None)
def _tier_latency(tier: str, op: str) -> LatencyModel:
    prof = _TIER_PROFILES[tier]
    return LatencyModel(prof.read_latency_q if op == "read"
                        else prof.write_latency_q)


def _request_barrier(tier: str, op: str, n: int) -> float:
    """Modeled time a fragment blocks on ``n`` storage requests issued
    over ``IO_THREADS`` threads: each wave of m concurrent requests
    finishes at the expected max of m latency draws (~ the m/(m+1)
    quantile of the tier's distribution). For n=1 this is the median."""
    if n <= 0:
        return 0.0
    model = _tier_latency(tier, op)
    waves = math.ceil(n / IO_THREADS)
    m = min(n, IO_THREADS)
    return waves * model.quantile(m / (m + 1.0))


class QueryFailedError(RuntimeError):
    """A query exhausted its recovery ladder (fragment retries, then
    stage re-runs) and cannot produce a result.

    Carries a structured ``failure`` dict — ``{"kind", "stage",
    "attempts", "message"}`` — so the serving layer can surface a clean
    per-query error (``QueryResult.failure``) instead of a traceback."""

    def __init__(self, query_id: str, stage: str, attempts: int,
                 cause: BaseException):
        self.query_id = query_id
        self.failure = {
            "kind": getattr(cause, "kind", type(cause).__name__),
            "stage": stage,
            "attempts": attempts,
            "message": str(cause),
        }
        super().__init__(
            f"query {query_id!r} failed at stage {stage!r} after "
            f"{attempts} recovery attempt(s): "
            f"[{self.failure['kind']}] {cause}")


@dataclasses.dataclass
class QueryResult:
    name: str
    result: ColumnBatch
    runtime_s: float
    cumulated_worker_s: float
    faas_cost_usd: float
    storage_cost_usd: float
    stage_metrics: dict[str, dict]
    request_stats: RequestStats
    peak_workers: int
    stage_node_seconds: list[tuple[int, float]]
    # Compiled-plan cache observability (torch backend; empty/False on
    # numpy).
    plan_shape_hash: str = ""
    plan_cache_hit: bool = False
    # Per-tier storage cost breakdown: {"object": usd, "kv": usd}. The kv
    # entry prices requests + transfer + capacity rent over the query's
    # runtime; summed they equal ``storage_cost_usd``.
    exchange_cost_usd: dict = dataclasses.field(default_factory=dict)
    # Adaptive-execution observability (engine.adaptive; zero/empty under
    # the static coordinator): stage-boundary plan revisions taken, and
    # speculative duplicate fragments launched / won across all stages.
    # ``adaptive_trace`` holds the human-readable ``adaptive:`` decision
    # lines that ``explain`` renders.
    replans: int = 0
    speculative_launched: int = 0
    speculative_won: int = 0
    adaptive_trace: list = dataclasses.field(default_factory=list)
    # Out-of-core observability (zero without a per-worker memory
    # budget): frame bytes spilled to worker-local disk across all
    # fragments, and the largest per-fragment accounted memory peak.
    spill_bytes: int = 0
    mem_peak_bytes: int = 0
    # Structured failure surfaced by the serving layer when the recovery
    # ladder is exhausted: {"kind", "stage", "attempts", "message"}.
    # None for successful queries; a failed query carries an empty
    # result batch alongside it.
    failure: Optional[dict] = None


class Coordinator:
    def __init__(self, store: ObjectStore, mode: str = "elastic",
                 provisioned_slots: int = 256,
                 burst_aware: bool = True,
                 max_workers: int = 1024,
                 preboot: bool = True,
                 rng_seed: int = 0,
                 backend: str = "torch",
                 device: str = "cuda",
                 kv_store: Optional[ObjectStore] = None,
                 chaos=None,
                 memory_budget: Optional[float] = None,
                 morsel_rows: Optional[int] = None):
        if mode not in ("elastic", "provisioned"):
            raise ValueError(mode)
        if backend not in CPU_BYTES_PER_S_BY_BACKEND:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "torch":
            engine_compile.resolve_device(device)   # no card: raise now
        self.device = device
        self.store = store
        # Memory-grade exchange tier for kv-placed shuffles; base tables
        # and results always stay on the object store.
        self.kv_store = kv_store if kv_store is not None else KVStore()
        self.mode = mode
        self.backend = backend
        self.burst_aware = burst_aware
        self.max_workers = max_workers
        if mode == "elastic":
            self.pool = ElasticPool(rng_seed=rng_seed, chaos=chaos)
            self.bucket = token_bucket.LAMBDA_INBOUND
        else:
            # Paper Table 6: "the VMs are started before the experiment".
            self.pool = ProvisionedPool(provisioned_slots,
                                        boot_s=0.0 if preboot else 45.0)
            self.bucket = token_bucket.ec2_bucket(
                pricing.EC2_CATALOG["c6g.xlarge"])
        # Optional fault injection (core.chaos.ChaosPolicy): the scheduler
        # draws per-fragment slowdowns from it; callers attach the same
        # policy to the stores for drops/throttles.
        self.chaos = chaos
        # Per-worker memory cap in bytes (ROADMAP item 4). None keeps
        # the legacy whole-fragment workers; a cap makes every fragment
        # stream bounded morsels and spill past its grant, and feeds the
        # planner's memory-pressure fan-out term. ``morsel_rows``
        # overrides the budget-derived morsel bound (tests/bench).
        self.memory_budget = memory_budget
        self.morsel_rows = morsel_rows
        self.scheduler = StageScheduler(self.pool, StragglerPolicy(),
                                        rng_seed=rng_seed, chaos=chaos)
        self.table_keys: dict[str, list[str]] = {}

    def register_table(self, name: str, keys: list[str]) -> None:
        self.table_keys[name] = keys

    # ------------------------------------------------------------------
    def run(self, plan, query_id: Optional[str] = None) -> QueryResult:
        """Execute a query given either a physical ``QueryPlan`` or a
        logical ``logical.LogicalQuery``. Logical plans are optimized and
        lowered here with statistics from the registered tables, so the
        planner's fan-out and build-side choices see real object sizes
        and this coordinator's backend throughput."""
        if isinstance(plan, LogicalQuery):
            stats = optimizer.Stats.from_store(self.store, self.table_keys)
            plan, _report = optimizer.lower(
                plan, stats=stats, backend=self.backend,
                memory_budget=self.memory_budget)
        return self.execute(plan, query_id)

    def execute(self, plan: QueryPlan, query_id: Optional[str] = None
                ) -> QueryResult:
        plan.validate()   # fail fast, not as a KeyError mid-stage
        query_id = query_id or plan.name
        shape_hash, cache_hit = "", False
        if self.backend == "torch":
            # Compiled-plan cache: a hit means every canonical trace key
            # this plan's fragments will look up is already resident.
            shape_hash, cache_hit = engine_compile.PLAN_CACHE.lookup(plan)
        stats_before = dataclasses.replace(self.store.stats)
        kv_stats_before = dataclasses.replace(self.kv_store.stats)
        # Per-query shuffle bitmap registry: writers record which
        # partitions they produced, missing_ok readers validate absences.
        registry = worker.ShuffleRegistry()
        stages, frag_counts = self._compile(plan, query_id, registry)
        results = self.scheduler.run(stages)
        return self.finalize(plan, query_id, frag_counts, results,
                             stats_before, shape_hash, cache_hit,
                             kv_stats_before=kv_stats_before)

    def finalize(self, plan: QueryPlan, query_id: str,
                 frag_counts: dict[str, int], results: dict,
                 stats_before: RequestStats, shape_hash: str = "",
                 cache_hit: bool = False,
                 kv_stats_before: Optional[RequestStats] = None,
                 adaptive_trace: Optional[list] = None,
                 replans: int = 0) -> QueryResult:
        """Merge the terminal pipeline's collect fragments and account
        runtime/cost from the per-stage results — shared by the
        single-query path above and the multi-query server (which runs
        the stages through its own interleaving scheduler)."""
        # Merge collected fragments of the terminal pipeline.
        terminal = plan.pipelines[-1]
        merged = self._merge_collect(query_id, terminal,
                                     frag_counts[terminal.name])

        runtime = max(r.end_t for r in results.values())
        node_seconds = sum(r.node_seconds for r in results.values())
        stage_nodes = [(r.worker_count, r.node_seconds)
                       for r in results.values()]
        invocations = sum(r.worker_count for r in results.values())
        faas_cost = pricing.lambda_cost(
            WORKER_MEM_GIB, node_seconds / max(invocations, 1),
            invocations=invocations)
        # Coordinator function lifetime spans the query.
        faas_cost += pricing.lambda_cost(WORKER_MEM_GIB, runtime)

        def _delta(now: RequestStats, before: RequestStats) -> RequestStats:
            return RequestStats(**{
                f.name: getattr(now, f.name) - getattr(before, f.name)
                for f in dataclasses.fields(RequestStats)})

        delta = _delta(dataclasses.replace(self.store.stats), stats_before)
        kv_delta = _delta(
            dataclasses.replace(self.kv_store.stats),
            kv_stats_before if kv_stats_before is not None
            else RequestStats())
        # Per-tier exchange cost: the object tier bills requests +
        # transfer; the kv tier additionally rents capacity for the
        # shuffle bytes resident over the query's runtime.
        object_usd = delta.cost(self.store.prices)
        kv_usd = kv_delta.cost(
            self.kv_store.prices,
            capacity_gib_s=kv_delta.write_bytes / (1024.0 ** 3) * runtime)
        merged_stats = dataclasses.replace(delta)
        merged_stats.merge(kv_delta)
        spec_launched = sum(getattr(r, "speculative_launched", 0)
                            for r in results.values())
        spec_won = sum(getattr(r, "speculative_won", 0)
                       for r in results.values())
        frag_metrics = [m for r in results.values() for m in r.results
                        if m is not None]
        spill_bytes = sum(getattr(m, "spill_bytes", 0)
                          for m in frag_metrics)
        mem_peak = max((getattr(m, "mem_peak_bytes", 0)
                        for m in frag_metrics), default=0)
        return QueryResult(
            name=plan.name, result=merged, runtime_s=runtime,
            cumulated_worker_s=node_seconds, faas_cost_usd=faas_cost,
            storage_cost_usd=object_usd + kv_usd, stage_metrics={
                n: {"start": r.start_t, "end": r.end_t,
                    "duration": r.end_t - r.start_t,
                    "workers": r.worker_count,
                    "retried": r.retried_fragments,
                    "speculative": getattr(r, "speculative_launched", 0)}
                for n, r in results.items()},
            request_stats=merged_stats, peak_workers=max(
                r.worker_count for r in results.values()),
            stage_node_seconds=stage_nodes,
            plan_shape_hash=shape_hash, plan_cache_hit=cache_hit,
            exchange_cost_usd={"object": object_usd, "kv": kv_usd},
            replans=replans, speculative_launched=spec_launched,
            speculative_won=spec_won,
            adaptive_trace=list(adaptive_trace or []),
            spill_bytes=spill_bytes, mem_peak_bytes=mem_peak)

    # ------------------------------------------------------------------
    def compile_stages(self, plan: QueryPlan, query_id: str,
                       registry: Optional[worker.ShuffleRegistry] = None
                       ) -> tuple[list[Stage], dict[str, int]]:
        """Compile a physical plan into schedulable stages. Public entry
        for the multi-query server, which pools stages from many queries
        into one scheduler run."""
        plan.validate()
        return self._compile(plan, query_id, registry)

    def _compile(self, plan: QueryPlan, query_id: str,
                 registry: Optional[worker.ShuffleRegistry] = None
                 ) -> tuple[list[Stage], dict[str, int]]:
        frag_counts: dict[str, int] = {}
        stages: list[Stage] = []
        # Shuffle fan-out agreed between a pipeline's writers and its
        # readers — per compile, so concurrent queries reusing pipeline
        # names (every q12 names its pipelines the same) cannot collide.
        shuffle_spec: dict[str, int] = {}
        # Exchange tier each pipeline's shuffle output rides, so consumer
        # fragments read from the store their producers wrote to.
        tier_spec: dict[str, str] = {}
        for pipe in plan.pipelines:
            stages.append(self._compile_pipeline(plan, pipe, query_id,
                                                 registry, frag_counts,
                                                 shuffle_spec, tier_spec))
        return stages, frag_counts

    def _compile_pipeline(self, plan: QueryPlan, pipe: Pipeline,
                          query_id: str,
                          registry: Optional[worker.ShuffleRegistry],
                          frag_counts: dict[str, int],
                          shuffle_spec: dict[str, int],
                          tier_spec: dict[str, str]) -> Stage:
        """Compile ONE pipeline into a schedulable stage, recording its
        fragment count / shuffle fan-out / tier in the shared per-compile
        maps. Factored out of ``_compile`` so the adaptive executor can
        compile stage-at-a-time, revising the not-yet-compiled rest of
        the plan between stages."""
        n_frags, assignments = self._parallelism(pipe, frag_counts,
                                                 query_id, shuffle_spec)
        frag_counts[pipe.name] = n_frags
        fragments = []
        for i in range(n_frags):
            spec = self._fragment_spec(plan, pipe, query_id, i,
                                       assignments, frag_counts,
                                       shuffle_spec, tier_spec)
            frag = Fragment(fragment_id=i, work=None)

            def work(s=spec, f=frag, attempt=0, memory_budget=None):
                # Estimate at execution time, not compile time:
                # shuffle intermediates do not exist when the plan
                # compiles, but by a stage's start its producers
                # have written, so the scheduler (which reads the
                # estimate after running the work) models
                # shuffle-heavy stages on the bytes they REALLY
                # move. Recovery re-runs pass ``attempt`` (so shuffle
                # writes land under a fresh attempt key) and, after an
                # OOM kill, a ``memory_budget`` that forces the spill
                # path.
                if attempt or memory_budget is not None:
                    s = dataclasses.replace(
                        s, attempt=attempt,
                        memory_budget=(memory_budget
                                       if memory_budget is not None
                                       else s.memory_budget))
                f.est_duration_s, f.input_bytes = self._estimate(s)
                return worker.execute_fragment(self.store, s,
                                               registry=registry,
                                               kv_store=self.kv_store,
                                               chaos=self.chaos)

            frag.work = work
            frag.rerun = work
            fragments.append(frag)
        return Stage(pipe.name, fragments, deps=pipe.deps())

    def _parallelism(self, pipe: Pipeline, frag_counts: dict[str, int],
                     query_id: str, shuffle_spec: dict[str, int]
                     ) -> tuple[int, list[list[str]]]:
        if isinstance(pipe.input, TableInput):
            keys = self.table_keys[pipe.input.table]
            if pipe.partitioning is not None \
                    and len(keys) != pipe.partitioning["fanout"]:
                # A declared pre-partitioned layout the planner relied on:
                # stored partition i must BE fragment i, which needs
                # exactly fanout objects registered for the table.
                raise ValueError(
                    f"pipeline {pipe.name!r} relies on table "
                    f"{pipe.input.table!r} being stored as "
                    f"{pipe.partitioning['fanout']} hash partitions, but "
                    f"{len(keys)} objects are registered")
            part_bytes = float(np.mean([self.store.size(k) for k in keys])) \
                if keys else 1.0
            if pipe.fragments:
                n = min(pipe.fragments, len(keys))
            elif self.burst_aware:
                # Paper Fig 14: keep each worker's scan inside its burst.
                sp = burst_planner.plan_scan(
                    part_bytes * len(keys), part_bytes, self.max_workers,
                    bucket=self.bucket,
                    cpu_bytes_per_s=_cpu_bytes_per_s(self.backend))
                n = sp.workers
            else:
                n = max(1, math.ceil(len(keys) / 4))
            n = max(1, min(n, len(keys)))
            bounds = np.linspace(0, len(keys), n + 1).astype(int)
            return n, [keys[bounds[i]:bounds[i + 1]] for i in range(n)]
        # Shuffle consumer: parallelism = upstream shuffle partition count
        # (readers must align with the writers' partitioning).
        src = pipe.input.from_pipeline
        return shuffle_spec[src], []

    def _fragment_spec(self, plan: QueryPlan, pipe: Pipeline, query_id: str,
                       i: int, assignments: list[list[str]],
                       frag_counts: dict[str, int],
                       shuffle_spec: dict[str, int],
                       tier_spec: Optional[dict[str, str]] = None
                       ) -> worker.FragmentSpec:
        tier_spec = tier_spec if tier_spec is not None else {}
        read_tier = read_tier2 = "object"
        if isinstance(pipe.input, TableInput):
            read_keys = assignments[i]
            columns = pipe.input.columns
            missing_ok = False
        else:
            src = pipe.input.from_pipeline
            read_keys = [worker.shuffle_key(query_id, src, w, i)
                         for w in range(frag_counts[src])]
            columns = None
            missing_ok = True   # writers skip empty shuffle partitions
            read_tier = tier_spec.get(src, "object")
        read_keys2: list[str] = []
        columns2 = None
        missing_ok2 = True
        if isinstance(pipe.input2, TableInput):
            # Declared hash-partitioned build table: fragment i reads the
            # table's stored partition object i directly — no shuffle
            # objects exist for this side.
            keys2 = self.table_keys[pipe.input2.table]
            n_frags = frag_counts[pipe.name]
            if len(keys2) != n_frags:
                raise ValueError(
                    f"pipeline {pipe.name!r} reads build table "
                    f"{pipe.input2.table!r} as {n_frags} direct partition "
                    f"slices, but {len(keys2)} objects are registered")
            read_keys2 = [keys2[i]]
            columns2 = pipe.input2.columns
            missing_ok2 = False
        elif pipe.input2 is not None:
            src2 = pipe.input2.from_pipeline
            read_keys2 = [worker.shuffle_key(query_id, src2, w, i)
                          for w in range(frag_counts[src2])]
            read_tier2 = tier_spec.get(src2, "object")
        if isinstance(pipe.output, ShuffleOutput):
            shuffle_spec[pipe.name] = pipe.output.partitions
            tier_spec[pipe.name] = pipe.output.tier
            output = {"type": "shuffle",
                      "partition_by": pipe.output.partition_by,
                      "partitions": pipe.output.partitions,
                      "tier": pipe.output.tier}
        else:
            output = {"type": "collect"}
        return worker.FragmentSpec(
            query_id=query_id, pipeline=pipe.name, fragment=i,
            read_keys=read_keys, read_keys2=read_keys2, columns=columns,
            ops=pipe.ops, join=pipe.join, output=output,
            backend=self.backend, device=self.device,
            missing_ok=missing_ok,
            partitioning=pipe.partitioning,
            partitioning2=pipe.partitioning2, columns2=columns2,
            missing_ok2=missing_ok2,
            read_tier=read_tier, read_tier2=read_tier2,
            memory_budget=self.memory_budget,
            morsel_rows=self.morsel_rows)

    def _tier_store(self, tier: str) -> ObjectStore:
        return self.kv_store if tier == "kv" else self.store

    def _estimate(self, spec: worker.FragmentSpec) -> tuple[float, float]:
        """Model-time duration of a fragment: burst-limited network transfer
        + per-tier request-latency barriers + CPU scan throughput. Reads
        and writes are charged per wave at the expected max of the
        concurrent draws on the tier each side actually rides
        (``_request_barrier``), so object-store exchange tail latency —
        the paper's dominant e2e term — is what KV placement removes."""
        in_bytes = 0
        req = 0.0
        for keys, tier in ((spec.read_keys, spec.read_tier),
                           (spec.read_keys2, spec.read_tier2)):
            if not keys:
                continue
            st = self._tier_store(tier)
            for k in keys:
                try:
                    in_bytes += st.size(k)
                except KeyError:
                    pass  # shuffle object not yet written; sized at runtime
            req += _request_barrier(tier, "read", len(keys))
        out = spec.output
        if out.get("type") == "shuffle":
            req += _request_barrier(out.get("tier", "object"), "write",
                                    out["partitions"])
        else:
            req += _request_barrier("object", "write", 1)
        net = token_bucket.transfer_time(float(in_bytes), self.bucket)
        cpu_bw = _cpu_bytes_per_s(self.backend)   # measured when available
        cpu = 2.0 * in_bytes / cpu_bw  # ~2x decompression expansion
        return net + req + cpu + 0.02, float(in_bytes)

    def _merge_collect(self, query_id: str, pipe: Pipeline, n_frags: int
                       ) -> ColumnBatch:
        batches = []
        for i in range(n_frags):
            data = self.store.get(worker.result_key(query_id, pipe.name, i))
            batches.append(columnar.deserialize(data))
        return ColumnBatch.concat(batches)
