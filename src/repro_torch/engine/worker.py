"""Query worker: executes one pipeline fragment (paper §3.2).

A worker parses its fragment spec, reads its input partitions in batches
from shared storage (with projection pushdown), executes the vectorized
operator chain (torch on the fragment's device by default,
numpy-interpreted for the
semantic reference, per the fragment's ``backend``), partitions its
output, and writes it back to storage. Workers never talk to each other —
all communication is through the object store, as serverless functions
require.

The equi-join is a pipeline op (``{"op": "hash_join", ...}``): the worker
resolves the build-side read into the op spec and hands the whole chain to
``engine_compile`` — on the torch backend the join probe (duplicate build
keys included), the downstream operators, and the shuffle's radix
partition assignment trace as one compiled call
(``run_pipeline_partition``; a trailing partial ``hash_agg`` partitioned
by its own group key aggregates per partition slice so the segment still
traces whole); the numpy backend keeps the interpreted reference
semantics. Legacy ``FragmentSpec.join`` specs are normalized into a
leading ``hash_join`` op.

Shuffle hardening: shuffle objects are **attempt-scoped** — every key
carries the writing attempt's number, and a fragment publishes its
attempt only through an explicit end-of-write ``ShuffleRegistry.commit``
(first committer wins; later attempts are quarantined). A worker that
dies mid-write (``WorkerKilled`` — injected by ``core.chaos``) leaves
only unreachable garbage: readers resolve every shuffle key through the
committed attempt (``resolve_committed``) and refuse to read a writer
with no commit, so a consumer can never observe a partial write. Within
a committed attempt, each writer's partition bitmap
(``FragmentMetrics.partitions_written``) still tells a skipped-empty
partition (clear bit, fine) from a lost write (set bit, fail loudly).
Standalone fragments executed without a registry keep the legacy
tolerant behaviour.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import memory as core_memory
from repro_torch.core.storage_service import ObjectStore
from repro_torch.engine import columnar, compile as engine_compile, operators, \
    spill
from repro_torch.engine.columnar import ColumnBatch

# Re-exported: the single-pass radix partitioner lives in ``operators`` so
# both execution backends share it without circular imports.
radix_partition = operators.radix_partition
radix_partition_iter = operators.radix_partition_iter

# Out-of-core tuning: a streamed morsel targets this fraction of the
# worker's memory cap (so a handful of morsels plus one partition's
# output fit comfortably), floored so pathological caps cannot degrade
# into row-at-a-time execution.
MORSEL_BUDGET_FRACTION = 1.0 / 16.0
MIN_MORSEL_ROWS = 1024


@dataclasses.dataclass
class FragmentSpec:
    query_id: str
    pipeline: str
    fragment: int
    read_keys: list[str]                # input objects (side 0)
    read_keys2: list[str]               # build-side objects (joins)
    columns: list[str] | None           # projection pushdown for table scans
    ops: list[dict]
    join: dict | None = None            # legacy: prepended as a hash_join op
    output: dict = dataclasses.field(default_factory=dict)
    backend: str = "torch"              # "torch" (default) | "numpy" (reference)
    device: str = "cuda"                # torch device the data plane runs on
    missing_ok: bool = False            # inputs may be skipped-empty objects
    # Input partitioning the planner RELIED on to elide a shuffle
    # ({"key": ..., "fanout": n}, from ``Pipeline.partitioning``): this
    # fragment must hold exactly the rows with ``key % fanout ==
    # fragment``, and the worker verifies that against the actual key
    # values before executing — a violated property would silently
    # duplicate or split groups instead of erroring. ``partitioning2``
    # is the build side's declared layout when ``read_keys2`` point at a
    # base table's stored partition slices instead of shuffle objects
    # (``columns2`` projects them; such reads are not missing-tolerant).
    partitioning: dict | None = None
    partitioning2: dict | None = None
    columns2: list[str] | None = None
    missing_ok2: bool = True            # build side defaults to shuffle reads
    # Exchange tier each shuffle-read side rides ("object" | "kv", from the
    # producing pipeline's ``ShuffleOutput.tier``); the output dict carries
    # its own "tier". Table scans and collect results are always object-tier.
    read_tier: str = "object"
    read_tier2: str = "object"
    # Out-of-core execution (ROADMAP item 4): per-worker memory cap in
    # bytes. None keeps the legacy whole-fragment materialization; a cap
    # streams scans/join probes in bounded morsels, accounts every
    # materialization against a ``core.memory.MemoryBudget``, and spills
    # partition buffers / join builds to frame files when a grant
    # refuses. ``morsel_rows`` bounds a streamed morsel explicitly
    # (None derives it from the cap and the observed row width).
    memory_budget: float | None = None
    morsel_rows: int | None = None
    # Execution attempt of this fragment (0 = first run). Shuffle writes
    # are keyed by it; recovery re-runs bump it so a retried attempt's
    # objects never collide with a crashed attempt's partial prefix.
    attempt: int = 0


class WorkerKilled(RuntimeError):
    """The worker executing a fragment died mid-flight (crash, OOM, or a
    terminal store/invocation error). Carries the identity the recovery
    ladder needs to re-run exactly the dead attempt."""

    def __init__(self, pipeline: str, fragment: int, attempt: int,
                 kind: str = "crash", detail: str = ""):
        super().__init__(
            f"worker killed ({kind}): pipeline {pipeline!r} fragment "
            f"{fragment} attempt {attempt}" + (f" — {detail}" if detail
                                               else ""))
        self.pipeline = pipeline
        self.fragment = fragment
        self.attempt = attempt
        self.kind = kind


class WorkerOOMKilled(WorkerKilled):
    """OOM kill: the fragment's working set crossed the platform memory
    cap. ``threshold_bytes`` is the cap — recovery re-runs the attempt
    with ``memory_budget=threshold_bytes`` so the retry takes the
    spill-aware out-of-core path instead of re-OOMing."""

    def __init__(self, pipeline: str, fragment: int, attempt: int,
                 threshold_bytes: int):
        super().__init__(pipeline, fragment, attempt, kind="oom",
                         detail=f"working set over {threshold_bytes} B")
        self.threshold_bytes = threshold_bytes


@dataclasses.dataclass
class FragmentMetrics:
    read_requests: int = 0
    write_requests: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    rows_in: int = 0
    rows_out: int = 0
    partitions_written: int = 0         # bitmap over shuffle partition ids
    # Out-of-core accounting (zero under the legacy unbudgeted path):
    # frame bytes spilled to local disk, accumulator flush rounds, and
    # the budget's peak/overcommit watermarks (``core.memory``).
    spill_bytes: int = 0
    spill_rounds: int = 0
    mem_peak_bytes: int = 0
    mem_overcommit_bytes: int = 0
    mem_cap_bytes: int = 0


class ShuffleRegistry:
    """Per-query record of committed shuffle attempts and their partition
    bitmaps.

    Attempt-scoped commit protocol: a writer's shuffle objects carry its
    attempt number, and nothing is visible to readers until the writer's
    explicit end-of-write ``commit``. The FIRST attempt to commit wins a
    writer's slot; a slower duplicate or a superseded retry that commits
    later is quarantined (counted, its objects ignored). A killed attempt
    never commits, so its partial partition prefix is unreachable garbage
    — that is the whole safety argument for crash recovery.
    """

    def __init__(self):
        self._attempts: dict[tuple[str, str, int, int], int] = {}
        self._committed: dict[tuple[str, str, int], int] = {}
        self.quarantined = 0

    def commit(self, query_id: str, pipeline: str, writer: int,
               attempt: int, bitmap: int) -> bool:
        """Publish one attempt's written-partition bitmap. Returns True
        iff this attempt owns (or already owned — idempotent re-commit)
        the writer's slot; False when another attempt committed first."""
        self._attempts[(query_id, pipeline, writer, attempt)] = bitmap
        ident = (query_id, pipeline, writer)
        current = self._committed.get(ident)
        if current is None or current == attempt:
            self._committed[ident] = attempt
            return True
        self.quarantined += 1
        return False

    def record(self, query_id: str, pipeline: str, writer: int,
               bitmap: int) -> None:
        """Legacy single-attempt API: commit attempt 0."""
        self.commit(query_id, pipeline, writer, 0, bitmap)

    def committed_attempt(self, query_id: str, pipeline: str,
                          writer: int) -> Optional[int]:
        return self._committed.get((query_id, pipeline, writer))

    def bitmap(self, query_id: str, pipeline: str, writer: int
               ) -> Optional[int]:
        """The committed attempt's bitmap (None when nothing committed)."""
        attempt = self._committed.get((query_id, pipeline, writer))
        if attempt is None:
            return None
        return self._attempts[(query_id, pipeline, writer, attempt)]

    def validate_missing(self, key: str) -> None:
        """Raise if ``key`` names a shuffle object its writer's committed
        attempt reported written; silently accept keys in other
        namespaces."""
        parsed = parse_shuffle_key(key)
        if parsed is None:
            return
        query_id, pipeline, writer, part, attempt = parsed
        committed = self.committed_attempt(query_id, pipeline, writer)
        if committed is None or committed != attempt:
            raise RuntimeError(
                f"shuffle object {key!r} belongs to an uncommitted "
                f"attempt (committed: {committed}) — a reader must never "
                "touch a partial write")
        bm = self._attempts[(query_id, pipeline, writer, committed)]
        if (bm >> part) & 1:
            raise RuntimeError(
                f"shuffle object {key!r} was reported written by fragment "
                f"{writer} of pipeline {pipeline!r} but is missing from "
                "storage: lost or mis-keyed write")


def resolve_committed(key: str,
                      registry: Optional[ShuffleRegistry]) -> str:
    """Map a shuffle key onto the writer's committed attempt.

    Consumers' read keys are compiled with attempt 0; when recovery
    published a later attempt, the committed attempt's objects are the
    only real ones. A writer with NO committed attempt is a protocol
    violation (reading ahead of — or across — a crash) and fails loudly:
    whatever objects exist under that writer are a partial, uncommitted
    prefix. Non-shuffle keys and registry-less (standalone) execution
    pass through untouched."""
    if registry is None:
        return key
    parsed = parse_shuffle_key(key)
    if parsed is None:
        return key
    query_id, pipeline, writer, part, attempt = parsed
    committed = registry.committed_attempt(query_id, pipeline, writer)
    if committed is None:
        raise RuntimeError(
            f"shuffle read of {key!r}: writer {writer} of pipeline "
            f"{pipeline!r} has no committed attempt — refusing to read a "
            "possibly partial uncommitted write")
    if committed == attempt:
        return key
    return shuffle_key(query_id, pipeline, writer, part,
                       attempt=committed)


def _resolve_broadcasts(store: ObjectStore, ops: list[dict],
                        metrics: FragmentMetrics) -> list[dict]:
    """Load broadcast side-inputs referenced by UDF ops (small dims, e.g.
    the 75 MiB item table for TPCx-BB Q3) into kwargs arrays."""
    out = []
    for spec in ops:
        if spec.get("broadcast"):
            spec = dict(spec)
            kwargs = dict(spec.get("kwargs", {}))
            for arg, ref in spec["broadcast"].items():
                data = store.get(ref["key"])
                metrics.read_requests += 1
                metrics.read_bytes += len(data)
                kwargs[arg] = columnar.deserialize(data)[ref["column"]]
            spec["kwargs"] = kwargs
            spec = {k: v for k, v in spec.items() if k != "broadcast"}
        out.append(spec)
    return out


def _read_side(store: ObjectStore, keys: list[str], columns,
               metrics: FragmentMetrics, missing_ok: bool = False,
               registry: Optional[ShuffleRegistry] = None) -> ColumnBatch:
    batches = []
    for key in keys:
        key = resolve_committed(key, registry)
        try:
            data = store.retrying_get(key)
        except KeyError:
            if missing_ok:   # empty shuffle partition: writer skipped it
                if registry is not None:
                    registry.validate_missing(key)
                metrics.read_requests += 1   # the 404 probe is a request
                continue
            raise
        metrics.read_requests += 1
        metrics.read_bytes += len(data)
        batches.append(columnar.deserialize(data, columns))
    batch = ColumnBatch.concat(batches)
    metrics.rows_in += batch.num_rows
    return batch


def _normalize_ops(store: ObjectStore, spec: FragmentSpec,
                   metrics: FragmentMetrics,
                   registry: Optional[ShuffleRegistry],
                   build_store: Optional[ObjectStore] = None,
                   budget: Optional[core_memory.MemoryBudget] = None
                   ) -> list[dict]:
    """Resolve the op chain to executable form: legacy ``spec.join``
    becomes a leading ``hash_join`` op, build-side reads resolve into the
    join op specs, broadcast side-inputs load into UDF kwargs.
    ``build_store`` is the exchange tier the build-side shuffle rode
    (defaults to ``store``; broadcasts always load from ``store``).

    Under a memory ``budget`` the resolved build side is charged to a
    ``join_build`` grant; when the grant refuses, the build is demoted to
    a spilled frame file (``spill.spill_build``) whose columns read back
    as zero-copy views over file-backed pages — same values, same probe
    semantics, but reclaimable memory instead of anonymous heap."""
    ops = list(spec.ops)
    if spec.join is not None:
        ops.insert(0, {"op": "hash_join", **spec.join})
    join_ops = [op for op in ops if op.get("op") == "hash_join"]
    if join_ops:
        # Build side: shuffle objects are missing-tolerant (writers skip
        # empty partitions); direct table-partition reads are not.
        build = _read_side(build_store or store, spec.read_keys2,
                           spec.columns2, metrics,
                           missing_ok=spec.missing_ok2, registry=registry)
        _validate_partitioning(build, spec.partitioning2, spec,
                               side="build")
        if budget is not None and build.num_rows:
            grant = budget.grant("join_build")
            if not grant.try_reserve(build.nbytes()):
                build = spill.spill_build(build)
        resolved = []
        for op in ops:
            if op.get("op") == "hash_join" and "build" not in op:
                op = {**op, "build": build}
            resolved.append(op)
        ops = resolved
    return _resolve_broadcasts(store, ops, metrics)


def partition_class_bitmap(batch: ColumnBatch, key: str, fanout: int) -> int:
    """Bitmap of the ``key % fanout`` classes present in a batch, under
    the exact assignment rule ``operators.radix_partition`` uses (int64
    truncation then modulo).

    This is the summarized form of the runtime co-partition check: a
    stored partition slice i of a declared-partitioned table must have
    bitmap ``1 << i`` (or 0 when empty). The adaptive executor probes it
    at a stage boundary to demote a skew-violating elided join *before*
    the worker's fail-loud validation would abort the stage."""
    if batch.num_rows == 0:
        return 0
    classes = np.unique(np.asarray(batch[key]).astype(np.int64)
                        % int(fanout))
    bitmap = 0
    for c in classes:
        bitmap |= 1 << int(c)
    return bitmap


def _validate_partitioning(batch: ColumnBatch, part: Optional[dict],
                           spec: FragmentSpec, side: str = "input") -> None:
    """Verify a relied-on partitioning property against the actual data:
    every row's ``key % fanout`` must equal this fragment's id. Elided
    shuffles are only sound under that property, so a violation (lying
    ``Scan.partitioned_by`` declaration, mis-keyed shuffle) fails loudly
    here instead of producing silently wrong aggregates/joins."""
    if part is None or batch.num_rows == 0:
        return
    fanout = int(part["fanout"])
    if fanout <= 1:
        return   # a single fragment trivially holds every class
    key = np.asarray(batch[part["key"]])
    # Same assignment as operators.radix_partition: int64 truncation then
    # modulo, for EVERY dtype — so a float-keyed declaration is verified
    # under the exact rule the engine's partitioner uses, not skipped.
    got = key.astype(np.int64) % fanout
    bad = got != spec.fragment
    if bad.any():
        example = key[np.argmax(bad)]
        raise RuntimeError(
            f"pipeline {spec.pipeline!r} fragment {spec.fragment}: {side} "
            f"violates the relied-on partitioning hash({part['key']}) % "
            f"{fanout} ({int(bad.sum())} of {batch.num_rows} rows belong "
            f"to other partitions, e.g. key "
            f"{example!r}) — the planner elided a shuffle "
            "based on this property; the declared table layout or "
            "upstream shuffle is wrong")


def execute_fragment(store: ObjectStore, spec: FragmentSpec,
                     registry: Optional[ShuffleRegistry] = None,
                     kv_store: Optional[ObjectStore] = None,
                     chaos=None) -> FragmentMetrics:
    """Execute one fragment. ``store`` is the object tier (base tables,
    collect results and object-tier shuffles); ``kv_store`` is the
    memory-grade exchange tier for shuffle sides/outputs whose spec says
    ``"kv"``. Without a ``kv_store`` every tier falls back to ``store``
    (standalone fragments and legacy callers), keeping writes and reads
    consistently routed.

    With ``spec.memory_budget`` set the fragment runs out-of-core (see
    ``_execute_out_of_core``): same bytes written, same bits, bounded
    memory.

    ``chaos`` (a ``core.chaos.ChaosPolicy``) injects process-level
    faults: ``WorkerKilled`` after a deterministic prefix of the shuffle
    write, and ``WorkerOOMKilled`` when the unbudgeted working set
    crosses a chaos-chosen threshold."""
    def tier_store(tier: str) -> ObjectStore:
        return kv_store if tier == "kv" and kv_store is not None else store

    kill_after = None
    if chaos is not None:
        out = spec.output
        partitions = (int(out.get("partitions", 1))
                      if out.get("type") == "shuffle" else 1)
        kill_after = chaos.kill_after(spec.pipeline, spec.fragment,
                                      spec.attempt, partitions)

    metrics = FragmentMetrics()
    if spec.memory_budget is not None:
        return _execute_out_of_core(store, spec, metrics, registry,
                                    tier_store, kill_after=kill_after)
    return _execute_in_memory(store, spec, metrics, registry, tier_store,
                              chaos=chaos, kill_after=kill_after)


def _execute_in_memory(store: ObjectStore, spec: FragmentSpec,
                       metrics: FragmentMetrics,
                       registry: Optional[ShuffleRegistry],
                       tier_store, chaos=None,
                       kill_after: Optional[int] = None
                       ) -> FragmentMetrics:
    """Legacy whole-fragment materialization (no memory budget)."""
    batch = _read_side(tier_store(spec.read_tier), spec.read_keys,
                       spec.columns, metrics,
                       missing_ok=spec.missing_ok, registry=registry)
    _validate_partitioning(batch, spec.partitioning, spec)
    ops = _normalize_ops(store, spec, metrics, registry,
                         build_store=tier_store(spec.read_tier2))
    if chaos is not None:
        # OOM kill: inputs are read (the working set exists), nothing is
        # written yet. The recovery layer re-runs this attempt with
        # ``memory_budget=threshold_bytes`` so the retry spills.
        threshold = chaos.oom_threshold(spec.pipeline, spec.fragment,
                                        spec.attempt, metrics.read_bytes)
        if threshold is not None:
            raise WorkerOOMKilled(spec.pipeline, spec.fragment,
                                  spec.attempt, threshold)

    out = spec.output
    if out["type"] == "shuffle":
        parts = engine_compile.run_pipeline_partition(
            batch, ops, out["partition_by"], out["partitions"],
            backend=spec.backend, device=spec.device)
        _write_shuffle(enumerate(parts), spec, metrics,
                       tier_store(out.get("tier", "object")), registry,
                       kill_after=kill_after)
    else:
        if kill_after is not None:
            # Crash before the collect result lands; the retry rewrites
            # the (idempotent, byte-identical) result object.
            raise WorkerKilled(spec.pipeline, spec.fragment, spec.attempt)
        # Collect fragments route through the collapsed-agg-aware driver:
        # an elided (fragment-local, full) trailing hash_agg fuses with
        # its preceding segment exactly like a shuffle fragment's would.
        batch = engine_compile.run_pipeline_collect(batch, ops,
                                                    backend=spec.backend,
                                                    device=spec.device)
        _write_collect(batch, spec, metrics, store)
    return metrics


def _write_shuffle(parts, spec: FragmentSpec, metrics: FragmentMetrics,
                   wstore: ObjectStore,
                   registry: Optional[ShuffleRegistry],
                   kill_after: Optional[int] = None) -> None:
    """Write ``(partition, batch)`` pairs as attempt-scoped shuffle
    objects, then COMMIT the written-partition bitmap — the commit is the
    publication point; nothing written before it is visible to readers.
    Consumes lazily, so a chunked-emission producer
    (``radix_partition_iter``, a spill accumulator) holds only one
    partition's copy at a time. ``kill_after`` kills the worker after
    that many objects land (a deterministic partial prefix, never
    committed)."""
    bitmap = 0
    written = 0
    for part, sel in parts:
        if kill_after is not None and written >= kill_after:
            raise WorkerKilled(spec.pipeline, spec.fragment, spec.attempt,
                               detail=f"{written} partitions written")
        metrics.rows_out += sel.num_rows
        if sel.num_rows == 0:
            continue   # readers tolerate the missing object
        bitmap |= 1 << part
        data = columnar.serialize_frame(sel)
        wstore.put(shuffle_key(spec.query_id, spec.pipeline,
                               spec.fragment, part,
                               attempt=spec.attempt), data)
        written += 1
        metrics.write_requests += 1
        metrics.write_bytes += len(data)
    if kill_after is not None:
        # The chaos-chosen prefix exceeded the non-empty partition count:
        # the worker still dies before its commit.
        raise WorkerKilled(spec.pipeline, spec.fragment, spec.attempt,
                           detail=f"{written} partitions written")
    metrics.partitions_written = bitmap
    if registry is not None:
        registry.commit(spec.query_id, spec.pipeline, spec.fragment,
                        spec.attempt, bitmap)


def _write_collect(batch: ColumnBatch, spec: FragmentSpec,
                   metrics: FragmentMetrics, store: ObjectStore) -> None:
    metrics.rows_out = batch.num_rows
    data = columnar.serialize_frame(batch)
    store.put(result_key(spec.query_id, spec.pipeline, spec.fragment),
              data)
    metrics.write_requests += 1
    metrics.write_bytes += len(data)


# ---------------------------------------------------------------------------
# Out-of-core execution (ROADMAP item 4)
# ---------------------------------------------------------------------------

def _morsel_rows_for(batch: ColumnBatch, spec: FragmentSpec,
                     cap: Optional[int]) -> int:
    if spec.morsel_rows:
        return int(spec.morsel_rows)
    if cap is None or not batch.num_rows:
        return max(batch.num_rows, 1)
    row_bytes = max(1, batch.nbytes() // batch.num_rows)
    return max(MIN_MORSEL_ROWS,
               int(cap * MORSEL_BUDGET_FRACTION) // row_bytes)


def _iter_morsels(store: ObjectStore, spec: FragmentSpec,
                  metrics: FragmentMetrics,
                  registry: Optional[ShuffleRegistry],
                  budget: core_memory.MemoryBudget):
    """Stream the main input side object-by-object, slicing each object
    into budget-bounded morsels (zero-copy row views). Mirrors
    ``_read_side``'s missing-object handling and partitioning
    validation, morsel by morsel."""
    for key in spec.read_keys:
        key = resolve_committed(key, registry)
        try:
            data = store.retrying_get(key)
        except KeyError:
            if spec.missing_ok:
                if registry is not None:
                    registry.validate_missing(key)
                metrics.read_requests += 1   # the 404 probe is a request
                continue
            raise
        metrics.read_requests += 1
        metrics.read_bytes += len(data)
        batch = columnar.deserialize(data, spec.columns)
        _validate_partitioning(batch, spec.partitioning, spec)
        metrics.rows_in += batch.num_rows
        step = _morsel_rows_for(batch, spec, budget.cap_bytes)
        for lo in range(0, batch.num_rows, step):
            yield ColumnBatch({k: v[lo:lo + step]
                               for k, v in batch.items()})


def _execute_out_of_core(store: ObjectStore, spec: FragmentSpec,
                         metrics: FragmentMetrics,
                         registry: Optional[ShuffleRegistry],
                         tier_store,
                         kill_after: Optional[int] = None
                         ) -> FragmentMetrics:
    """Budgeted fragment execution: bounded morsels + spill, bit-identical
    output bytes vs ``_execute_in_memory`` on the same backend.

    Three shapes, chosen so every streamed decomposition matches what the
    in-memory driver computes internally (same driver functions, same
    traces — the differential spill-parity suite asserts the bits):

    * **streamable shuffle** (``filter|project|hash_join`` only): each
      morsel runs through ``run_pipeline_partition`` and its partition
      slices accumulate per-partition (spilling whole buffer rounds when
      the grant refuses); the stable radix partition makes
      concat-of-morsel-partitions identical to partitioning the concat.
    * **pre-agg shuffle** (streamable prefix + trailing ``hash_agg``
      keyed by the partition column): morsels stream the pre-agg ops,
      and the aggregate runs per partition at finalize — exactly the
      decomposition the torch partition-fusion driver (and the numpy
      stable lexsort/reduceat reference) already uses.
    * **barrier** (mid-chain agg/UDF, and every collect fragment): the
      numpy backend streams the row-local prefix; the torch backend
      accumulates raw morsels (its collect driver owns the fusion split,
      so re-splitting outside it could shift f32 association). Either
      way the accumulated batch — spilled and re-read as needed — feeds
      the unchanged in-memory driver, whose materialization is charged
      as a forced (recorded-overcommit) reservation: a full aggregate's
      working set is irreducible.
    """
    stats_before = dict(spill.SPILL_STATS)
    budget = core_memory.MemoryBudget(spec.memory_budget)
    ops = _normalize_ops(store, spec, metrics, registry,
                         build_store=tier_store(spec.read_tier2),
                         budget=budget)
    out = spec.output
    backend = spec.backend
    dev = {"device": spec.device}
    acc_grant = budget.grant("accumulator")
    morsels = _iter_morsels(tier_store(spec.read_tier), spec, metrics,
                            registry, budget)

    if out["type"] == "shuffle":
        key_col, r = out["partition_by"], out["partitions"]
        k = engine_compile.streamable_prefix(ops)
        trailing_agg = (len(ops) >= 2 and k == len(ops) - 1
                        and ops[-1]["op"] == "hash_agg"
                        and key_col in ops[-1]["keys"])
        wstore = tier_store(out.get("tier", "object"))
        if k == len(ops) or trailing_agg:
            pre_ops = ops[:-1] if trailing_agg else ops
            acc = spill.PartitionAccumulator(r, acc_grant)
            for m in morsels:
                for p, pb in enumerate(engine_compile.run_pipeline_partition(
                        m, pre_ops, key_col, r, backend=backend, **dev)):
                    acc.add(p, pb)

            def emit():
                grant = budget.grant("partition_emit")
                for p in range(r):
                    sel = acc.take(p)
                    # One partition materialized at a time — the chunked-
                    # emission peak the accounting asserts. A partition
                    # larger than the remaining headroom still has to
                    # materialize to be written (force records it).
                    grant.reserve(sel.nbytes(), force=True)
                    if trailing_agg and sel.num_rows:
                        sel = engine_compile.run_pipeline(
                            sel, [ops[-1]], backend=backend, **dev)
                    yield p, sel
                    grant.release_all()

            _write_shuffle(emit(), spec, metrics, wstore, registry,
                           kill_after=kill_after)
        else:
            # Mid-chain barrier: stream what is provably exact, then run
            # the unchanged driver over the accumulated remainder.
            k = k if backend == "numpy" else 0
            acc = spill.BatchAccumulator(acc_grant)
            for m in morsels:
                acc.add(m if k == 0 else
                        engine_compile.run_pipeline(m, ops[:k],
                                                    backend=backend, **dev))
            full = acc.finalize()
            parts = engine_compile.run_pipeline_partition(
                full, ops[k:], key_col, r, backend=backend, **dev)
            _write_shuffle(enumerate(parts), spec, metrics, wstore,
                           registry, kill_after=kill_after)
    else:
        k = engine_compile.streamable_prefix(ops) \
            if backend == "numpy" else 0
        acc = spill.BatchAccumulator(acc_grant)
        for m in morsels:
            acc.add(m if k == 0 else
                    engine_compile.run_pipeline(m, ops[:k],
                                                backend=backend, **dev))
        if kill_after is not None:
            raise WorkerKilled(spec.pipeline, spec.fragment, spec.attempt)
        full = acc.finalize()
        batch = engine_compile.run_pipeline_collect(full, ops[k:],
                                                    backend=backend, **dev)
        _write_collect(batch, spec, metrics, store)

    metrics.spill_bytes = \
        spill.SPILL_STATS["spill_bytes"] - stats_before["spill_bytes"]
    metrics.spill_rounds = \
        spill.SPILL_STATS["spill_rounds"] - stats_before["spill_rounds"]
    metrics.mem_peak_bytes = budget.peak_bytes
    metrics.mem_overcommit_bytes = budget.overcommit_bytes
    metrics.mem_cap_bytes = budget.cap_bytes or 0
    return metrics


def shuffle_key(query_id: str, pipeline: str, writer: int, part: int,
                attempt: int = 0) -> str:
    """Attempt-scoped shuffle object key. The attempt component is LAST so
    every ``shuffle/{query}/{pipeline}/`` prefix listing stays valid."""
    return (f"shuffle/{query_id}/{pipeline}/w{writer:04d}/r{part:04d}"
            f"/a{attempt:02d}")


def parse_shuffle_key(key: str
                      ) -> Optional[tuple[str, str, int, int, int]]:
    """Inverse of ``shuffle_key`` — ``(query, pipeline, writer, part,
    attempt)``; None for keys in other namespaces."""
    parts = key.split("/")
    if len(parts) != 6 or parts[0] != "shuffle":
        return None
    writer, part, attempt = parts[3], parts[4], parts[5]
    if not (writer.startswith("w") and part.startswith("r")
            and attempt.startswith("a")):
        return None
    try:
        return (parts[1], parts[2], int(writer[1:]), int(part[1:]),
                int(attempt[1:]))
    except ValueError:
        return None


def result_key(query_id: str, pipeline: str, fragment: int) -> str:
    return f"result/{query_id}/{pipeline}/frag-{fragment:04d}"
