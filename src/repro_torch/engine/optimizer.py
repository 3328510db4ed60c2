"""Optimizing planner: lowers the logical IR to physical pipelines.

Rule-based passes over ``engine.logical`` trees, in order:

1. **Predicate pushdown** — filter conjuncts move through projections
   (rewriting renamed columns) and join sides down into the scans, so
   workers drop rows before shuffling them (Lambada's first lesson: pay
   object-store I/O for as few bytes as possible).
2. **Projection pruning** — every scan's column list narrows to exactly
   the columns referenced above it; bare ``scan("t")`` column lists are
   inferred. UDF stages without a declared output schema keep their
   explicit scan columns.
3. **Aggregate split** — each ``hash_agg`` becomes a per-fragment partial
   aggregate in the producing pipeline plus a final re-aggregation after
   a combine shuffle; count partials re-aggregate as sums
   (``logical.FINAL_AGG_FN``). This retires the hand-rolled
   ``__zero__`` single-partition shuffle idiom: the combine shuffle
   partitions by the first group key (or the first aggregate output for
   global aggregates — any column works at fan-out 1).
4. **Partitioning properties & shuffle elision** — every pipeline under
   construction carries an output-partitioning property
   (``hash(key) % fanout``, i.e. fragment i holds exactly the rows with
   ``key % fanout == i``). The property is established by a
   ``ShuffleOutput`` (the consumer's fragments align with the radix
   partition), by a ``Scan`` whose table declares
   ``partitioned_by=(key, fanout)``, and it propagates through filters,
   projections (rename-aware) and joins (probe rows never move). Two
   elision rules consume it:

   * *combine elision* — an aggregate whose producing pipeline is
     already partitioned by one of its group keys (or lives in a single
     fragment) collapses the partial/final split into ONE fragment-local
     aggregation: group-key classes are fragment-disjoint, so no combine
     shuffle (write + read + final fragments) is needed at all.
   * *co-partition join elision* — a join side already partitioned by
     its join key at fan-out n continues in place as the probe (no row
     shuffle); the other side shuffles at the SAME fan-out (forced, hint
     ignored), or, when it is itself an already-co-partitioned
     pass-through, its producer's partition slices are read directly as
     the build input with no rewrite.

   Elided pipelines record the property they relied on in
   ``Pipeline.partitioning`` (checked by ``QueryPlan.validate()`` and
   re-verified against actual key values by the worker). The rule always
   emits a trace line — ``shuffle_elision: ... elided`` or
   ``shuffle_elision: ... kept (reason)`` — so ``explain`` shows it
   firing even when it changes nothing.

5. **Physical choices** — the join build side is the smaller estimated
   input (probe keeps its storage order and the build side is the one
   held in memory); shuffle fan-out is chosen so one partition is about
   ``TARGET_PARTITION_SECONDS`` of work at the measured
   ``core.bench_profile`` throughput (falling back to hand-set
   constants), clamped to [1, MAX_SHUFFLE_PARTITIONS]. An explicit
   ``LogicalQuery.shuffle_partitions`` hint pins the fan-out of ROW
   shuffles (join co-partitioning); aggregate-combine shuffles are
   optimizer-owned — the partial agg already shrank the data, so the
   combine follows its own (small) estimate, and a global aggregate's
   combine is always 1 partition (its partition key is a partial value,
   not a grouping key). Size estimates are column-width aware when
   ``Stats`` carries per-column dtype widths (``Stats.from_store`` peeks
   them from object headers): scans count only the bytes of the columns
   they read and projections scale by dtype width, so narrow-int tables
   stop being over-estimated in build-side and fan-out choices.

The emitted ``plans.QueryPlan`` uses only today's physical vocabulary, so
the numpy and torch backends (including the fused join->ops->partition
trace) run lowered plans unchanged. ``lower`` returns the plan plus a
``PlanReport`` recording every applied rule (rendered by
``engine.explain``); ``lower(..., shuffle_elision=False)`` disables the
elision rules (parity tests and the ``shuffle_elision`` benchmark lower
both variants from one logical query).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import bench_profile, breakeven
from repro_torch.engine import logical
from repro_torch.engine.logical import (Aggregate, Filter, Join, LogicalError,
                                  LogicalQuery, Project, Scan, Udf)
from repro_torch.engine.plans import (CollectOutput, Pipeline, QueryPlan,
                                ShuffleInput, ShuffleOutput, TableInput)

MIB = 1024.0 ** 2

# Physical-choice knobs. Fallback throughputs mirror the coordinator's
# hand-set constants; when BENCH_engine.json is present the measured
# numbers win (core.bench_profile).
FALLBACK_CPU_BYTES_PER_S = {"numpy": 600e6, "torch": 1.5e9}
TARGET_PARTITION_SECONDS = 0.25
MAX_SHUFFLE_PARTITIONS = 64
DEFAULT_SHUFFLE_PARTITIONS = 8      # no stats, no hint
FILTER_SELECTIVITY = 0.2            # default per-filter row survival
AGG_OUTPUT_FRACTION = 0.05          # partial-agg output / input estimate
AGG_EST_OUTPUT_BYTES = 1.0 * MIB    # fallback when the input is unsized
# Join elision forces the build side to the probe's existing fan-out; if
# that leaves per-fragment build slices beyond this multiple of the
# target partition size, the forced co-partitioning is too coarse and
# the size-based (unelided) plan wins.
ELIDE_BUILD_SLICE_FACTOR = 4.0


@dataclasses.dataclass
class Stats:
    """Planner-visible table statistics: bytes on the object store, plus
    (optional) per-column dtype widths so size estimates scale with the
    bytes a plan actually touches instead of a flat column count."""
    table_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    column_widths: dict[str, dict[str, int]] = \
        dataclasses.field(default_factory=dict)

    @staticmethod
    def from_store(store, table_keys: dict[str, list[str]]) -> "Stats":
        out: dict[str, float] = {}
        widths: dict[str, dict[str, int]] = {}
        for table, keys in table_keys.items():
            try:
                out[table] = float(sum(store.size(k) for k in keys))
            except KeyError:
                continue
            if keys:
                try:
                    # Header-only peek at the first partition object.
                    from repro_torch.engine import columnar
                    widths[table] = columnar.schema_widths(
                        store.get(keys[0]))
                except Exception:
                    pass   # width-unaware estimates still work
        return Stats(out, widths)

    def bytes_for(self, table: str) -> Optional[float]:
        return self.table_bytes.get(table)

    def widths_for(self, table: str) -> Optional[dict[str, int]]:
        return self.column_widths.get(table) or None


# Width assumed for derived/unknown columns (f64) in width-aware
# estimates.
DEFAULT_COLUMN_WIDTH = 8


# Fraction of a worker's memory cap one fragment's input may target:
# the rest is headroom for the partition buffers / join build / output
# the fragment materializes on top of its input. Fan-out derived from
# memory pressure keeps fragments inside this window when it can; past
# MAX_SHUFFLE_PARTITIONS the worker's morsel streaming + spill absorb
# the remainder.
MEMORY_TARGET_FRACTION = 0.5


def memory_fanout(est_bytes: Optional[float],
                  memory_budget: Optional[float]) -> int:
    """Minimum fan-out for one fragment's input slice to fit inside
    ``MEMORY_TARGET_FRACTION`` of the per-worker memory cap."""
    if est_bytes is None or not memory_budget:
        return 1
    return max(1, math.ceil(est_bytes /
                            (memory_budget * MEMORY_TARGET_FRACTION)))


def derive_fanout(est_bytes: Optional[float], backend: str,
                  bench_path: Optional[str] = None,
                  memory_budget: Optional[float] = None) -> int:
    """Size-based shuffle fan-out: one partition is about
    ``TARGET_PARTITION_SECONDS`` of work at the measured backend
    throughput — AND, under a per-worker ``memory_budget`` (bytes), small
    enough that a fragment's input slice fits its memory window
    (``memory_fanout``) — clamped to [1, MAX_SHUFFLE_PARTITIONS].

    Module-level because two layers make the same decision: lowering
    (``_Lowering._fanout``, from estimates) and the adaptive executor
    (``engine.adaptive``, from bytes observed at a stage boundary, which
    re-derives with the same memory term).
    """
    if est_bytes is None:
        return DEFAULT_SHUFFLE_PARTITIONS
    bw = bench_profile.cpu_bytes_per_s(
        backend, FALLBACK_CPU_BYTES_PER_S[backend], path=bench_path)
    n = max(math.ceil(est_bytes / (bw * TARGET_PARTITION_SECONDS)),
            memory_fanout(est_bytes, memory_budget))
    return max(1, min(MAX_SHUFFLE_PARTITIONS, n))


@dataclasses.dataclass
class PlanReport:
    """What the optimizer did: the rewritten logical tree plus one line
    per applied rule, in application order."""
    name: str
    rules: list[str]
    logical_root: object


# ---------------------------------------------------------------------------
# Pass 1: predicate pushdown
# ---------------------------------------------------------------------------

def _conjuncts(pred: list) -> list[list]:
    return list(pred[1:]) if pred[0] == "and" else [pred]


def _combine(preds: list[list]) -> list:
    return preds[0] if len(preds) == 1 else ["and"] + preds


def _rename_pred(expr: list, m: dict) -> list:
    op = expr[0]
    if op in ("and", "or"):
        return [op] + [_rename_pred(e, m) for e in expr[1:]]
    if op == "ltcol":
        return [op, m[expr[1]], m[expr[2]]]
    return [op, m[expr[1]]] + list(expr[2:])


def _wrap(node, stuck: list[tuple[list, bool]]):
    if not stuck:
        return node
    return Filter(node, _combine([p for p, _ in stuck]))


def _pushdown(node, preds: list[tuple[list, bool]], trace: list[str]):
    """Place each (predicate, crossed-a-boundary) pair as deep as it can
    go; record a rule line whenever a crossed predicate lands on a scan."""
    if isinstance(node, Filter):
        mine = [(c, False) for c in _conjuncts(node.predicate)]
        return _pushdown(node.child, preds + mine, trace)
    if isinstance(node, Scan):
        if not preds:
            return node
        crossed = sum(1 for _, c in preds if c)
        if crossed:
            trace.append(f"predicate_pushdown: {crossed} conjunct(s) "
                         f"pushed into scan({node.table})")
        return Filter(node, _combine([p for p, _ in preds]))
    if isinstance(node, Project):
        bindings = {}
        for c in node.columns:
            if isinstance(c, str):
                bindings[c] = c
            elif isinstance(c[1], str):
                bindings[c[0]] = c[1]           # pure rename
        pushable, stuck = [], []
        for p, crossed in preds:
            cols = logical.pred_columns(p)
            if cols <= set(bindings):
                pushable.append((_rename_pred(p, bindings), True))
            else:
                stuck.append((p, crossed))
        out = Project(_pushdown(node.child, pushable, trace), node.columns)
        return _wrap(out, stuck)
    if isinstance(node, Join):
        ls, rs = logical.schema(node.left), logical.schema(node.right)
        left, right, stuck = [], [], []
        for p, crossed in preds:
            cols = logical.pred_columns(p)
            if ls is not None and cols <= set(ls):
                left.append((p, True))
            elif rs is not None and cols <= set(rs):
                right.append((p, True))
            else:
                stuck.append((p, crossed))
        out = Join(_pushdown(node.left, left, trace),
                   _pushdown(node.right, right, trace),
                   node.left_on, node.right_on)
        return _wrap(out, stuck)
    if isinstance(node, Aggregate):
        out = Aggregate(_pushdown(node.child, [], trace), node.keys,
                        node.aggs)
        return _wrap(out, preds)
    if isinstance(node, Udf):
        out = dataclasses.replace(node,
                                  child=_pushdown(node.child, [], trace))
        return _wrap(out, preds)
    raise TypeError(f"not a logical node: {node!r}")


# ---------------------------------------------------------------------------
# Pass 2: projection pruning
# ---------------------------------------------------------------------------

def _prune(node, required: Optional[set], trace: list[str]):
    """Narrow scans (and intermediate projections) to the columns the
    plan above actually references. ``required=None`` means "everything"
    (unknown consumer, e.g. below a UDF)."""
    if isinstance(node, Scan):
        if required is None:
            if node.columns is None:
                raise LogicalError(
                    f"scan({node.table!r}) needs explicit columns: its "
                    "consumer's column needs cannot be inferred (declare "
                    "columns on the scan or output_columns on the UDF)")
            return node
        if node.columns is None:
            cols = sorted(required)
        else:
            cols = [c for c in node.columns if c in required]
        if node.columns is None or len(cols) < len(node.columns):
            trace.append(f"projection_pruning: scan({node.table}) "
                         f"columns -> {cols}")
        return Scan(node.table, cols, partitioned_by=node.partitioned_by)
    if isinstance(node, Filter):
        need = None if required is None else \
            required | logical.pred_columns(node.predicate)
        return Filter(_prune(node.child, need, trace), node.predicate)
    if isinstance(node, Project):
        cols = node.columns
        if required is not None:
            kept = [c for c in cols
                    if (c if isinstance(c, str) else c[0]) in required]
            if len(kept) < len(cols):
                trace.append(
                    f"projection_pruning: project narrowed to "
                    f"{[(c if isinstance(c, str) else c[0]) for c in kept]}")
            cols = kept
        return Project(_prune(node.child, logical.project_inputs(cols),
                              trace), cols)
    if isinstance(node, Join):
        ls, rs = logical.schema(node.left), logical.schema(node.right)
        if required is None or ls is None or rs is None:
            lreq = rreq = None
        else:
            lreq = (required & set(ls)) | {node.left_on}
            rreq = (required & set(rs)) | {node.right_on}
        return Join(_prune(node.left, lreq, trace),
                    _prune(node.right, rreq, trace),
                    node.left_on, node.right_on)
    if isinstance(node, Aggregate):
        need = set(node.keys) | {a.column for a in node.aggs}
        return Aggregate(_prune(node.child, need, trace), node.keys,
                         node.aggs)
    if isinstance(node, Udf):
        # The UDF's input needs are opaque: keep the child's declared
        # columns as-is.
        return dataclasses.replace(node,
                                   child=_prune(node.child, None, trace))
    raise TypeError(f"not a logical node: {node!r}")


# ---------------------------------------------------------------------------
# Lowering to physical pipelines
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pipe:
    """A physical pipeline under construction."""
    input: object
    base_name: str
    input2: Optional[ShuffleInput] = None
    ops: list = dataclasses.field(default_factory=list)
    schema: Optional[list[str]] = None
    est_bytes: Optional[float] = None
    has_join: bool = False
    has_agg: bool = False
    # Output-partitioning property: rows of fragment i satisfy
    # ``part[0] % part[1] == i`` under the CURRENT schema's column names
    # (renames tracked). ``input_part`` is the same property named as the
    # upstream producer emits it (``ShuffleOutput.partition_by`` /
    # declared table key) — recorded as ``Pipeline.partitioning`` when an
    # elision relied on it (``relied``).
    part: Optional[tuple[str, int]] = None
    input_part: Optional[tuple[str, int]] = None
    # Declared layout of a TableInput build side read directly as
    # partition slices (recorded as ``Pipeline.partitioning2``).
    input_part2: Optional[tuple[str, int]] = None
    relied: bool = False
    # Why ``part`` is None when a property existed upstream (trace only).
    part_note: Optional[str] = None
    # Per-column dtype widths (bytes/value) under the current schema,
    # None when unknown; drives width-aware size estimates.
    col_widths: Optional[dict[str, int]] = None
    # Estimated producing-fragment count (shuffle WRITERS): known exactly
    # for pipelines fed by a shuffle or a declared-partitioned table,
    # None for plain scans (the coordinator derives parallelism from the
    # object count, invisible here). Exchange-tier placement needs it
    # because request count scales with writers x partitions.
    writers_est: Optional[int] = None

    def width_sum(self, cols) -> Optional[float]:
        if self.col_widths is None:
            return None
        return float(sum(self.col_widths.get(c, DEFAULT_COLUMN_WIDTH)
                         for c in cols))


class _Lowering:
    def __init__(self, query: LogicalQuery, stats: Optional[Stats],
                 backend: str, bench_path: Optional[str],
                 trace: list[str], elide: bool = True,
                 exchange_tiers: str = "auto",
                 memory_budget: Optional[float] = None):
        self.query = query
        self.stats = stats or Stats()
        self.backend = backend
        self.bench_path = bench_path
        self.trace = trace
        self.elide = elide
        self.exchange_tiers = exchange_tiers
        self.memory_budget = memory_budget
        self.pipelines: list[Pipeline] = []
        self._names: dict[str, int] = {}

    # -- naming / closing ---------------------------------------------------
    def _unique(self, base: str) -> str:
        n = self._names.get(base, 0)
        self._names[base] = n + 1
        return base if n == 0 else f"{base}_{n + 1}"

    def _close(self, pipe: _Pipe, output) -> str:
        base = pipe.base_name
        if pipe.has_join:
            base = "join_agg" if pipe.has_agg else "join"
        name = self._unique(base)
        partitioning = None
        fragments = None
        if pipe.relied and pipe.input_part is not None:
            partitioning = {"key": pipe.input_part[0],
                            "fanout": pipe.input_part[1]}
            if isinstance(pipe.input, TableInput):
                # Declared table partitioning: stored partition i must BE
                # fragment i, so the parallelism is pinned to the fan-out.
                fragments = pipe.input_part[1]
        self.pipelines.append(Pipeline(
            name=name, input=pipe.input, ops=pipe.ops, output=output,
            input2=pipe.input2, fragments=fragments,
            partitioning=partitioning,
            partitioning2=None if pipe.input_part2 is None else
            {"key": pipe.input_part2[0], "fanout": pipe.input_part2[1]}))
        return name

    # -- physical choices ---------------------------------------------------
    def _cpu_bw(self) -> float:
        return bench_profile.cpu_bytes_per_s(
            self.backend, FALLBACK_CPU_BYTES_PER_S[self.backend],
            path=self.bench_path)

    def _fanout(self, est_bytes: Optional[float], what: str,
                allow_hint: bool = True) -> int:
        if allow_hint and self.query.shuffle_partitions:
            n = self.query.shuffle_partitions
            self.trace.append(f"shuffle_fanout: {what} -> {n} partitions "
                              f"(explicit hint)")
            return n
        if est_bytes is None:
            n = DEFAULT_SHUFFLE_PARTITIONS
            self.trace.append(f"shuffle_fanout: {what} -> {n} partitions "
                              f"(no stats; default)")
            return n
        n = derive_fanout(est_bytes, self.backend,
                          bench_path=self.bench_path,
                          memory_budget=self.memory_budget)
        n_mem = memory_fanout(est_bytes, self.memory_budget)
        n_tput = derive_fanout(est_bytes, self.backend,
                               bench_path=self.bench_path)
        self.trace.append(
            f"shuffle_fanout: {what} -> {n} partitions "
            f"(~{est_bytes / MIB:.1f} MiB at "
            f"{self._cpu_bw() / MIB:.0f} MiB/s per {TARGET_PARTITION_SECONDS}s "
            f"partition)")
        if self.memory_budget and n_mem > n_tput:
            self.trace.append(
                f"shuffle_fanout: {what} memory pressure -> >= {n_mem} "
                f"partitions (~{est_bytes / MIB:.1f} MiB vs "
                f"{self.memory_budget * MEMORY_TARGET_FRACTION / MIB:.0f} MiB "
                f"per-fragment window of {self.memory_budget / MIB:.0f} MiB "
                f"cap)")
        return n

    def _shuffle_out(self, key: str, partitions: int,
                     est_bytes: Optional[float],
                     writers_est: Optional[int],
                     what: str) -> ShuffleOutput:
        """Build a ``ShuffleOutput`` with its exchange tier chosen by the
        break-even model (``core.breakeven.place_exchange``): estimated
        shuffle bytes spread over writers x partitions round trips against
        the measured tier throughputs from the ``tiered_exchange`` bench
        section. Small hot shuffles (combines) land on the KV tier, bulk
        row shuffles stay on the object store; no hand rules. A ``None``
        break-even or a missing size estimate falls back to the object
        store with a trace note — never a crash."""
        if self.exchange_tiers in ("object", "kv"):
            self.trace.append(f"exchange_tier: {what} -> "
                              f"{self.exchange_tiers} (forced)")
            return ShuffleOutput(key, partitions, tier=self.exchange_tiers)
        writers = writers_est
        if writers is None:
            if est_bytes is not None:
                # Mirror the coordinator's parallelism heuristic: one
                # fragment per target-partition of input.
                target = self._cpu_bw() * TARGET_PARTITION_SECONDS
                writers = max(1, min(MAX_SHUFFLE_PARTITIONS,
                                     math.ceil(est_bytes / target)))
            else:
                writers = DEFAULT_SHUFFLE_PARTITIONS
        placed = breakeven.place_exchange_from_bench(
            est_bytes, writers, partitions, bench_path=self.bench_path)
        if placed.access_bytes is None or placed.object_usd is None:
            self.trace.append(
                f"exchange_tier: {what} -> {placed.tier} ({placed.note})")
        else:
            self.trace.append(
                f"exchange_tier: {what} -> {placed.tier} ({placed.note}; "
                f"{placed.n_objects} round trips, modeled object "
                f"${placed.object_usd:.6f}/{placed.object_s * 1e3:.1f}ms "
                f"vs kv ${placed.kv_usd:.6f}/{placed.kv_s * 1e3:.1f}ms)")
        return ShuffleOutput(key, partitions, tier=placed.tier)

    # -- tree walk ----------------------------------------------------------
    def build(self, node) -> _Pipe:
        if isinstance(node, Scan):
            if node.columns is None:
                raise LogicalError(
                    f"scan({node.table!r}) reached lowering without "
                    "columns; declare them or reference them upstream")
            cols = list(node.columns)
            est = self.stats.bytes_for(node.table)
            widths = self.stats.widths_for(node.table)
            col_widths = None
            if widths is not None:
                col_widths = {c: widths.get(c, DEFAULT_COLUMN_WIDTH)
                              for c in cols}
                total = float(sum(widths.values()))
                if est is not None and total > 0:
                    # Projection pushdown reads only the scanned columns'
                    # bytes; scale by their dtype widths, not count.
                    est *= sum(col_widths.values()) / total
            part = None
            if node.partitioned_by is not None \
                    and node.partitioned_by[0] in cols:
                part = (node.partitioned_by[0], node.partitioned_by[1])
                self.trace.append(
                    f"partition_property: scan({node.table}) declared "
                    f"partitioned hash({part[0]}) % {part[1]}")
            return _Pipe(input=TableInput(node.table, cols),
                         base_name=f"scan_{node.table}",
                         schema=cols, est_bytes=est,
                         part=part, input_part=part,
                         col_widths=col_widths,
                         writers_est=None if part is None else part[1])
        if isinstance(node, Filter):
            pipe = self.build(node.child)
            pipe.ops.append({"op": "filter", "expr": node.predicate})
            if pipe.est_bytes is not None:
                pipe.est_bytes *= FILTER_SELECTIVITY
            return pipe
        if isinstance(node, Project):
            pipe = self.build(node.child)
            pipe.ops.append({"op": "project", "columns": node.columns})
            new_schema = [c if isinstance(c, str) else c[0]
                          for c in node.columns]
            new_widths = None
            if pipe.col_widths is not None:
                new_widths = {}
                for c in node.columns:
                    if isinstance(c, str):
                        new_widths[c] = pipe.col_widths.get(
                            c, DEFAULT_COLUMN_WIDTH)
                    elif isinstance(c[1], str):      # pure rename
                        new_widths[c[0]] = pipe.col_widths.get(
                            c[1], DEFAULT_COLUMN_WIDTH)
                    else:                            # derived: f64
                        new_widths[c[0]] = DEFAULT_COLUMN_WIDTH
            if pipe.est_bytes is not None:
                old_w = pipe.width_sum(pipe.schema) if pipe.schema else None
                new_w = None if new_widths is None else \
                    float(sum(new_widths.values()))
                if old_w and new_w is not None:
                    pipe.est_bytes *= new_w / old_w
                elif pipe.schema:
                    pipe.est_bytes *= len(new_schema) / max(1,
                                                            len(pipe.schema))
            pipe.schema = new_schema
            pipe.col_widths = new_widths
            new_part = _project_part(pipe.part, node.columns)
            if pipe.part is not None and new_part is None:
                pipe.part_note = (f"was {_fmt_part(pipe.part)} until a "
                                  f"projection dropped {pipe.part[0]}")
            pipe.part = new_part
            return pipe
        if isinstance(node, Udf):
            pipe = self.build(node.child)
            op = {"op": "udf", "name": node.name, "kwargs": node.kwargs}
            if node.broadcast:
                op["broadcast"] = node.broadcast
            pipe.ops.append(op)
            pipe.schema = list(node.output_columns) \
                if node.output_columns else None
            if pipe.part is not None:   # UDFs may rewrite rows arbitrarily
                pipe.part_note = (f"was {_fmt_part(pipe.part)} until udf "
                                  f"{node.name}")
            pipe.part = None
            pipe.col_widths = None
            return pipe
        if isinstance(node, Join):
            return self._build_join(node)
        if isinstance(node, Aggregate):
            return self._build_aggregate(node)
        raise TypeError(f"not a logical node: {node!r}")

    def _build_join(self, node: Join) -> _Pipe:
        left = self.build(node.left)
        right = self.build(node.right)
        elided = self._try_elide_join(node, left, right)
        if elided is not None:
            return elided
        # Build side: the smaller estimated input is held in memory;
        # ties (and missing stats) keep the right side as build, which
        # preserves the conventional fact-probes-dimension authoring
        # order. The physical join drops the BUILD key from its output,
        # so a swap flips which key column survives: downstream ops were
        # authored against the logical schema (left cols + right cols
        # minus right_on) and a reconciling projection restores it. That
        # projection needs both schemas, so a swap with differently
        # named keys is only taken when they are known.
        swap = (left.est_bytes is not None and right.est_bytes is not None
                and left.est_bytes < right.est_bytes)
        if swap and node.left_on != node.right_on \
                and (left.schema is None or right.schema is None):
            swap = False
        probe, build = (right, left) if swap else (left, right)
        probe_on, build_on = (node.right_on, node.left_on) if swap \
            else (node.left_on, node.right_on)
        self.trace.append(
            "join_build_side: build = "
            + ("left" if swap else "right")
            + f" ({_fmt_bytes(build.est_bytes)} vs probe "
            + f"{_fmt_bytes(probe.est_bytes)})")
        known = [e for e in (probe.est_bytes, build.est_bytes)
                 if e is not None]
        parts = self._fanout(max(known) if known else None,
                             f"join on {probe_on}")
        probe_name = self._close(probe, self._shuffle_out(
            probe_on, parts, probe.est_bytes, probe.writers_est,
            f"row shuffle on {probe_on}"))
        build_name = self._close(build, self._shuffle_out(
            build_on, parts, build.est_bytes, build.writers_est,
            f"build shuffle on {build_on}"))
        ops = [{"op": "hash_join", "left_key": probe_on,
                "right_key": build_on}]
        # The logical contract, regardless of build side.
        out_schema = logical.join_output_schema(left.schema, right.schema,
                                                node.right_on)
        if swap and node.left_on != node.right_on:
            # Swapped physical output carries right_on instead of
            # left_on (equal values — it is an equi-join): rename it
            # back and restore the logical column order.
            ops.append({"op": "project", "columns": [
                [node.left_on, node.right_on] if c == node.left_on else c
                for c in out_schema]})
        self.trace.append(
            f"partition_property: join inputs co-partitioned "
            f"hash({probe_on}) % {parts} ('{probe_name}'/'{build_name}')")
        pipe = _Pipe(input=ShuffleInput(probe_name),
                     input2=ShuffleInput(build_name),
                     base_name="join",
                     ops=ops,
                     schema=out_schema, est_bytes=probe.est_bytes,
                     has_join=True,
                     # The join output inherits the co-partitioning: probe
                     # rows never leave their fragment and the build key's
                     # values equal the probe key's.
                     part=(node.left_on, parts),
                     input_part=(probe_on, parts),
                     col_widths=_merge_widths(left, right, node.right_on),
                     writers_est=parts)
        return pipe

    def _try_elide_join(self, node: Join, left: _Pipe,
                        right: _Pipe) -> Optional[_Pipe]:
        """Co-partition join elision: a side already partitioned by its
        join key continues in place as the probe — its row shuffle
        disappears. The other side shuffles at the SAME fan-out
        (co-partitioning is a correctness requirement, so the row-shuffle
        hint is ignored), or, when it is itself an already-aligned
        pass-through, its producer's partition slices are read directly
        as the build input with no rewrite. Emits a kept-line when the
        rule fires but cannot elide, so explain always shows it."""
        if not self.elide:
            return None
        lprop = left.part if left.part is not None \
            and left.part[0] == node.left_on else None
        rprop = right.part if right.part is not None \
            and right.part[0] == node.right_on else None
        if lprop is None and rprop is None:
            self.trace.append(
                f"shuffle_elision: join on {node.left_on} kept (neither "
                f"input is partitioned by its join key: left "
                f"{_fmt_part(left.part)}, right {_fmt_part(right.part)})")
            return None
        candidates = []
        if lprop is not None:
            candidates.append((left, right, node.left_on, node.right_on,
                               False, lprop))
        if rprop is not None:
            candidates.append((right, left, node.right_on, node.left_on,
                               True, rprop))
        skip_reason = None
        for probe, build, probe_on, build_on, swapped, prop in candidates:
            if probe.input2 is not None:
                continue   # pipeline already carries a build side
            if swapped and node.left_on != node.right_on and (
                    left.schema is None or right.schema is None):
                continue   # cannot emit the key-restoring rename
            n = prop[1]
            if build.est_bytes is not None:
                # The build is forced to the probe's fan-out and each
                # fragment holds one build slice in memory: refuse an
                # elision whose forced co-partitioning leaves slices far
                # beyond the target partition size — the unelided plan's
                # size-based build choice and fan-out win there.
                slice_budget = self._cpu_bw() * TARGET_PARTITION_SECONDS \
                    * ELIDE_BUILD_SLICE_FACTOR
                if build.est_bytes / max(1, n) > slice_budget:
                    skip_reason = (
                        f"forced fan-out {n} leaves "
                        f"~{build.est_bytes / max(1, n) / MIB:.0f} MiB "
                        f"build slices per fragment (budget "
                        f"~{slice_budget / MIB:.0f} MiB); size-based "
                        f"plan wins")
                    continue
            build_part2 = None
            build_aligned = build.part is not None \
                and build.part[0] == build_on and build.part[1] == n \
                and not build.ops and build.input2 is None
            if build_aligned and isinstance(build.input, ShuffleInput):
                # Already-aligned pass-through: no build-side rewrite —
                # the join reads its producer's partition slices directly.
                build_input = build.input
                self.trace.append(
                    f"shuffle_elision: both join sides already "
                    f"co-partitioned hash({probe_on}) % {n}; probe "
                    f"continues in place, build reads "
                    f"'{build.input.from_pipeline}' partition slices "
                    f"directly (both row shuffles elided)")
            elif build_aligned and isinstance(build.input, TableInput):
                # Declared hash-partitioned base table: fragment i reads
                # stored partition i as its build slice — no shuffle, no
                # rewrite (the worker re-verifies the declared layout).
                build_input = build.input
                build_part2 = build.input_part
                self.trace.append(
                    f"shuffle_elision: build side reads table "
                    f"'{build.input.table}' stored partition slices "
                    f"directly (declared hash({build_on}) % {n} layout; "
                    f"both row shuffles elided)")
            else:
                build_name = self._close(build, self._shuffle_out(
                    build_on, n, build.est_bytes, build.writers_est,
                    f"build shuffle on {build_on}"))
                build_input = ShuffleInput(build_name)
                self.trace.append(
                    f"shuffle_elision: probe-side row shuffle on "
                    f"{probe_on} elided (input already partitioned "
                    f"hash({probe_on}) % {n}); build '{build_name}' "
                    f"shuffles at the same fan-out (forced)")
            probe.ops.append({"op": "hash_join", "left_key": probe_on,
                              "right_key": build_on})
            out_schema = logical.join_output_schema(
                left.schema, right.schema, node.right_on)
            if swapped and node.left_on != node.right_on:
                # The continued (physical-right) probe keeps right_on;
                # rename it back to the logical left key.
                probe.ops.append({"op": "project", "columns": [
                    [node.left_on, node.right_on] if c == node.left_on
                    else c for c in out_schema]})
            probe.input2 = build_input
            probe.input_part2 = build_part2
            probe.has_join = True
            probe.schema = out_schema
            probe.col_widths = _merge_widths(left, right, node.right_on)
            probe.part = (node.left_on, n)
            probe.relied = True
            probe.writers_est = n
            return probe
        self.trace.append(
            f"shuffle_elision: join on {node.left_on} kept ("
            + (skip_reason or
               "the pre-partitioned side cannot continue in place: it "
               "already joins, or the key rename needs unknown schemas")
            + ")")
        return None

    def _build_aggregate(self, node: Aggregate) -> _Pipe:
        pipe = self.build(node.child)
        elided = self._try_elide_combine(node, pipe)
        if elided is not None:
            return elided
        partial = [[a.name, a.fn, a.column] for a in node.aggs]
        pipe.ops.append({"op": "hash_agg", "keys": list(node.keys),
                         "aggs": partial})
        pipe.has_agg = True
        out_cols = list(node.keys) + [a.name for a in node.aggs]
        # Combine shuffle: partition by the first group key; a global
        # aggregate has one row per fragment, so any produced column
        # works at the computed (small) fan-out — no synthetic __zero__
        # column needed.
        combine_key = node.keys[0] if node.keys else node.aggs[0].name
        # Partial aggregation shrinks the data by roughly the group
        # cardinality; estimate the combine input as a fraction of the
        # pre-agg bytes so genuinely large grouped inputs (high-
        # cardinality keys at paper scale) still fan their combine out.
        est_out = AGG_EST_OUTPUT_BYTES if pipe.est_bytes is None \
            else pipe.est_bytes * AGG_OUTPUT_FRACTION
        if node.keys:
            # Combine shuffles are optimizer-owned: the fan-out follows
            # the partial-output estimate, NOT the row-shuffle hint — a
            # wide hinted combine would schedule mostly-empty final
            # fragments and multiply shuffle-read probes for nothing.
            parts = self._fanout(est_out,
                                 f"aggregate combine on {combine_key}",
                                 allow_hint=False)
        else:
            # A global aggregate MUST combine in one fragment (its
            # partition key is a partial value, not a grouping key) —
            # never let the cost model fan it out.
            parts = 1
            self.trace.append(f"shuffle_fanout: global-aggregate combine "
                              f"on {combine_key} -> 1 partition (forced)")
        name = self._close(pipe, self._shuffle_out(
            combine_key, parts, est_out, pipe.writers_est,
            f"combine shuffle on {combine_key}"))
        final = [[a.name, logical.FINAL_AGG_FN[a.fn], a.name]
                 for a in node.aggs]
        self.trace.append(
            f"agg_split: partial hash_agg in '{name}', final combine "
            "re-aggregates partials (count -> sum) downstream")
        return _Pipe(input=ShuffleInput(name), base_name="final_agg",
                     ops=[{"op": "hash_agg", "keys": list(node.keys),
                           "aggs": final}],
                     schema=out_cols, est_bytes=est_out, has_agg=True,
                     # The combine shuffle partitions by a group key, so
                     # the final aggregate's output is itself partitioned
                     # by it — downstream joins/aggs on it can elide.
                     part=(combine_key, parts),
                     input_part=(combine_key, parts),
                     col_widths=_agg_widths(pipe, node),
                     writers_est=parts)

    def _try_elide_combine(self, node: Aggregate,
                           pipe: _Pipe) -> Optional[_Pipe]:
        """Combine-shuffle elision: when the producing pipeline is
        already partitioned by one of the aggregate's group keys (or
        lives in a single fragment), every group-key class is confined to
        one fragment — the partial and final aggregates collapse into ONE
        fragment-local aggregation and the combine shuffle (write + read
        + final fragments) disappears entirely. Emits a kept-line when
        the rule fires but cannot elide."""
        if not self.elide:
            return None
        prop = pipe.part
        keys = list(node.keys)
        elidable = prop is not None and (prop[1] == 1
                                         or (keys and prop[0] in keys))
        combine_key = keys[0] if keys else node.aggs[0].name
        if not elidable:
            if prop is not None:
                reason = (f"producer partitioned {_fmt_part(prop)}, "
                          "not by a group key")
            else:
                reason = pipe.part_note or \
                    "producer output is not hash-partitioned"
            self.trace.append(f"shuffle_elision: combine on {combine_key} "
                              f"kept ({reason})")
            return None
        aggs = [[a.name, a.fn, a.column] for a in node.aggs]
        pipe.ops.append({"op": "hash_agg", "keys": keys, "aggs": aggs})
        pipe.has_agg = True
        out_cols = keys + [a.name for a in node.aggs]
        pipe.schema = out_cols
        pipe.est_bytes = AGG_EST_OUTPUT_BYTES if pipe.est_bytes is None \
            else pipe.est_bytes * AGG_OUTPUT_FRACTION
        pipe.col_widths = _agg_widths(pipe, node)
        pipe.relied = True
        why = (f"group key {prop[0]}" if keys and prop is not None
               and prop[0] in keys else "single fragment")
        self.trace.append(
            f"shuffle_elision: aggregate combine on {combine_key} ELIDED "
            f"(producer already partitioned {_fmt_part(prop)}, {why}); "
            f"partial+final collapse into one fragment-local hash_agg — "
            f"no combine shuffle is written")
        # Groups keep the producer's partitioning (every group's key
        # class stays in its fragment); keyless single-fragment output is
        # trivially partitioned at fan-out 1.
        if keys and prop is not None and prop[0] in keys:
            pipe.part = prop
        elif prop is not None and prop[1] == 1:
            pipe.part = (out_cols[0], 1)
        else:
            pipe.part = None
        return pipe


def _fmt_bytes(b: Optional[float]) -> str:
    return "unknown size" if b is None else f"~{b / MIB:.1f} MiB"


def _agg_widths(pipe: "_Pipe", node: Aggregate) -> dict[str, int]:
    """Column widths of an aggregate output (aggregates emit f64)."""
    out = {}
    for k in node.keys:
        out[k] = DEFAULT_COLUMN_WIDTH if pipe.col_widths is None \
            else pipe.col_widths.get(k, DEFAULT_COLUMN_WIDTH)
    for a in node.aggs:
        out[a.name] = DEFAULT_COLUMN_WIDTH
    return out


def _merge_widths(left: _Pipe, right: _Pipe,
                  right_on: str) -> Optional[dict[str, int]]:
    """Column widths of a join output (build key dropped)."""
    if left.col_widths is None or right.col_widths is None:
        return None
    out = dict(left.col_widths)
    for c, w in right.col_widths.items():
        if c != right_on:
            out[c] = w
    return out


def _project_part(part: Optional[tuple[str, int]],
                  columns: list) -> Optional[tuple[str, int]]:
    """Partitioning property through a projection: survives when the
    partition column is kept (bare keeps win over pure renames)."""
    if part is None:
        return None
    key, n = part
    for c in columns:
        if isinstance(c, str) and c == key:
            return (key, n)
    for c in columns:
        if not isinstance(c, str) and isinstance(c[1], str) and c[1] == key:
            return (c[0], n)
    return None


def _fmt_part(part: Optional[tuple[str, int]]) -> str:
    return "not hash-partitioned" if part is None \
        else f"hash({part[0]}) % {part[1]}"


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lower(query: LogicalQuery, stats: Optional[Stats] = None,
          backend: str = "numpy", bench_path: Optional[str] = None,
          shuffle_elision: bool = True,
          exchange_tiers: str = "auto",
          memory_budget: Optional[float] = None
          ) -> tuple[QueryPlan, PlanReport]:
    """Optimize and lower a logical query. Returns the physical plan plus
    the report of applied rules (see ``engine.explain``).
    ``shuffle_elision=False`` disables the partitioning-property elision
    rules — parity tests and benchmarks lower both variants from the same
    logical query. ``exchange_tiers`` selects shuffle placement:
    ``"auto"`` (default) picks per shuffle by break-even analysis,
    ``"object"``/``"kv"`` force every shuffle onto one tier (the
    ``tiered_exchange`` benchmark lowers all three variants from one
    logical query). ``memory_budget`` (bytes per worker) adds a memory
    term to shuffle fan-out derivation: a fragment's input slice should
    fit ``MEMORY_TARGET_FRACTION`` of the cap (see ``derive_fanout``)."""
    if exchange_tiers not in ("auto", "object", "kv"):
        raise ValueError(f"exchange_tiers must be 'auto', 'object' or "
                         f"'kv', got {exchange_tiers!r}")
    trace: list[str] = []
    root = _pushdown(query.root, [], trace)
    root = _prune(root, None, trace)
    low = _Lowering(query, stats, backend, bench_path, trace,
                    elide=shuffle_elision, exchange_tiers=exchange_tiers,
                    memory_budget=memory_budget)
    pipe = low.build(root)
    low._close(pipe, CollectOutput())
    plan = QueryPlan(query.name, low.pipelines)
    plan.validate()
    return plan, PlanReport(query.name, trace, root)


def plan(query: LogicalQuery, stats: Optional[Stats] = None,
         backend: str = "numpy", bench_path: Optional[str] = None,
         shuffle_elision: bool = True,
         exchange_tiers: str = "auto",
         memory_budget: Optional[float] = None) -> QueryPlan:
    """``lower`` without the report — the one-call path for query
    builders."""
    return lower(query, stats=stats, backend=backend,
                 bench_path=bench_path,
                 shuffle_elision=shuffle_elision,
                 exchange_tiers=exchange_tiers,
                 memory_budget=memory_budget)[0]
