"""Physical query plans: JSON-able pipelines with dependencies (paper §3.2).

A plan is a list of pipelines; each pipeline reads either base-table
partitions or the shuffle output of upstream pipelines, applies a chain of
vectorized operators, and either reshuffles or collects its output. The
coordinator decides fragment counts (data parallelism) per pipeline at
compile time.

Join-as-op pipeline spec: an equi-join is an ordinary entry in ``ops`` —

    {"op": "hash_join", "left_key": "<probe col>", "right_key": "<build col>"}

with the build side declared by the pipeline's ``input2`` (a ShuffleInput
partitioned the same way as ``input``). The worker resolves the build-side
read into the op spec at runtime (a ``"build"`` ColumnBatch, never part of
the JSON), and the execution backends treat the join like any other
pipeline op: the numpy backend interprets ``operators.op_hash_join``
(duplicate build keys expand, SQL inner-join multiplicity); the torch
backend (the default) runs the join probe — duplicate build keys
included — every following filter/project, and — when the run reaches a
shuffle output — the radix partition assignment as one compiled call
(``engine_compile._FusedTail``); a trailing partial ``hash_agg``
partitioned by one of its own group keys aggregates per partition slice
so the segment still traces whole. The legacy ``Pipeline.join``
field (``{left_key, right_key}``) is still accepted and is normalized by
the worker into a leading ``hash_join`` op.

Other ops: {"op": "filter", "expr": [...]} | {"op": "project", "columns":
[name | [name, value-expr], ...]} | {"op": "hash_agg", "keys": [...],
"aggs": [[out, fn, col], ...]} | {"op": "udf", "name": ..., "kwargs": ...,
"broadcast": {...}} (see ``operators.py`` for expression grammar).

Plans are rarely hand-built anymore: ``engine.logical`` provides the
typed expression/plan builder and ``engine.optimizer`` lowers it to this
physical vocabulary (predicate pushdown, projection pruning, partial/
final aggregate splitting, build-side + fan-out selection). Hand-built
plans remain first-class — ``QueryPlan.validate()`` fail-fast checks
both kinds before the coordinator schedules a single fragment.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

from repro_torch.engine import logical


@dataclasses.dataclass
class TableInput:
    table: str
    columns: list[str]
    type: str = "table"


@dataclasses.dataclass
class ShuffleInput:
    from_pipeline: str
    type: str = "shuffle"


# Exchange tiers a shuffle can ride (core.storage_service stores carry the
# matching ``tier`` attribute): the object store is the bulk default, "kv"
# is the memory-grade fast tier chosen by break-even placement.
EXCHANGE_TIERS = ("object", "kv")


@dataclasses.dataclass
class ShuffleOutput:
    partition_by: str
    partitions: int
    type: str = "shuffle"
    tier: str = "object"


@dataclasses.dataclass
class CollectOutput:
    type: str = "collect"


@dataclasses.dataclass
class Pipeline:
    name: str
    input: object                       # TableInput | ShuffleInput
    ops: list[dict]
    output: object                      # ShuffleOutput | CollectOutput
    # Build side of a hash_join: a ShuffleInput co-partitioned with
    # ``input``, or a TableInput whose stored partition i IS hash
    # partition i (declared layout, ``partitioning2`` required) so the
    # join reads the table's partition slices directly with no shuffle.
    input2: Optional[object] = None
    # legacy {left_key, right_key}; prefer a hash_join op in ``ops``
    join: Optional[dict] = None
    fragments: Optional[int] = None     # fixed parallelism (else coordinator)
    # Input partitioning property the planner RELIED on to elide a shuffle:
    # {"key": <column in the producer's output>, "fanout": n} asserts that
    # fragment i of this pipeline receives exactly the rows with
    # ``hash(key) % fanout == i``. For a ShuffleInput the property must
    # match the producer's ShuffleOutput (validate() checks); for a
    # TableInput it declares that stored partition i IS hash partition i
    # (``logical.Scan.partitioned_by``) and the worker verifies it against
    # the actual key values at runtime. ``partitioning2`` is the same
    # declaration for a TableInput build side (``input2``).
    partitioning: Optional[dict] = None
    partitioning2: Optional[dict] = None

    def deps(self) -> list[str]:
        out = []
        for inp in (self.input, self.input2):
            if isinstance(inp, ShuffleInput):
                out.append(inp.from_pipeline)
        return out


KNOWN_OPS = ("filter", "project", "hash_agg", "hash_join", "udf")


class PlanValidationError(ValueError):
    """A malformed physical plan, caught before any fragment runs."""


def _op_input_columns(op: dict) -> Optional[set]:
    """Columns an op reads from its input batch, or None when opaque
    (UDFs). Uses the logical layer's grammar walkers so plan validation
    and the planner cannot drift on the expression grammar."""
    kind = op.get("op")
    if kind == "filter":
        return logical.pred_columns(op["expr"])
    if kind == "project":
        return logical.project_inputs(op["columns"])
    if kind == "hash_agg":
        return set(op["keys"]) | {col for _, fn, col in op["aggs"]
                                  if fn != "count"}
    if kind == "hash_join":
        return {op["left_key"]}
    return None


def _pipeline_schema(pipe: "Pipeline", schemas: dict,
                     errors: Optional[list] = None) -> Optional[list]:
    """Walk a pipeline's ops advancing the (ordered) output schema;
    returns the output columns, or None when unknowable (UDF ops,
    unknown upstream schema). ``schemas`` maps pipeline name -> schema.
    When ``errors`` is given, validation problems found along the walk
    (unknown ops, op inputs / join keys / legacy-join specs referencing
    columns nothing upstream produces) are appended — one walk serves
    both schema inference and validation, so the two cannot drift."""
    def err(msg: str) -> None:
        if errors is not None:
            errors.append(f"pipeline {pipe.name!r}: {msg}")

    if isinstance(pipe.input, TableInput):
        cols = list(pipe.input.columns)
    else:
        known = schemas.get(pipe.input.from_pipeline)
        cols = None if known is None else list(known)
    ops = list(pipe.ops)
    if pipe.join is not None:   # legacy spec: leading hash_join
        ops.insert(0, {"op": "hash_join", **pipe.join})
    for op in ops:
        kind = op.get("op")
        if kind not in KNOWN_OPS:
            err(f"unknown op {kind!r}")
            continue
        needs = _op_input_columns(op)
        if cols is not None and needs is not None \
                and not needs <= set(cols):
            err(f"{kind} op reads column(s) {sorted(needs - set(cols))} "
                f"not produced upstream (have {sorted(cols)})")
        if kind == "project":
            cols = [c if isinstance(c, str) else c[0] for c in op["columns"]]
        elif kind == "hash_agg":
            cols = list(op["keys"]) + [a[0] for a in op["aggs"]]
        elif kind == "hash_join":
            if pipe.input2 is None:
                build = None
            elif isinstance(pipe.input2, TableInput):
                build = list(pipe.input2.columns)
            else:
                build = schemas.get(pipe.input2.from_pipeline)
            if build is not None and op.get("right_key") not in build:
                err(f"hash_join right_key {op.get('right_key')!r} not "
                    f"produced by build side (have {sorted(build)})")
            cols = logical.join_output_schema(cols, build,
                                              op.get("right_key"))
        elif kind == "udf":
            cols = None
        # filter: schema unchanged
    return cols


def pipeline_schemas(plan: "QueryPlan") -> dict[str, Optional[list]]:
    """Output schema of every pipeline (name -> ordered columns, or None
    when unknowable, e.g. past a UDF). The adaptive executor uses this to
    decide whether a runtime build-side flip can emit its key-restoring
    rename; hand-built tools get the same walk ``validate()`` performs."""
    schemas: dict[str, Optional[list]] = {}
    for p in plan.pipelines:
        schemas[p.name] = _pipeline_schema(p, schemas)
    return schemas


def _check_partitioning(pipe: "Pipeline", by_name: dict) -> list[str]:
    """Structural checks for a declared (relied-on) input partitioning:
    the property must be exactly what the upstream shuffle established —
    an elided stage with a wrong property silently drops or duplicates
    groups, so this fails fast instead."""
    part = pipe.partitioning
    errs = []
    if not isinstance(part, dict) or "key" not in part \
            or "fanout" not in part:
        return [f"malformed partitioning {part!r} "
                "(need {'key': ..., 'fanout': ...})"]
    if isinstance(pipe.input, ShuffleInput):
        prod = by_name.get(pipe.input.from_pipeline)
        if prod is not None and isinstance(prod.output, ShuffleOutput):
            if prod.output.partition_by != part["key"]:
                errs.append(
                    f"partitioning key {part['key']!r} does not match "
                    f"producer {prod.name!r}'s shuffle partition key "
                    f"{prod.output.partition_by!r}")
            if prod.output.partitions != part["fanout"]:
                errs.append(
                    f"partitioning fan-out {part['fanout']} does not "
                    f"match producer {prod.name!r}'s "
                    f"{prod.output.partitions} shuffle partitions")
    elif isinstance(pipe.input, TableInput):
        # A declared pre-partitioned base table: the key must be scanned
        # (the worker verifies values % fanout at runtime) and the
        # fragment count must be pinned to the fan-out so stored
        # partition i lands on fragment i.
        if part["key"] not in pipe.input.columns:
            errs.append(f"partitioning key {part['key']!r} is not among "
                        f"the scanned columns {pipe.input.columns}")
        if pipe.fragments != part["fanout"]:
            errs.append(
                f"declared table partitioning fan-out {part['fanout']} "
                f"requires fragments={part['fanout']} "
                f"(got {pipe.fragments!r})")
    return errs


@dataclasses.dataclass
class QueryPlan:
    name: str
    pipelines: list[Pipeline]

    def validate(self) -> None:
        """Fail-fast structural checks, run by the coordinator before
        scheduling: duplicate pipeline names, dangling or out-of-order
        ``ShuffleInput.from_pipeline`` references, unknown op names,
        ``hash_join`` without a build-side ``input2`` (or with more than
        one join per pipeline), join inputs whose producers shuffle at
        different fan-outs, declared ``partitioning`` properties that
        disagree with the upstream shuffle (elided stages), op inputs and
        shuffle partition keys no upstream op produces, and a terminal
        pipeline that never collects. Raises ``PlanValidationError`` listing every problem —
        these misfires otherwise surface as opaque KeyErrors deep in
        ``worker.py``."""
        errors: list[str] = []
        if not self.pipelines:
            raise PlanValidationError(f"plan {self.name!r} has no pipelines")
        by_name = {q.name: q for q in self.pipelines}
        seen: list[str] = []
        for p in self.pipelines:
            if p.name in seen:
                errors.append(f"duplicate pipeline name {p.name!r}")
            for dep in p.deps():
                if dep not in seen:
                    tag = "dangling" if dep not in by_name else \
                        "out-of-order (must be defined earlier)"
                    errors.append(f"pipeline {p.name!r}: {tag} shuffle "
                                  f"input from_pipeline={dep!r}")
                elif not isinstance(by_name[dep].output, ShuffleOutput):
                    # A collect-output producer never writes shuffle
                    # objects: the consumer would read nothing, silently
                    # (missing_ok) on the build side.
                    errors.append(
                        f"pipeline {p.name!r}: shuffle input reads "
                        f"{dep!r}, which does not produce a shuffle "
                        f"output ({type(by_name[dep].output).__name__})")
            seen.append(p.name)
        schemas: dict = {}
        for p in self.pipelines:
            n_joins = (1 if p.join is not None else 0) + \
                sum(1 for op in p.ops if op.get("op") == "hash_join")
            if n_joins and p.input2 is None:
                errors.append(f"pipeline {p.name!r}: hash_join without a "
                              "build-side input2")
            if n_joins > 1:
                # One build-side input per pipeline: a second hash_join op
                # (e.g. from a botched join elision) would silently probe
                # the wrong build batch.
                errors.append(f"pipeline {p.name!r}: {n_joins} hash_join "
                              "ops but only one build-side input2")
            if n_joins and isinstance(p.input, ShuffleInput) \
                    and isinstance(p.input2, ShuffleInput):
                # Join inputs must be co-partitioned: fragment i probes
                # partition i of both sides, so differing fan-outs pair
                # probe rows with the wrong build slice.
                prod = by_name.get(p.input.from_pipeline)
                prod2 = by_name.get(p.input2.from_pipeline)
                if prod is not None and prod2 is not None \
                        and isinstance(prod.output, ShuffleOutput) \
                        and isinstance(prod2.output, ShuffleOutput) \
                        and prod.output.partitions != prod2.output.partitions:
                    errors.append(
                        f"pipeline {p.name!r}: join inputs are not "
                        f"co-partitioned ({prod.name!r} shuffles "
                        f"{prod.output.partitions} partitions, "
                        f"{prod2.name!r} shuffles "
                        f"{prod2.output.partitions})")
            if isinstance(p.input2, TableInput):
                # A base table as build side only works when its stored
                # partitions ARE the join's hash partitions — the planner
                # must have declared (and the worker will verify) that.
                if p.partitioning2 is None:
                    errors.append(
                        f"pipeline {p.name!r}: TableInput build side "
                        f"({p.input2.table!r}) without a declared "
                        "partitioning2 — its stored partitions cannot be "
                        "assumed to be hash partitions")
                elif p.partitioning2.get("key") not in p.input2.columns:
                    errors.append(
                        f"pipeline {p.name!r}: partitioning2 key "
                        f"{p.partitioning2.get('key')!r} is not among the "
                        f"build-side columns {p.input2.columns}")
            if p.partitioning is not None:
                errors.extend(
                    f"pipeline {p.name!r}: {m}"
                    for m in _check_partitioning(p, by_name))
            if isinstance(p.output, ShuffleOutput) \
                    and p.output.tier not in EXCHANGE_TIERS:
                errors.append(
                    f"pipeline {p.name!r}: unknown exchange tier "
                    f"{p.output.tier!r} (expected one of {EXCHANGE_TIERS})")
            schema = _pipeline_schema(p, schemas, errors)
            schemas[p.name] = schema
            if isinstance(p.output, ShuffleOutput) and schema is not None \
                    and p.output.partition_by not in schema:
                errors.append(
                    f"pipeline {p.name!r}: shuffle partition key "
                    f"{p.output.partition_by!r} is not produced upstream "
                    f"(have {schema})")
        if not isinstance(self.pipelines[-1].output, CollectOutput):
            errors.append(f"terminal pipeline "
                          f"{self.pipelines[-1].name!r} must collect "
                          "(the coordinator merges its fragments)")
        if errors:
            raise PlanValidationError(
                f"invalid plan {self.name!r}:\n  " + "\n  ".join(errors))

    def to_json(self) -> str:
        def default(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            import numpy as np
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.integer,)):
                return int(o)
            if isinstance(o, (np.floating,)):
                return float(o)
            raise TypeError(type(o))
        return json.dumps(dataclasses.asdict(self), default=default)

    @staticmethod
    def from_json(text: str) -> "QueryPlan":
        raw = json.loads(text)
        pipelines = []
        for p in raw["pipelines"]:
            inp = _input_from(p["input"])
            inp2 = _input_from(p["input2"]) if p.get("input2") else None
            if p["output"]["type"] == "shuffle":
                out = ShuffleOutput(p["output"]["partition_by"],
                                    p["output"]["partitions"],
                                    tier=p["output"].get("tier", "object"))
            else:
                out = CollectOutput()
            pipelines.append(Pipeline(p["name"], inp, p["ops"], out,
                                      input2=inp2, join=p.get("join"),
                                      fragments=p.get("fragments"),
                                      partitioning=p.get("partitioning"),
                                      partitioning2=p.get("partitioning2")))
        return QueryPlan(raw["name"], pipelines)


def _input_from(raw: dict):
    if raw["type"] == "table":
        return TableInput(raw["table"], raw["columns"])
    return ShuffleInput(raw["from_pipeline"])


# ---------------------------------------------------------------------------
# Canonical plan shape (compiled-plan cache keys)
# ---------------------------------------------------------------------------
#
# Two queries share compiled traces when they agree on everything XLA
# specializes on — op structure, referenced column names, shuffle fan-outs,
# literal dtype classes and in-list lengths — regardless of the literal
# VALUES (filter constants, projection coefficients) and table names. The
# canonicalizer below splits a plan along exactly that line: scalar/list
# literals in filter and project expressions are replaced by positional
# ``[LIT, index, dtype-tag]`` placeholder nodes and collected into a
# side list, table names are renamed positionally, pipeline names are
# renamed positionally (they embed the query name). ``plan_shape_hash``
# is a sha256 over the canonical JSON — a pure function of plan
# structure, stable across processes (no use of Python's salted
# ``hash``); ``plan_literal_hash`` covers everything the shape hash
# deliberately leaves out, so (shape, literal) identifies a query's
# exact semantics for result caching.
#
# Placeholders occupy literal slots ONLY (comparison right-hand sides,
# ``between`` bounds, ``in``/``case_in`` value lists, ``const`` payloads)
# so the grammar walkers in ``logical`` (``pred_columns``,
# ``value_columns``) traverse canonical expressions unchanged. The torch
# backend (``engine.compile``) re-binds placeholders at call time —
# to float32/int32-narrowed scalars on the device path, to the original Python values on
# interpreted fallbacks — so literal values never bake into a trace.

LIT = "__lit__"


def _pyval(v):
    """Plain-Python view of a literal (numpy scalars -> Python scalars) so
    canonical JSON and tags do not depend on who built the plan."""
    return v.item() if hasattr(v, "item") else v


def _scalar_tag(v) -> Optional[str]:
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        return "f"
    return None   # non-numeric literals stay structural


def _ph(v, lits: list):
    v = _pyval(v)
    tag = _scalar_tag(v)
    if tag is None:
        return v
    lits.append(v)
    return [LIT, len(lits) - 1, tag]


def _ph_list(vals, lits: list):
    pv = [_pyval(v) for v in vals]
    tags = [_scalar_tag(v) for v in pv]
    if not pv or any(t is None for t in tags):
        return list(vals)
    # The list length is structural (it is the shape of the traced isin
    # constant); the element dtype class is structural too.
    if "f" in tags:
        kind = "f"
    elif all(t == "b" for t in tags):
        kind = "b"
    else:
        kind = "i"
    lits.append(pv)
    return [LIT, len(lits) - 1, f"{kind}{len(pv)}"]


def _canon_pred(expr, lits: list):
    op = expr[0]
    if op in ("and", "or"):
        return [op] + [_canon_pred(s, lits) for s in expr[1:]]
    if op == "between":
        return [op, expr[1], _ph(expr[2], lits), _ph(expr[3], lits)]
    if op == "in":
        return [op, expr[1], _ph_list(expr[2], lits)]
    if op == "ltcol":
        return list(expr)
    # lt | le | ge | gt | eq | ne
    return [op, expr[1], _ph(expr[2], lits)]


def _canon_value(expr, lits: list):
    if isinstance(expr, str):
        return expr
    op = expr[0]
    if op == "const":
        return [op, _ph(expr[1], lits)]
    if op in ("mul", "add", "sub", "div"):
        return [op, _canon_value(expr[1], lits), _canon_value(expr[2], lits)]
    if op in ("sub1", "add1"):
        return [op, _canon_value(expr[1], lits)]
    if op == "case_in":
        return [op, expr[1], _ph_list(expr[2], lits)] + list(expr[3:])
    return [_pyval(x) if not isinstance(x, (list, str)) else x
            for x in expr]


def canonicalize_ops(ops: list[dict], lits: Optional[list] = None
                     ) -> tuple[list[dict], list]:
    """Split the literals out of an op chain. Returns ``(canonical_ops,
    literals)``: filter/project expressions carry ``[LIT, i, tag]``
    placeholder nodes, ``literals[i]`` holds the original value (a scalar,
    or the whole list for ``in``/``case_in``). Other ops (hash_join,
    hash_agg, udf) are structural and pass through copied."""
    lits = [] if lits is None else lits
    out = []
    for op in ops:
        kind = op.get("op")
        if kind == "filter":
            out.append({"op": "filter", "expr": _canon_pred(op["expr"],
                                                            lits)})
        elif kind == "project":
            cols = [c if isinstance(c, str)
                    else [c[0], _canon_value(c[1], lits)]
                    for c in op["columns"]]
            out.append({"op": "project", "columns": cols})
        else:
            out.append(dict(op))
    return out, lits


def canonical_plan(plan: "QueryPlan") -> tuple[dict, dict]:
    """Canonical (shape, residue) decomposition of a plan. ``shape`` is
    the deterministic JSON-able structure two trace-sharing queries agree
    on; ``residue`` holds what the shape hash leaves out: the literal
    values (in placeholder order), the positional->actual table name map,
    and the plan/pipeline names."""
    pipe_names = {p.name: f"p{i}" for i, p in enumerate(plan.pipelines)}
    tables: dict[str, str] = {}
    lits: list = []

    def table_alias(t: str) -> str:
        if t not in tables:
            tables[t] = f"t{len(tables)}"
        return tables[t]

    def canon_input(inp):
        if inp is None:
            return None
        if isinstance(inp, TableInput):
            return {"type": "table", "table": table_alias(inp.table),
                    "columns": list(inp.columns)}
        return {"type": "shuffle", "from": pipe_names[inp.from_pipeline]}

    pipes = []
    for p in plan.pipelines:
        ops = list(p.ops)
        if p.join is not None:   # normalize the legacy join spec
            ops.insert(0, {"op": "hash_join", **p.join})
        cops, lits = canonicalize_ops(ops, lits)
        if isinstance(p.output, ShuffleOutput):
            # The tier is part of the canonical shape: a cached compiled
            # plan routed to the wrong exchange tier would read shuffle
            # objects that were never written there.
            out = {"type": "shuffle", "by": p.output.partition_by,
                   "partitions": p.output.partitions,
                   "tier": p.output.tier}
        else:
            out = {"type": "collect"}
        pipes.append({"name": pipe_names[p.name],
                      "input": canon_input(p.input),
                      "input2": canon_input(p.input2),
                      "ops": cops, "output": out,
                      "fragments": p.fragments,
                      "partitioning": p.partitioning,
                      "partitioning2": p.partitioning2})
    shape = {"pipelines": pipes}
    residue = {"name": plan.name,
               "tables": {alias: t for t, alias in tables.items()},
               "literals": lits}
    return shape, residue


def _sha(obj) -> str:
    text = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(text.encode()).hexdigest()


def plan_shape_hash(plan: "QueryPlan") -> str:
    """Deterministic (cross-process) hash of a plan's canonical shape:
    structure, column names, fan-outs, literal dtype classes — NOT
    literal values, table names, or the query name. Queries with equal
    shape hashes share every compiled stage of the torch backend."""
    shape, _ = canonical_plan(plan)
    return _sha(shape)


def plan_cache_key(plan: "QueryPlan") -> tuple[str, str]:
    """``(shape_hash, literal_hash)`` in one canonicalization pass. The
    pair identifies a query's exact semantics up to the data it reads:
    the shape hash keys the compiled-plan (trace) cache, the pair keys
    the serving layer's result cache (alongside table etags)."""
    shape, residue = canonical_plan(plan)
    return _sha(shape), _sha(residue)
