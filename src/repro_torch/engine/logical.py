"""Logical query layer: typed expressions and a fluent plan builder.

This is the engine's authoring surface. Queries are written declaratively —

    from repro_torch.engine.logical import scan, col, lit, sum_

    q = (scan("lineitem")
         .filter((col("l_shipdate") >= 731) & (col("l_quantity") < 24.0))
         .select((col("l_extendedprice") * col("l_discount"))
                 .alias("revenue"))
         .agg(sum_("revenue").alias("revenue"))
         .collect("my_query"))

— producing a backend-agnostic logical IR (``LogicalQuery`` over the node
dataclasses below). ``engine.optimizer`` lowers the IR through rule-based
passes (predicate pushdown, projection pruning, partial/final aggregate
splitting, build-side and shuffle fan-out selection) into the physical
``plans.QueryPlan`` that both execution backends run unchanged.

Expression grammar emitted (see ``operators.py`` for evaluation):

* predicates — ``col < v`` -> ``["lt", c, v]`` (and ``le``/``ge``/``gt``/
  ``eq``/``ne``), ``col < col2`` -> ``["ltcol", c, c2]``,
  ``.between(lo, hi)`` -> ``["between", c, lo, hi]`` (inclusive),
  ``.isin(vals)`` -> ``["in", c, vals]``, ``&``/``|`` -> ``["and", ...]``
  / ``["or", ...]`` (flattened);
* values — ``*``/``+``/``-``/``/`` -> ``["mul"|"add"|"sub"|"div", a, b]``,
  ``1 - x`` -> ``["sub1", x]``, ``1 + x`` -> ``["add1", x]``,
  ``.case_in(vals)`` -> ``["case_in", c, vals]`` (1.0/0.0 indicator),
  ``lit(v)`` -> ``["const", v]``. Note ``sub1``/``add1`` evaluate as
  ``1.0 ± x`` — they promote to float (the TPC derived-column idiom,
  ``price * (1 - discount)``); write ``lit(1) + x`` / ``x - lit(1)`` when
  integer arithmetic must be preserved (e.g. deriving a shuffle key).

Comparisons require a bare column on one side (the physical grammar is
``[op, column, literal]``); project a derived expression to a named column
first. The IR is pure data — no numpy arrays, no store handles — so logical
plans serialize and compare structurally.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

Scalar = Union[int, float, bool]


class LogicalError(ValueError):
    """Raised for expressions or plans the grammar cannot represent."""


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

def _is_scalar(v) -> bool:
    return isinstance(v, (int, float, bool))


class Expr:
    """A typed wrapper over the engine's nested-list expression grammar.

    ``kind`` is ``"value"`` (column reference / arithmetic, evaluated by
    ``operators.eval_value``) or ``"pred"`` (boolean predicate, evaluated
    by ``operators.eval_expr``). ``node`` is the raw grammar: a column
    name string or a nested list.
    """

    __slots__ = ("node", "kind", "name")

    def __init__(self, node, kind: str, name: Optional[str] = None):
        self.node = node
        self.kind = kind
        self.name = name

    # -- naming -------------------------------------------------------------
    def alias(self, name: str) -> "Expr":
        return Expr(self.node, self.kind, name)

    def _require(self, kind: str, what: str):
        if self.kind != kind:
            raise LogicalError(f"{what} requires a {kind} expression, got "
                               f"{self.kind}: {self.node!r}")

    def _colname(self, what: str) -> str:
        if not isinstance(self.node, str):
            raise LogicalError(
                f"{what} requires a bare column reference (the physical "
                f"grammar is [op, column, literal]); project "
                f"{self.node!r} to a named column first")
        return self.node

    # -- comparisons (column vs literal, or column vs column) ---------------
    def _cmp(self, other, op: str) -> "Expr":
        c = self._colname(f"comparison {op!r}")
        if isinstance(other, Expr):
            if other.kind == "value" and isinstance(other.node, list) \
                    and other.node[0] == "const":
                other = other.node[1]            # lit(v) compares as scalar
            elif isinstance(other.node, str):
                if op == "lt":
                    return Expr(["ltcol", c, other.node], "pred")
                if op == "gt":                   # a > b  ==  b < a
                    return Expr(["ltcol", other.node, c], "pred")
                raise LogicalError(
                    f"column-vs-column comparison only supports < and > "
                    f"(grammar has ltcol); got {op!r}")
            else:
                raise LogicalError(
                    f"cannot compare against derived expression "
                    f"{other.node!r}; project it to a column first")
        if not _is_scalar(other):
            raise LogicalError(f"comparison against {other!r} unsupported")
        return Expr([op, c, other], "pred")

    def __lt__(self, other):
        return self._cmp(other, "lt")

    def __le__(self, other):
        return self._cmp(other, "le")

    def __gt__(self, other):
        return self._cmp(other, "gt")

    def __ge__(self, other):
        return self._cmp(other, "ge")

    def __eq__(self, other):  # noqa: D105 — builder DSL, not identity
        return self._cmp(other, "eq")

    def __ne__(self, other):
        return self._cmp(other, "ne")

    __hash__ = None   # == builds predicates; Exprs are not hashable

    def __bool__(self):
        # Python's `and`/`or`/`not` and chained comparisons coerce to
        # bool and would silently DROP operands (`a and b` evaluates to
        # b); fail loudly instead — use `&`/`|` to combine predicates.
        raise LogicalError(
            "an Expr has no truth value: use & / | to combine "
            "predicates (Python's and/or/not and chained comparisons "
            "would silently drop conditions)")

    def between(self, lo: Scalar, hi: Scalar) -> "Expr":
        """Inclusive range predicate (TPC-H discount style)."""
        return Expr(["between", self._colname("between"), lo, hi], "pred")

    def isin(self, values) -> "Expr":
        return Expr(["in", self._colname("isin"), list(values)], "pred")

    def case_in(self, values) -> "Expr":
        """1.0/0.0 indicator value: is the column's value in ``values``?"""
        return Expr(["case_in", self._colname("case_in"), list(values)],
                    "value")

    # -- boolean combinators -------------------------------------------------
    def _bool(self, other: "Expr", op: str) -> "Expr":
        self._require("pred", f"{op!r}")
        if not isinstance(other, Expr):
            raise LogicalError(f"{op!r} requires predicate operands")
        other._require("pred", f"{op!r}")
        parts = []
        for e in (self.node, other.node):
            # Flatten nested same-op conjunctions: a & b & c emits one
            # ["and", a, b, c] like the hand-written plans.
            parts.extend(e[1:] if e[0] == op else [e])
        return Expr([op] + parts, "pred")

    def __and__(self, other):
        return self._bool(other, "and")

    def __or__(self, other):
        return self._bool(other, "or")

    # -- arithmetic -----------------------------------------------------------
    def _vnode(self):
        self._require("value", "arithmetic")
        return self.node

    @staticmethod
    def _operand(v):
        if isinstance(v, Expr):
            return v._vnode()
        if _is_scalar(v):
            return ["const", v]
        raise LogicalError(f"cannot use {v!r} in arithmetic")

    def _arith(self, other, op: str, reflected: bool = False) -> "Expr":
        a, b = self._vnode(), Expr._operand(other)
        if reflected:
            a, b = b, a
        return Expr([op, a, b], "value")

    def __mul__(self, other):
        return self._arith(other, "mul")

    __rmul__ = __mul__

    def __add__(self, other):
        # The bare literal 1 emits the float-promoting add1/sub1 idioms
        # (1.0 ± x, the TPC derived-column form); lit(1) + x keeps
        # integer arithmetic — see the module docstring.
        if _is_scalar(other) and other == 1:
            return Expr(["add1", self._vnode()], "value")
        return self._arith(other, "add")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._arith(other, "sub")

    def __rsub__(self, other):
        if _is_scalar(other) and other == 1:
            return Expr(["sub1", self._vnode()], "value")
        return self._arith(other, "sub", reflected=True)

    def __truediv__(self, other):
        return self._arith(other, "div")

    def __rtruediv__(self, other):
        return self._arith(other, "div", reflected=True)

    def __repr__(self):
        tag = f" as {self.name!r}" if self.name else ""
        return f"Expr<{self.kind}>({self.node!r}{tag})"


def col(name: str) -> Expr:
    """Reference a column by name."""
    return Expr(name, "value")


def lit(value: Scalar) -> Expr:
    """A literal constant (``["const", v]`` in the grammar)."""
    if not _is_scalar(value):
        raise LogicalError(f"lit() takes a scalar, got {value!r}")
    return Expr(["const", value], "value")


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

AGG_FNS = ("sum", "count", "min", "max")

# Partial->final re-aggregation: per-fragment partials combine with these
# functions after the shuffle (counts re-aggregate as sums — owned by the
# optimizer's agg-split pass).
FINAL_AGG_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


@dataclasses.dataclass(frozen=True)
class Agg:
    """One aggregate: ``fn`` over input column ``column``, output ``name``."""
    fn: str
    column: str
    name: str

    def alias(self, name: str) -> "Agg":
        return dataclasses.replace(self, name=name)


def _agg(fn: str, column) -> Agg:
    if isinstance(column, Expr):
        column = column._colname(f"{fn} aggregate")
    return Agg(fn, column, f"{fn}_{column}")


def sum_(column) -> Agg:
    return _agg("sum", column)


def count_(column) -> Agg:
    return _agg("count", column)


def min_(column) -> Agg:
    return _agg("min", column)


def max_(column) -> Agg:
    return _agg("max", column)


# ---------------------------------------------------------------------------
# Logical IR nodes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scan:
    table: str
    columns: Optional[list[str]] = None     # None: inferred by pruning
    # Declared storage layout: stored partition i holds exactly the rows
    # with ``key % fanout == i`` (``(key, fanout)``). The optimizer's
    # partitioning-property pass treats such a scan like a shuffle output
    # — joins and aggregates keyed on ``key`` can elide their row/combine
    # shuffles entirely — and the worker verifies the declaration against
    # the actual key values at runtime before relying on it.
    partitioned_by: Optional[tuple[str, int]] = None


@dataclasses.dataclass
class Filter:
    child: object
    predicate: list                          # raw predicate grammar


@dataclasses.dataclass
class Project:
    child: object
    columns: list                            # physical format: str | [name, v]


@dataclasses.dataclass
class Join:
    left: object
    right: object
    left_on: str
    right_on: str


@dataclasses.dataclass
class Aggregate:
    child: object
    keys: list[str]
    aggs: list[Agg]


@dataclasses.dataclass
class Udf:
    child: object
    name: str
    kwargs: dict
    broadcast: Optional[dict] = None
    output_columns: Optional[list[str]] = None   # declared schema, if known


@dataclasses.dataclass
class LogicalQuery:
    """A named logical plan root plus physical hints the optimizer may use.

    ``shuffle_partitions`` pins the fan-out of row shuffles (join
    co-partitioning); when None the optimizer chooses from table stats
    and the measured ``core.bench_profile`` throughputs. Post-split
    aggregate-combine shuffles are always optimizer-owned (the partial
    aggregate has already shrunk the data; a global aggregate's combine
    is always 1 partition).
    """
    name: str
    root: object
    shuffle_partitions: Optional[int] = None


# ---------------------------------------------------------------------------
# Schema inference and expression walkers (shared with the optimizer)
# ---------------------------------------------------------------------------

def pred_columns(expr, out: Optional[set] = None) -> set:
    """Columns referenced by a predicate grammar node."""
    out = set() if out is None else out
    op = expr[0]
    if op in ("and", "or"):
        for sub in expr[1:]:
            pred_columns(sub, out)
    elif op == "ltcol":
        out.update((expr[1], expr[2]))
    else:
        out.add(expr[1])
    return out


def value_columns(expr, out: Optional[set] = None) -> set:
    """Columns referenced by a value grammar node."""
    out = set() if out is None else out
    if isinstance(expr, str):
        out.add(expr)
        return out
    op = expr[0]
    if op in ("mul", "add", "sub", "div"):
        value_columns(expr[1], out)
        value_columns(expr[2], out)
    elif op in ("sub1", "add1"):
        value_columns(expr[1], out)
    elif op == "case_in":
        out.add(expr[1])
    return out


def project_inputs(columns: list) -> set:
    """Columns a physical project op reads."""
    out: set = set()
    for c in columns:
        if isinstance(c, str):
            out.add(c)
        else:
            value_columns(c[1], out)
    return out


def join_output_schema(left: Optional[list[str]],
                       right: Optional[list[str]],
                       right_on: str) -> Optional[list[str]]:
    """The inner equi-join's output columns: probe/left columns plus
    build/right columns minus the build key (``operators.op_hash_join``
    drops it). The single source of truth for this rule — shared by
    logical schema inference, physical plan validation, and the
    optimizer's build-side lowering."""
    if left is None or right is None:
        return None
    return list(left) + [c for c in right if c != right_on]


def schema(node) -> Optional[list[str]]:
    """Output columns of a logical node, or None when unknown (bare scans
    without declared columns, UDFs without ``output_columns``)."""
    if isinstance(node, Scan):
        return list(node.columns) if node.columns is not None else None
    if isinstance(node, Filter):
        return schema(node.child)
    if isinstance(node, Project):
        return [c if isinstance(c, str) else c[0] for c in node.columns]
    if isinstance(node, Join):
        return join_output_schema(schema(node.left), schema(node.right),
                                  node.right_on)
    if isinstance(node, Aggregate):
        return list(node.keys) + [a.name for a in node.aggs]
    if isinstance(node, Udf):
        return list(node.output_columns) if node.output_columns else None
    raise TypeError(f"not a logical node: {node!r}")


# ---------------------------------------------------------------------------
# Fluent builder
# ---------------------------------------------------------------------------

class LogicalPlan:
    """Fluent builder over the IR. Every method returns a new builder; the
    wrapped tree is immutable once built."""

    def __init__(self, node):
        self.node = node

    def filter(self, predicate: Expr) -> "LogicalPlan":
        if not isinstance(predicate, Expr) or predicate.kind != "pred":
            raise LogicalError(f"filter() takes a predicate Expr, got "
                               f"{predicate!r}")
        return LogicalPlan(Filter(self.node, predicate.node))

    def select(self, *columns) -> "LogicalPlan":
        """Projection. Each arg: a column name, a bare ``col()`` (kept under
        its own name), or a derived value ``Expr`` with ``.alias(...)``."""
        out = []
        for c in columns:
            if isinstance(c, str):
                out.append(c)
            elif isinstance(c, Expr):
                c._require("value", "select()")
                if isinstance(c.node, str) and c.name in (None, c.node):
                    out.append(c.node)
                elif c.name is None:
                    raise LogicalError(
                        f"derived select expression {c.node!r} needs "
                        f".alias(name)")
                else:
                    out.append([c.name, c.node])
            else:
                raise LogicalError(f"select() argument {c!r} unsupported")
        return LogicalPlan(Project(self.node, out))

    def join(self, other: "LogicalPlan", on) -> "LogicalPlan":
        """Inner equi-join. ``on`` is ``(left_col, right_col)`` or a single
        shared column name. The optimizer picks the build side (smaller
        estimated input) and the shuffle fan-out."""
        if isinstance(on, str):
            left_on = right_on = on
        else:
            left_on, right_on = on
        return LogicalPlan(Join(self.node, other.node, left_on, right_on))

    def group_by(self, *keys: str) -> "GroupedPlan":
        names = [k._colname("group_by") if isinstance(k, Expr) else k
                 for k in keys]
        return GroupedPlan(self.node, names)

    def agg(self, *aggs: Agg) -> "LogicalPlan":
        """Global (keyless) aggregation over the whole input."""
        return GroupedPlan(self.node, []).agg(*aggs)

    def map_udf(self, name: str, kwargs: Optional[dict] = None,
                broadcast: Optional[dict] = None,
                output_columns: Optional[list[str]] = None) -> "LogicalPlan":
        """Apply a registered UDF (``operators.register_udf``) as a map
        stage. ``broadcast`` declares side-input columns loaded from the
        store at runtime; ``output_columns`` declares the UDF's output
        schema so downstream pruning/validation can see through it."""
        return LogicalPlan(Udf(self.node, name, dict(kwargs or {}),
                               broadcast, output_columns))

    def collect(self, name: str = "query",
                shuffle_partitions: Optional[int] = None) -> LogicalQuery:
        """Finalize into a named ``LogicalQuery`` (the IR root the
        optimizer lowers and ``Coordinator.run`` accepts directly)."""
        return LogicalQuery(name, self.node,
                            shuffle_partitions=shuffle_partitions)


class GroupedPlan:
    def __init__(self, node, keys: list[str]):
        self.node = node
        self.keys = keys

    def agg(self, *aggs: Agg) -> LogicalPlan:
        specs = []
        for a in aggs:
            if not isinstance(a, Agg):
                raise LogicalError(f"agg() takes Agg specs (sum_/count_/"
                                   f"min_/max_), got {a!r}")
            if a.fn not in AGG_FNS:
                raise LogicalError(f"unknown aggregate fn {a.fn!r}")
            specs.append(a)
        if not specs:
            raise LogicalError("agg() needs at least one aggregate")
        return LogicalPlan(Aggregate(self.node, list(self.keys), specs))


def scan(table: str, columns: Optional[list[str]] = None,
         partitioned_by: Optional[tuple[str, int]] = None) -> LogicalPlan:
    """Start a plan from a base table. ``columns`` may be omitted: the
    optimizer's projection pruning infers the referenced set (a bare scan
    feeding a UDF without ``output_columns`` still needs them spelled
    out). ``partitioned_by=(key, fanout)`` declares that the stored
    partition objects are hash-partitioned by ``key`` (see
    ``Scan.partitioned_by``) so downstream shuffles on that key can be
    elided."""
    if partitioned_by is not None:
        key, fanout = partitioned_by
        if not isinstance(key, str) or int(fanout) < 1:
            raise LogicalError(
                f"partitioned_by takes (column, fanout>=1), got "
                f"{partitioned_by!r}")
        partitioned_by = (key, int(fanout))
    return LogicalPlan(Scan(table,
                            list(columns) if columns is not None else None,
                            partitioned_by=partitioned_by))


# ---------------------------------------------------------------------------
# Pretty-printing (used by engine.explain)
# ---------------------------------------------------------------------------

def format_node(node, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(node, Scan):
        cols = f" {node.columns}" if node.columns is not None else " [*]"
        part = ""
        if node.partitioned_by is not None:
            part = (f" partitioned hash({node.partitioned_by[0]}) % "
                    f"{node.partitioned_by[1]}")
        return f"{pad}Scan[{node.table}]{cols}{part}"
    if isinstance(node, Filter):
        return (f"{pad}Filter[{node.predicate!r}]\n"
                + format_node(node.child, indent + 1))
    if isinstance(node, Project):
        return (f"{pad}Project{node.columns!r}\n"
                + format_node(node.child, indent + 1))
    if isinstance(node, Join):
        return (f"{pad}Join[{node.left_on} = {node.right_on}]\n"
                + format_node(node.left, indent + 1) + "\n"
                + format_node(node.right, indent + 1))
    if isinstance(node, Aggregate):
        aggs = [(a.name, a.fn, a.column) for a in node.aggs]
        return (f"{pad}Aggregate[keys={node.keys}, aggs={aggs}]\n"
                + format_node(node.child, indent + 1))
    if isinstance(node, Udf):
        out = f" -> {node.output_columns}" if node.output_columns else ""
        return (f"{pad}Udf[{node.name}]{out}\n"
                + format_node(node.child, indent + 1))
    return f"{pad}{node!r}"
