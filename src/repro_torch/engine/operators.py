"""Vectorized physical operators and JSON-able expression evaluation.

Workers execute pipelines of these operators over ColumnBatches (the
paper's engine uses a vectorized execution model, §3.2). Expressions are
nested lists so physical plans serialize to JSON (the coordinator receives
plans in JSON format [36]).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.engine.columnar import ColumnBatch

# ---------------------------------------------------------------------------
# Expressions: ["and", e1, e2] | ["lt", col, v] | ["ge", col, v]
#   | ["between", col, lo, hi] | ["in", col, [v...]] | ["ltcol", c1, c2]
#   | ["le", col, v] | ["eq", col, v] | ["gt", col, v] | ["ne", col, v]
#
# The authoring surface for this grammar is ``engine.logical`` (typed
# ``col``/``lit`` builders with operator overloads); plans may also carry
# hand-written nested lists, which is what the wire format stays.
# ---------------------------------------------------------------------------

# Both backends share these evaluators: the numpy backend calls them as-is
# over ColumnBatches, the torch backend evaluates them with
# ``xp=TorchNamespace(device)`` over dicts of device tensors (so a new op
# added here reaches both paths).

def eval_expr(expr, batch, xp=np) -> np.ndarray:
    op = expr[0]
    if op == "and":
        out = eval_expr(expr[1], batch, xp)
        for sub in expr[2:]:
            out = out & eval_expr(sub, batch, xp)
        return out
    if op == "or":
        out = eval_expr(expr[1], batch, xp)
        for sub in expr[2:]:
            out = out | eval_expr(sub, batch, xp)
        return out
    if op == "lt":
        return batch[expr[1]] < expr[2]
    if op == "le":
        return batch[expr[1]] <= expr[2]
    if op == "ge":
        return batch[expr[1]] >= expr[2]
    if op == "gt":
        return batch[expr[1]] > expr[2]
    if op == "eq":
        return batch[expr[1]] == expr[2]
    if op == "ne":
        return batch[expr[1]] != expr[2]
    if op == "between":   # inclusive bounds, like TPC-H discount predicate
        c = batch[expr[1]]
        return (c >= expr[2]) & (c <= expr[3])
    if op == "in":
        return xp.isin(batch[expr[1]], xp.asarray(expr[2]))
    if op == "ltcol":
        return batch[expr[1]] < batch[expr[2]]
    raise ValueError(f"unknown expr op {op!r}")


# Derived columns: ["mul", a, b] | ["add", a, b] | ["sub", a, b]
#   | ["div", a, b] | ["sub1", col] -> (1-col) | ["add1", col] -> (1+col)
#   | ["case_in", col, [vals]] -> 1.0/0.0
# where a/b are column names or ["const", v] or nested.
def eval_value(expr, batch, xp=np) -> np.ndarray:
    if isinstance(expr, str):
        return batch[expr]
    op = expr[0]
    if op == "const":
        return xp.asarray(expr[1])
    if op == "mul":
        return eval_value(expr[1], batch, xp) * eval_value(expr[2], batch, xp)
    if op == "add":
        return eval_value(expr[1], batch, xp) + eval_value(expr[2], batch, xp)
    if op == "sub":
        return eval_value(expr[1], batch, xp) - eval_value(expr[2], batch, xp)
    if op == "div":
        return eval_value(expr[1], batch, xp) / eval_value(expr[2], batch, xp)
    if op == "sub1":
        return 1.0 - eval_value(expr[1], batch, xp)
    if op == "add1":
        return 1.0 + eval_value(expr[1], batch, xp)
    if op == "case_in":   # ["case_in", col, [vals]] -> 1.0 / 0.0
        return _astype(xp.isin(batch[expr[1]], xp.asarray(expr[2])),
                       xp.result_type(1.0), xp)   # np: f64; torch: f32
    raise ValueError(f"unknown value op {op!r}")


def _astype(x, dtype, xp):
    """``x.astype(dtype)`` routed through the array namespace: numpy
    arrays cast themselves, torch tensors have no ``.astype`` and the
    namespace casts them."""
    return x.astype(dtype) if xp is np else xp.astype(x, dtype)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def op_filter(batch: ColumnBatch, expr) -> ColumnBatch:
    if batch.num_rows == 0:
        return batch
    return batch.select(eval_expr(expr, batch))


def op_project(batch: ColumnBatch, columns: list) -> ColumnBatch:
    """columns: list of name or [name, value-expr]."""
    if batch.num_rows == 0:
        # Empty inputs may lack a schema entirely (writers skip empty
        # shuffle partitions); synthesize absent columns as empty, but
        # keep the dtype of any column the batch does carry.
        return ColumnBatch({
            (c if isinstance(c, str) else c[0]):
            (batch[c] if isinstance(c, str) and c in batch
             else np.asarray([])) for c in columns})
    out = {}
    for c in columns:
        if isinstance(c, str):
            out[c] = batch[c]
        else:
            v = np.asarray(eval_value(c[1], batch))
            if v.ndim == 0:  # broadcast constants to row count
                v = np.full(batch.num_rows, v)
            out[c[0]] = v
    return ColumnBatch(out)


_AGG_FNS: dict[str, Callable] = {
    "sum": np.add.reduceat,
    "count": None,   # special-cased
    "min": np.minimum.reduceat,
    "max": np.maximum.reduceat,
}


def group_boundaries(batch: ColumnBatch, keys: list[str]
                     ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Sort rows by ``keys`` and find group starts. Returns
    ``(order, starts, first_key_values)`` — shared by both execution
    backends so their grouping semantics cannot drift."""
    if keys:
        key_arrays = [np.asarray(batch[k]) for k in keys]
        order = np.lexsort(key_arrays[::-1])
        sorted_keys = [a[order] for a in key_arrays]
        change = np.ones(len(order), dtype=bool)
        change[1:] = False
        for a in sorted_keys:
            change[1:] |= a[1:] != a[:-1]
        starts = np.flatnonzero(change)
        out = {k: a[starts] for k, a in zip(keys, sorted_keys)}
    else:
        order = np.arange(batch.num_rows)
        starts = np.asarray([0])
        out = {}
    return order, starts, out


def op_hash_agg(batch: ColumnBatch, keys: list[str],
                aggs: list[list]) -> ColumnBatch:
    """Group-by aggregate. aggs: [[out_name, fn, col], ...] with fn in
    sum|count|min|max (avg is composed as sum/count at finalization)."""
    if batch.num_rows == 0:
        # Empty aggregates keep the dtypes the non-empty case would
        # produce (keys from the input schema when it carries one,
        # int64 counts, float64 reductions) so empty shuffle partitions
        # concat cleanly with populated ones on both backends.
        cols = {k: np.asarray(batch[k] if k in batch else [])
                for k in keys}
        for out_name, fn, _ in aggs:
            cols[out_name] = np.asarray(
                [], dtype=np.int64 if fn == "count" else np.float64)
        return ColumnBatch(cols)
    order, starts, out = group_boundaries(batch, keys)
    for out_name, fn, col in aggs:
        if fn == "count":
            ends = np.append(starts[1:], len(order))
            out[out_name] = (ends - starts).astype(np.int64)
        else:
            vals = np.asarray(batch[col], dtype=np.float64)[order]
            out[out_name] = _AGG_FNS[fn](vals, starts)
    return ColumnBatch(out)


def op_hash_join(left: ColumnBatch, right: ColumnBatch, left_key: str,
                 right_key: str) -> ColumnBatch:
    """Inner equi-join; right side is the build side. Duplicate build keys
    expand: every probe row pairs with every matching build row (matches
    emitted in build sort order, probe rows kept in probe order), the
    standard SQL inner-join multiplicity. The compiled backend mirrors
    these semantics in-trace (counts/prefix expansion in
    ``compile._FusedTail``) and is parity-tested against this
    implementation, which remains the semantic reference."""
    if left.num_rows == 0 or right.num_rows == 0:
        cols = {k: np.asarray([]) for k in left}
        cols.update({k: np.asarray([]) for k in right if k != right_key})
        return ColumnBatch(cols)
    rkeys = np.asarray(right[right_key])
    order = np.argsort(rkeys, kind="stable")
    rsorted = rkeys[order]
    lkeys = np.asarray(left[left_key])
    if rsorted[1:].size and np.any(rsorted[1:] == rsorted[:-1]):
        # Duplicate build keys: expand each probe row by its match count.
        lo = np.searchsorted(rsorted, lkeys, side="left")
        hi = np.searchsorted(rsorted, lkeys, side="right")
        counts = hi - lo
        total = int(counts.sum())
        lsel = np.repeat(np.arange(len(lkeys)), counts)
        starts = np.cumsum(counts) - counts         # exclusive prefix
        rpos = np.arange(total) - np.repeat(starts, counts) \
            + np.repeat(lo, counts)
        rsel = order[rpos]
    else:
        # Unique build keys: single lower-bound probe.
        pos = np.searchsorted(rsorted, lkeys)
        pos = np.clip(pos, 0, len(rsorted) - 1)
        match = rsorted[pos] == lkeys
        lsel = np.flatnonzero(match)
        rsel = order[pos[match]]
    cols = {k: np.asarray(v)[lsel] for k, v in left.items()}
    for k, v in right.items():
        if k != right_key:
            cols[k] = np.asarray(v)[rsel]
    return ColumnBatch(cols)


def radix_partition_iter(batch: ColumnBatch, key_col: str, partitions: int):
    """Single-pass shuffle partitioner, chunked per-partition emission.

    Yields ``(p, batch_p)`` in partition order, gathering one partition's
    rows at a time: peak memory is the input + ONE partition's copy (plus
    the int64 order array), not input + a full reordered copy — the
    out-of-core shuffle writer serializes and drops each partition before
    the next is gathered. Row order within a partition is the stable
    input order, identical to materializing all partitions at once."""
    if batch.num_rows == 0:
        for p in range(partitions):
            yield p, batch
        return
    assign = np.asarray(batch[key_col]).astype(np.int64) % partitions
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=partitions)
    bounds = np.concatenate(([0], np.cumsum(counts)))
    cols = {k: np.asarray(v) for k, v in batch.items()}
    for p in range(partitions):
        sel = order[int(bounds[p]):int(bounds[p + 1])]
        yield p, ColumnBatch({k: v[sel] for k, v in cols.items()})


def radix_partition(batch: ColumnBatch, key_col: str, partitions: int
                    ) -> list[ColumnBatch]:
    """Single-pass shuffle partitioner. Returns ``partitions`` batches,
    the i-th holding the rows with ``key % partitions == i``. Callers
    that consume partitions one at a time should prefer
    ``radix_partition_iter``, which holds only one partition's copy."""
    return [b for _, b in radix_partition_iter(batch, key_col, partitions)]


# UDF registry (TPCx-BB Q3 style map-side session analysis).
_UDFS: dict[str, Callable] = {}


def register_udf(name: str):
    def deco(fn):
        _UDFS[name] = fn
        return fn
    return deco


def op_udf(batch: ColumnBatch, name: str, **kwargs) -> ColumnBatch:
    return _UDFS[name](batch, **kwargs)


@register_udf("clicks_before_purchase")
def clicks_before_purchase(batch: ColumnBatch, *, item_categories: np.ndarray,
                           target_category: int, window: int = 5
                           ) -> ColumnBatch:
    """TPCx-BB Q3 core: for each purchase of an item in the target category,
    emit the item_sks viewed in the preceding ``window`` clicks of the same
    user session (sorted by user, date, time)."""
    if batch.num_rows == 0:
        return ColumnBatch({"viewed_item": np.asarray([], dtype=np.int64),
                            "n": np.asarray([], dtype=np.int64)})
    order = np.lexsort((batch["wcs_click_time_sk"], batch["wcs_click_date_sk"],
                        batch["wcs_user_sk"]))
    user = np.asarray(batch["wcs_user_sk"])[order]
    item = np.asarray(batch["wcs_item_sk"])[order]
    ctype = np.asarray(batch["wcs_click_type"])[order]
    cats = np.asarray(item_categories)
    is_purchase = (ctype == 2) & (cats[item] == target_category)
    is_view = ctype == 0
    out: list[np.ndarray] = []
    purchase_idx = np.flatnonzero(is_purchase)
    for p in purchase_idx:
        lo = max(0, p - window)
        seg = slice(lo, p)
        same_user = user[seg] == user[p]
        out.append(item[seg][same_user & is_view[seg]])
    viewed = np.concatenate(out) if out else np.asarray([], dtype=np.int64)
    return ColumnBatch({"viewed_item": viewed,
                        "n": np.ones(len(viewed), dtype=np.int64)})


OPERATORS = {
    "filter": op_filter,
    "project": op_project,
    "hash_agg": op_hash_agg,
    "udf": op_udf,
}


def run_pipeline_ops(batch: ColumnBatch, ops: list[dict]) -> ColumnBatch:
    for spec in ops:
        kind = spec["op"]
        if kind == "filter":
            batch = op_filter(batch, spec["expr"])
        elif kind == "project":
            batch = op_project(batch, spec["columns"])
        elif kind == "hash_agg":
            batch = op_hash_agg(batch, spec["keys"], spec["aggs"])
        elif kind == "hash_join":
            # Build side is resolved by the worker into the op spec (it is
            # a runtime input, not part of the JSON plan).
            batch = op_hash_join(batch, spec["build"], spec["left_key"],
                                 spec["right_key"])
        elif kind == "udf":
            batch = op_udf(batch, spec["name"], **spec.get("kwargs", {}))
        else:
            raise ValueError(f"unknown operator {kind!r}")
    return batch
