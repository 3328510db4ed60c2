"""Torch execution backend (``"torch"``) for the query engine.

The numpy backend in ``operators.py`` interprets each expression node with
an intermediate array per node. This module runs the same JSON pipeline
specs on a torch device (``"cuda"`` unless the caller asks for the CPU),
with the engine's three hot operators on hand-written kernels:

* Runs of ``filter``/``project`` operators compile into stages per
  pipeline segment: consecutive predicates evaluate as one mask over
  just the referenced columns (copied to the device once), rows compact
  once per mask on the host, and each projection's derived columns
  evaluate over the compacted rows on the device.
* ``hash_join`` (plus every following ``filter``/``project``, plus the
  shuffle's partition assignment when the run reaches the fragment
  output) runs as one tail (``_FusedTail``): the sorted-probe kernel
  (``kernels.hash_join``) locates each probe key in the argsorted build
  side, downstream predicates AND into the join's match mask, derived
  projections evaluate over the probed columns, and the shuffle
  ``key % r`` partition assignment (floor-mod, as numpy's) is computed
  on the device. The host then takes the stable partition permutation
  (numpy's stable radix argsort) and gathers each output column once —
  pass-through columns from the ORIGINAL host arrays, so they keep their
  dtype.
* Duplicate build keys stay on the device: the range-probe kernel
  (``sorted_probe_range``) gives each probe row its match multiplicity,
  the host prefix-sums the counts, and the expansion (each output row's
  probe row and build position), the downstream ops and the partition
  assignment run over the expanded rows on the device — SQL inner-join
  semantics identical to ``op_hash_join``.
* A trailing ``hash_agg`` partitioned by one of its own group keys does
  not split the tail: the partition assignment commutes with the
  per-fragment partial aggregation, so the segment before the agg runs
  with the assignment and the aggregation runs per partition slice.
* ``hash_agg`` lexsorts the group keys on the host and hands the
  aggregate columns to the segmented-reduction kernel
  (``kernels.segment_reduce``), stacked so all same-mode aggregates
  reduce in one call.
* ``udf`` operators run the numpy implementations.

Float contract (the reference's jit backend, kept): the device computes
in float32 and int32. Float columns and literals narrow to float32,
integer columns to int32, at the device boundary; aggregate sums fold as
a pairwise tree, so aggregates match the float64 numpy backend at
rtol=1e-6. A float64 value within float32 epsilon of a predicate
constant can land on the other side of a filter (TPC data is quantized
to 2 decimals, far coarser). Integers are never truncated: segments
whose referenced integer columns or literals exceed int32, projections
whose derived expressions stay in integer arithmetic, and joins on wide
keys take the interpreted numpy route instead (``_overflows_int32``,
``_any_wide_int``, ``_int_valued``, ``_FusedTail._must_fall_back``).
Each such route is counted in ``FALLBACK_STATS``; a join's route warns
once per process.

Compiled stages are cached on the canonical JSON of their specs
(``plans.canonicalize_ops``: literal values travel separately), so the
fragments of one pipeline, and same-shape queries, share them.
"""
from __future__ import annotations

import collections
import functools
import json
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.engine import logical as engine_logical
from repro_torch.engine import operators
from repro_torch.engine import plans as engine_plans
from repro_torch.engine.columnar import ColumnBatch
from repro_torch.kernels import hash_join as hj_kernel
from repro_torch.kernels import segment_reduce as sr_kernel


# ---------------------------------------------------------------------------
# The device boundary
# ---------------------------------------------------------------------------

def _narrow_host(a: np.ndarray) -> np.ndarray:
    """The reference jit's x64-off widths: floats to float32, integers to
    int32 (the guards have checked they fit), bools as they are."""
    if a.dtype.kind == "f":
        return a.astype(np.float32)
    if a.dtype.kind in "iu":
        return a.astype(np.int32)
    return a.astype(bool)


def _to_device(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_narrow_host(np.asarray(a))).to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class TorchNamespace:
    """The array namespace ``operators.eval_expr``/``eval_value`` run with
    over dicts of device tensors: literals become tensors on the data's
    device at the narrowed widths, and ``case_in`` yields float32."""

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, v) -> torch.Tensor:
        return torch.as_tensor(_narrow_host(np.asarray(v)),
                               device=self.device)

    @staticmethod
    def isin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.isin(a, b)

    @staticmethod
    def result_type(_) -> torch.dtype:
        return torch.float32

    @staticmethod
    def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x.to(dtype)


# Interpreted routes taken because the device's int32/float32 widths could
# not hold the data (see the module docstring), by stage kind. Empty
# inputs are not counted: they have nothing to compute.
FALLBACK_STATS = {"mask": 0, "project": 0, "tail": 0, "dup_expand": 0,
                  "hash_agg_groups": 0}


# ---------------------------------------------------------------------------
# Expression analysis (evaluation itself is shared: operators.eval_expr /
# eval_value with a TorchNamespace; the referenced-column walkers are
# shared with the logical planner so the two layers cannot drift)
# ---------------------------------------------------------------------------

_expr_refs = engine_logical.pred_columns
_value_refs = engine_logical.value_columns


# ---------------------------------------------------------------------------
# Canonical literals (the compiled-stage cache boundary)
# ---------------------------------------------------------------------------
#
# Stages and tails compile from CANONICAL op specs: literal values are
# ``[plans.LIT, i, tag]`` placeholders and arrive per call as a separate
# binding, so the caches key on plan SHAPE. The device path binds the
# narrowed literals (``_narrow_lits``); interpreted fallbacks and host-side
# const evaluation bind the original Python values (numpy dtype semantics
# preserved, e.g. ``np.full`` of a Python float stays float64).

def _subst(node, vals):
    """Re-bind placeholder nodes to concrete literal values."""
    if isinstance(node, (list, tuple)):
        if len(node) == 3 and node[0] == engine_plans.LIT:
            return vals[node[1]]
        return [_subst(x, vals) for x in node]
    return node


def _lit_indices(node, out: set) -> set:
    if isinstance(node, (list, tuple)):
        if len(node) == 3 and node[0] == engine_plans.LIT:
            out.add(node[1])
        else:
            for x in node:
                _lit_indices(x, out)
    return out


def _flat_lits(vals) -> list:
    """Scalar view of literal values (list literals flatten) for the
    wide-int guards."""
    out: list = []
    for v in vals:
        if isinstance(v, list):
            out.extend(v)
        else:
            out.append(v)
    return out


def _narrow_lits(lits) -> tuple:
    """The device path's literal binding at the reference jit's widths.
    Scalars stay Python scalars (torch never widens a tensor for a
    Python scalar of the same kind) holding the float32 / int32 value;
    list literals become narrowed arrays. Integers beyond int32 keep
    their value: the stage that references one has already diverted to
    its interpreted path."""
    out = []
    for v in lits:
        if isinstance(v, list):
            a = np.asarray(v)
            if a.dtype.kind == "f":
                a = a.astype(np.float32)
            elif a.dtype.kind in "iu" and not _any_wide_int(v):
                a = a.astype(np.int32)
            out.append(a)
        elif isinstance(v, (bool, int)):
            out.append(v)
        else:
            out.append(float(np.float32(v)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Fused filter/project segments
# ---------------------------------------------------------------------------
#
# A segment (maximal run of filter/project ops) compiles into stages over a
# numpy column environment:
#   MaskStage    — all consecutive predicates as one mask evaluation over
#                  the referenced columns on the device, then one
#                  compaction gather per live column on the host;
#   ProjectStage — pass-throughs are moved (no copy), constant outputs are
#                  filled in numpy, and the derived expressions evaluate
#                  on the device over the (compacted) inputs.
# Moving only the referenced columns keeps the host->device copy off the
# untouched columns.

class _MaskStage:
    def __init__(self, exprs: list):
        self.exprs = exprs                   # canonical (placeholder) form
        self.refs = sorted(set().union(
            *[_expr_refs(e, set()) for e in exprs]))
        self._lit_idx = sorted(_lit_indices(exprs, set()))

    def run(self, env: dict, lits, device: torch.device) -> dict:
        own = _flat_lits([lits[i] for i in self._lit_idx])
        if _any_wide_int(own) or \
                any(_overflows_int32(env[k]) for k in self.refs):
            # int32 narrowing would flip the comparison: evaluate the
            # predicates interpreted instead (original literal values).
            FALLBACK_STATS["mask"] += 1
            bound = [_subst(e, lits) for e in self.exprs]
            mask = operators.eval_expr(bound[0], env)
            for e in bound[1:]:
                mask = mask & operators.eval_expr(e, env)
        else:
            xp = TorchNamespace(device)
            cols = {k: _to_device(env[k], device) for k in self.refs}
            bound = [_subst(e, _narrow_lits(lits)) for e in self.exprs]
            m = operators.eval_expr(bound[0], cols, xp=xp)
            for e in bound[1:]:
                m = m & operators.eval_expr(e, cols, xp=xp)
            mask = _to_host(m)
        idx = np.flatnonzero(mask)
        return {k: v[idx] for k, v in env.items()}


def _int_valued(expr, env: dict) -> bool:
    """True when numpy would evaluate ``expr`` in integer arithmetic —
    which the device path would narrow to int32 and silently overflow."""
    if isinstance(expr, str):
        return env[expr].dtype.kind in "iu"
    op = expr[0]
    if op == "const":
        return isinstance(expr[1], (int, np.integer)) \
            and not isinstance(expr[1], bool)
    if op in ("mul", "add", "sub"):
        return _int_valued(expr[1], env) and _int_valued(expr[2], env)
    return False   # div / sub1 / add1 / case_in produce floats


def _fill(v, n: int) -> torch.Tensor:
    return v.expand(n) if v.dim() == 0 else v


class _ProjectStage:
    def __init__(self, columns: list):
        self.columns = columns               # canonical (placeholder) form
        self.passthrough = [c for c in columns if isinstance(c, str)]
        derived = [(c[0], c[1]) for c in columns if not isinstance(c, str)]
        self.consts = [(name, expr) for name, expr in derived
                       if not _value_refs(expr, set())]
        self.computed = [(name, expr) for name, expr in derived
                         if _value_refs(expr, set())]
        self.refs = sorted(set().union(
            set(), *[_value_refs(e, set()) for _, e in self.computed]))
        self.order = [c if isinstance(c, str) else c[0] for c in columns]
        self._lit_idx = sorted(_lit_indices(
            [e for _, e in self.computed], set()))

    def run(self, env: dict, lits, device: torch.device) -> dict:
        own = _flat_lits([lits[i] for i in self._lit_idx])
        computed_host = [(name, _subst(e, lits)) for name, e in
                         self.computed]
        if _any_wide_int(own) \
                or any(_overflows_int32(env[k]) for k in self.refs) \
                or any(_int_valued(e, env) for _, e in computed_host):
            # int32 narrowing of wide inputs, wide literals, or derived
            # integer arithmetic would corrupt values; evaluate the whole
            # projection interpreted (rare — TPC derived columns are
            # float arithmetic over in-range data).
            FALLBACK_STATS["project"] += 1
            return dict(operators.op_project(ColumnBatch(env),
                                             _subst(self.columns, lits)))
        n = len(next(iter(env.values()))) if env else 0
        out = {name: env[name] for name in self.passthrough}
        for name, expr in self.consts:
            # Host-side constant fill with the ORIGINAL literal value:
            # np.full of a Python float keeps the numpy backend's float64
            # output dtype.
            out[name] = np.full(
                n, np.asarray(operators.eval_value(_subst(expr, lits),
                                                   ColumnBatch({}))))
        if self.computed:
            xp = TorchNamespace(device)
            cols = {k: _to_device(env[k], device) for k in self.refs}
            narrow = _narrow_lits(lits)
            for name, expr in self.computed:
                v = operators.eval_value(_subst(expr, narrow), cols, xp=xp)
                out[name] = _to_host(_fill(v, n).contiguous())
        return {name: out[name] for name in self.order}


@functools.lru_cache(maxsize=256)
def _compile_segment(segment_json: str):
    """Compiled stages for a CANONICAL segment JSON (literal values are
    placeholder nodes, so shape-compatible queries share one entry)."""
    segment = json.loads(segment_json)
    stages = []
    i = 0
    while i < len(segment):
        if segment[i]["op"] == "filter":
            exprs = []
            while i < len(segment) and segment[i]["op"] == "filter":
                exprs.append(segment[i]["expr"])
                i += 1
            stages.append(_MaskStage(exprs))
        else:
            stages.append(_ProjectStage(segment[i]["columns"]))
            i += 1
    return stages


# Compiled-stage cache observability (read by serving metrics): lookups
# and hits of the canonical-keyed caches.
TRACE_CACHE_STATS = {"segment_lookups": 0, "segment_hits": 0,
                     "tail_lookups": 0, "tail_hits": 0}


def _counted(cache_fn, kind: str, *args):
    """Call an lru-cached compile function, recording hit/miss. Fragments
    execute serially per process, so the cache_info delta is race-free."""
    before = cache_fn.cache_info().hits
    out = cache_fn(*args)
    TRACE_CACHE_STATS[f"{kind}_lookups"] += 1
    if cache_fn.cache_info().hits > before:
        TRACE_CACHE_STATS[f"{kind}_hits"] += 1
    return out


def _canon_json(ops: list[dict]) -> tuple[str, list]:
    canon, lits = engine_plans.canonicalize_ops(ops)
    return json.dumps(canon, sort_keys=True), lits


_INT32_MAX = np.iinfo(np.int32).max
_INT32_MIN = np.iinfo(np.int32).min

# The int32 fallback warning fires once per process: silent per-fragment
# warnings would flood a query's log, silence would hide that a "torch"
# query is quietly running its joins interpreted.
_INT32_FALLBACK_WARNED = False


def _warn_int32_fallback(detail: str) -> None:
    global _INT32_FALLBACK_WARNED
    if _INT32_FALLBACK_WARNED:
        return
    _INT32_FALLBACK_WARNED = True
    warnings.warn(
        "torch backend: a compiled hash_join fell back to the interpreted "
        f"numpy reference ({detail}). The device probe narrows keys "
        "and referenced columns to int32; wider values execute on numpy "
        "instead — results are identical but the fragment runs at "
        "interpreted speed. Emitted once per process; "
        "engine.compile.FALLBACK_STATS counts every such route.",
        RuntimeWarning, stacklevel=2)


def _overflows_int32(v: np.ndarray) -> bool:
    if v.dtype.kind not in "iu" or v.size == 0:
        return False
    if v.dtype.itemsize <= 4 and v.dtype != np.uint32:
        return False   # int32 and narrower always fit
    return bool(v.max() > _INT32_MAX or v.min() < _INT32_MIN)


def _any_wide_int(consts: list) -> bool:
    return any(isinstance(c, (int, np.integer))
               and not isinstance(c, bool)
               and not _INT32_MIN <= c <= _INT32_MAX for c in consts)


def _run_fused(batch: ColumnBatch, segment: list[dict],
               device: torch.device) -> ColumnBatch:
    if batch.num_rows == 0 or not len(batch):
        # Empty (possibly schema-less) inputs keep the interpreted path's
        # empty-batch semantics.
        return operators.run_pipeline_ops(batch, segment)
    # Per-stage int32-narrowing guards live in the stages themselves (a
    # stage may consume wide integers produced by an earlier one).
    canon, lits = _canon_json(segment)
    env = {k: np.asarray(v) for k, v in batch.items()}
    for stage in _counted(_compile_segment, "segment", canon):
        env = stage.run(env, lits, device)
    return ColumnBatch(env)


# ---------------------------------------------------------------------------
# Fused join -> ops -> partition tail
# ---------------------------------------------------------------------------
#
# A tail is ``[hash_join?] + (filter|project)*`` optionally terminated by
# the fragment's shuffle partition. On the device: the probe (sorted-probe
# kernel over the argsorted build side), the fused predicate mask, every
# derived projection, and the partition assignment (``r`` = dead-row
# sentinel for unmatched/filtered rows). On the host: the stable partition
# permutation with one radix argsort, and exactly one gather per surviving
# output column — from the ORIGINAL arrays for pass-through columns (dtype
# preserved) and from the device outputs for derived ones.
#
# Duplicate build keys take a two-step variant (the output row count is
# data-dependent, so it must cross to the host once): the range probe
# returns each probe row's match multiplicity; the host prefix-sums the
# counts; the device expands the multiplicity (output row j belongs to
# probe row i at build position ``lo[i] + j - prefix[i]``), evaluates the
# downstream ops over the expanded rows, and assigns partitions. Matches
# come in build sort order within a probe row and probe rows stay in
# probe order — byte-identical to ``operators.op_hash_join``.

def _int_valued_sim(expr, int_kinds: dict) -> bool:
    """``operators``-free mirror of ``_int_valued`` over a simulated
    schema (column name -> is-integer-kind)."""
    if isinstance(expr, str):
        return int_kinds[expr]
    op = expr[0]
    if op == "const":
        return isinstance(expr[1], (int, np.integer)) \
            and not isinstance(expr[1], bool)
    if op in ("mul", "add", "sub"):
        return _int_valued_sim(expr[1], int_kinds) \
            and _int_valued_sim(expr[2], int_kinds)
    return False


class _FusedTail:
    """``[hash_join?] + (filter|project)*`` (+ optional radix partition)
    on the device — see the section comment above."""

    def __init__(self, segment: list[dict], partition):
        self.segment = segment               # canonical (placeholder) form
        self.partition = partition           # (key_col, partitions) | None
        self.join = segment[0] if segment and segment[0]["op"] == "hash_join" \
            else None
        self.ops = segment[1:] if self.join else segment
        # Last build-side prep (argsort, bucket table, payload gathers and
        # their device copies), keyed by the identity of the build's HOST
        # key array. Morsel-wise probing runs the same tail many times
        # against one build; the held reference keeps the key array alive
        # so an `is` check can never false-positive on a recycled id.
        self._build_prep: Optional[tuple] = None

    # -- plan analysis (per input schema) ----------------------------------
    def _resolve_needed(self, left_names, right_names):
        """Walk the ops over a name-level schema. Returns
        ``(final_sources, left_in, right_in)``: the origin of every final
        output column ('left'|'right'|'derived'|'const') and the concrete
        left/right columns the device path must receive (expression
        references plus the join and partition keys); derived columns are
        recomputed on the device in op order."""
        left_in, right_in = set(), set()
        sources = {c: ("left", c) for c in left_names}
        if self.join:
            left_in.add(self.join["left_key"])
            for c in right_names:
                if c != self.join["right_key"]:
                    sources[c] = ("right", c)
        # A needed name resolves against the schema at its reference
        # point; walking ops in order and resolving eagerly is equivalent
        # because project() rebinds names before later references.
        for op in self.ops:
            if op["op"] == "filter":
                for r in _expr_refs(op["expr"], set()):
                    src = sources[r]
                    if src[0] == "left":
                        left_in.add(src[1])
                    elif src[0] == "right":
                        right_in.add(src[1])
            else:
                new = {}
                for c in op["columns"]:
                    if isinstance(c, str):
                        new[c] = sources[c]
                    else:
                        name, expr = c[0], c[1]
                        for r in _value_refs(expr, set()):
                            src = sources[r]
                            if src[0] == "left":
                                left_in.add(src[1])
                            elif src[0] == "right":
                                right_in.add(src[1])
                        new[name] = ("derived", expr) \
                            if _value_refs(expr, set()) else ("const", expr)
                sources = new
        if self.partition is not None:
            src = sources[self.partition[0]]
            if src[0] == "left":
                left_in.add(src[1])
            elif src[0] == "right":
                right_in.add(src[1])
        return sources, sorted(left_in), sorted(right_in)

    # -- guards -------------------------------------------------------------
    def _empty_inputs(self, batch, build) -> bool:
        if batch.num_rows == 0 or not len(batch):
            return True
        return self.join is not None and (build.num_rows == 0
                                          or not len(build))

    def _must_fall_back(self, batch, build, left_in, right_in,
                        sources_host, ops_host, wide_lits) -> bool:
        if wide_lits:
            return True
        if self.join is not None:
            lk = np.asarray(batch[self.join["left_key"]])
            rk = np.asarray(build[self.join["right_key"]])
            if lk.dtype.kind not in "iu" or rk.dtype.kind not in "iu":
                return True
            for name, vals in ((self.join["left_key"], lk),
                               (self.join["right_key"], rk)):
                if _overflows_int32(vals):
                    _warn_int32_fallback(
                        f"join key column {name!r} exceeds int32 range "
                        f"(max value {int(vals.max())}, "
                        f"min value {int(vals.min())})")
                    return True
        for c in left_in:
            v = np.asarray(batch[c])
            if _overflows_int32(v):
                if self.join is not None:
                    _warn_int32_fallback(
                        f"probe-side column {c!r} exceeds int32 range "
                        f"(max value {int(v.max())})")
                return True
        for c in right_in:
            v = np.asarray(build[c])
            if _overflows_int32(v):
                if self.join is not None:
                    _warn_int32_fallback(
                        f"build-side column {c!r} exceeds int32 range "
                        f"(max value {int(v.max())})")
                return True
        # Derived integer arithmetic would narrow to int32 (mirrors
        # _ProjectStage's guard) — simulate dtype kinds through the ops
        # (literal-substituted form: placeholders carry no type info).
        int_kinds = {c: np.asarray(v).dtype.kind in "iu"
                     for c, v in batch.items()}
        if self.join is not None:
            for c, v in build.items():
                if c != self.join["right_key"]:
                    int_kinds[c] = np.asarray(v).dtype.kind in "iu"
        for op in ops_host:
            if op["op"] != "project":
                continue
            kinds = {}
            for c in op["columns"]:
                if isinstance(c, str):
                    kinds[c] = int_kinds[c]
                else:
                    name, expr = c[0], c[1]
                    iv = _int_valued_sim(expr, int_kinds)
                    if iv and _value_refs(expr, set()):
                        return True
                    kinds[name] = iv
            int_kinds = kinds
        if self.partition is not None:
            src = sources_host[self.partition[0]]
            if src[0] == "const":
                v = operators.eval_value(src[1], ColumnBatch({}))
                if np.asarray(v).dtype.kind not in "iu":
                    return True
            elif not int_kinds[self.partition[0]]:
                return True   # numpy truncates float keys; keep its path
        return False

    def _host_ops(self, lits) -> list[dict]:
        """The segment's ops with original literal values re-bound — what
        the interpreted fallback and host-side guards evaluate."""
        out = []
        for op in self.ops:
            if op["op"] == "filter":
                out.append({"op": "filter", "expr": _subst(op["expr"],
                                                           lits)})
            elif op["op"] == "project":
                out.append({"op": "project",
                            "columns": _subst(op["columns"], lits)})
            else:
                out.append(op)
        return out

    def _numpy_tail(self, batch, build, ops_host):
        if self.join is not None:
            batch = operators.op_hash_join(batch, build,
                                           self.join["left_key"],
                                           self.join["right_key"])
        batch = operators.run_pipeline_ops(batch, ops_host)
        if self.partition is not None:
            return operators.radix_partition(batch, self.partition[0],
                                             self.partition[1])
        return batch

    # -- device computation -------------------------------------------------
    def _device_ops(self, sources, env, match, n, lits, device):
        """Fused predicate mask, derived projections, and the partition
        assignment over an env of device columns. ``lits`` is the narrowed
        literal binding."""
        xp = TorchNamespace(device)
        for op in self.ops:
            if op["op"] == "filter":
                match = match & operators.eval_expr(
                    _subst(op["expr"], lits), env, xp=xp)
            else:
                new = dict(env)        # keep shadowed inputs reachable for
                for c in op["columns"]:            # later env lookups
                    if not isinstance(c, str):
                        v = operators.eval_value(_subst(c[1], lits), env,
                                                 xp=xp)
                        new[c[0]] = _fill(v, n)
                env = new
        if self.partition is not None:
            key, nparts = self.partition[0], self.partition[1]
            src = sources[key]
            kv = operators.eval_value(_subst(src[1], lits), env, xp=xp) \
                if src[0] == "const" else env[key]
            # Floor-mod on int32, as numpy's % on the int64 key.
            assign = torch.where(match, kv.to(torch.int32) % nparts, nparts)
        else:
            assign = torch.where(match, 0, 1)
        derived_out = sorted(nm for nm, s in sources.items()
                             if s[0] == "derived")
        return _to_host(assign), {nm: _to_host(env[nm].contiguous())
                                  for nm in derived_out}

    # -- host finalization --------------------------------------------------
    @staticmethod
    def _stable_partition(assign: np.ndarray, r: int):
        """One radix argsort for the stable partition permutation."""
        lividx = np.flatnonzero(assign < r)
        if r == 1:
            return lividx, np.asarray([len(lividx)])   # already in order
        order = lividx[np.argsort(assign[lividx], kind="stable")]
        return order, np.bincount(assign[lividx], minlength=r)

    def _gather_out(self, batch, bpay_out, sources_host, derived, order,
                    left_sel, right_sel):
        """Exactly one gather per output column — from the ORIGINAL
        arrays for pass-through columns (dtype preserved), from the
        device outputs for derived ones. ``sources_host`` carries the
        original (un-placeholdered) literal values so const fills keep
        numpy dtype semantics."""
        out = {}
        for name, src in sources_host.items():
            if src[0] == "left":
                out[name] = np.asarray(batch[src[1]])[left_sel]
            elif src[0] == "right":
                out[name] = bpay_out[src[1]][right_sel]
            elif src[0] == "derived":
                out[name] = derived[name][order]
            else:   # const: numpy dtype semantics (np.full of a scalar)
                out[name] = np.full(len(order), np.asarray(
                    operators.eval_value(src[1], ColumnBatch({}))))
        return out

    def _emit(self, out: dict, counts: np.ndarray, r: int):
        if self.partition is None:
            return ColumnBatch(out)
        bounds = np.concatenate(([0], np.cumsum(counts)))
        return [ColumnBatch({k: v[bounds[p]:bounds[p + 1]]
                             for k, v in out.items()})
                for p in range(r)]

    def _prepare_build(self, build, right_in, final_sources, device):
        """Host-side build prep: argsort, bucket table, payload gathers,
        and their device copies. Memoized on the identity of the build's
        host key array: out-of-core morsel streaming probes one build with
        many small batches, and the O(build) argsort, gathers and copies
        must not be paid per morsel."""
        rkeys = np.asarray(build[self.join["right_key"]])
        out_cols = {src[1] for src in final_sources.values()
                    if src[0] == "right"}
        prep_key = (tuple(right_in), tuple(sorted(out_cols)), device)
        if self._build_prep is not None \
                and self._build_prep[0] is rkeys \
                and self._build_prep[1] == prep_key:
            return self._build_prep[2]
        border = np.argsort(rkeys, kind="stable")
        bs = rkeys[border].astype(np.int32)
        has_dups = bool(bs[1:].size and np.any(bs[1:] == bs[:-1]))
        table = hj_kernel.probe_table(bs, device)
        # One gather per needed payload column: the host copy serves the
        # pass-through outputs (original dtype preserved), the device copy
        # feeds the downstream ops.
        bpay_out, bpay_dev = {}, {}
        for c in sorted(set(right_in) | out_cols):
            v = np.asarray(build[c])[border]
            if c in out_cols:
                bpay_out[c] = v
            if c in right_in:
                bpay_dev[c] = _to_device(v, device)
        prep = (table.build, has_dups, table, bpay_dev, bpay_out)
        self._build_prep = (rkeys, prep_key, prep)
        return prep

    # -- execution ----------------------------------------------------------
    def run(self, batch: ColumnBatch, build, lits, device: torch.device):
        left_names = list(batch)
        right_names = list(build) if build is not None else []
        final_sources, left_in, right_in = self._resolve_needed(
            left_names, right_names)
        ops_host = self._host_ops(lits)
        sources_host = {k: ((s[0], _subst(s[1], lits)) if s[0] == "const"
                            else s)
                        for k, s in final_sources.items()}
        device_work = self.join is not None \
            or any(op["op"] == "filter" for op in self.ops) \
            or any(s[0] == "derived" for s in final_sources.values())
        if not device_work or not left_in \
                or self._empty_inputs(batch, build):
            return self._numpy_tail(batch, build, ops_host)
        if self._must_fall_back(batch, build, left_in, right_in,
                                sources_host, ops_host,
                                _any_wide_int(_flat_lits(lits))):
            FALLBACK_STATS["tail"] += 1
            return self._numpy_tail(batch, build, ops_host)
        lits_t = _narrow_lits(lits)
        n = batch.num_rows
        r = self.partition[1] if self.partition is not None else 1
        left_cols = {c: _to_device(batch[c], device) for c in left_in}

        if self.join is None:
            match = torch.ones(n, dtype=torch.bool, device=device)
            assign, derived = self._device_ops(final_sources, left_cols,
                                               match, n, lits_t, device)
            order, counts = self._stable_partition(assign, r)
            out = self._gather_out(batch, {}, sources_host, derived, order,
                                   order, None)
            return self._emit(out, counts, r)

        (bkeys, has_dups, table, bpay_dev,
         bpay_out) = self._prepare_build(build, right_in, final_sources,
                                         device)
        lkeys = left_cols[self.join["left_key"]]
        if has_dups:
            return self._run_dup(batch, build, ops_host, final_sources,
                                 sources_host, left_in, right_in, left_cols,
                                 lits_t, bkeys, table, bpay_dev, bpay_out, n,
                                 r, device)
        pos, match = hj_kernel.sorted_probe(bkeys, lkeys, table=table)
        env = dict(left_cols)
        gather = pos.to(torch.int64)
        for c in right_in:
            env[c] = bpay_dev[c][gather]
        assign, derived = self._device_ops(final_sources, env, match, n,
                                           lits_t, device)
        order, counts = self._stable_partition(assign, r)
        needs_pos = any(s[0] == "right" for s in final_sources.values())
        right_sel = _to_host(pos)[order] if needs_pos else None
        out = self._gather_out(batch, bpay_out, sources_host, derived,
                               order, order, right_sel)
        return self._emit(out, counts, r)

    def _run_dup(self, batch, build, ops_host, sources, sources_host,
                 left_in, right_in, left_cols, lits_t, bkeys, table,
                 bpay_dev, bpay_out, n, r, device):
        """Duplicate-build-key join: range probe and counts, host prefix,
        device expansion (see the section comment above)."""
        lo, hi, match = hj_kernel.sorted_probe_range(
            bkeys, left_cols[self.join["left_key"]], table=table)
        counts = torch.where(match, hi - lo, 0)
        prefix = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(_to_host(counts), dtype=np.int64, out=prefix[1:])
        total = int(prefix[-1])
        if total == 0:
            # Nothing matched: the interpreted tail is O(probe) and keeps
            # the empty-output schema semantics in one place.
            return self._numpy_tail(batch, build, ops_host)
        if total > _INT32_MAX:
            _warn_int32_fallback(
                f"duplicate-key expansion of {total} rows exceeds int32")
            FALLBACK_STATS["dup_expand"] += 1
            return self._numpy_tail(batch, build, ops_host)
        prefix_d = torch.from_numpy(prefix).to(device)
        lsel = torch.repeat_interleave(
            torch.arange(n, device=device), counts.to(torch.int64),
            output_size=total)
        j = torch.arange(total, device=device)
        rpos = lo.to(torch.int64)[lsel] + (j - prefix_d[lsel])
        env = {c: left_cols[c][lsel] for c in left_in}
        for c in right_in:
            env[c] = bpay_dev[c][rpos]
        valid = torch.ones(total, dtype=torch.bool, device=device)
        assign, derived = self._device_ops(sources, env, valid, total,
                                           lits_t, device)
        order, counts_p = self._stable_partition(assign, r)
        out = self._gather_out(batch, bpay_out, sources_host, derived,
                               order, _to_host(lsel)[order],
                               _to_host(rpos)[order])
        return self._emit(out, counts_p, r)


@functools.lru_cache(maxsize=256)
def _compile_tail(segment_json: str, partition) -> _FusedTail:
    return _FusedTail(json.loads(segment_json), partition)


def _strip_build(op: dict) -> dict:
    return {k: v for k, v in op.items() if k != "build"}


def _run_tail(batch: ColumnBatch, segment: list[dict], partition,
              device: torch.device):
    build = segment[0].get("build") if segment and \
        segment[0]["op"] == "hash_join" else None
    canon, lits = _canon_json([_strip_build(op) for op in segment])
    tail = _counted(_compile_tail, "tail", canon, partition)
    return tail.run(batch, build, lits, device)


# ---------------------------------------------------------------------------
# hash_agg over the segmented-reduction kernel
# ---------------------------------------------------------------------------

# The reference's routing, kept: above this group cardinality hash_agg
# takes the numpy float64 sort+reduceat path.
_MAX_KERNEL_GROUPS = 1024


def _run_hash_agg(batch: ColumnBatch, keys: list[str], aggs: list[list],
                  device: torch.device) -> ColumnBatch:
    if batch.num_rows == 0:
        return operators.op_hash_agg(batch, keys, aggs)
    n = batch.num_rows
    order, starts, out = operators.group_boundaries(batch, keys)
    if not keys:
        # order is a true permutation only in the keyed case; the global
        # aggregate (keys=[]) reduces in input order.
        order = None
    n_groups = len(starts)
    offsets = np.append(starts, n)
    counts = np.diff(offsets)
    if n_groups > _MAX_KERNEL_GROUPS:
        FALLBACK_STATS["hash_agg_groups"] += 1
        for name, fn, col in aggs:
            if fn == "count":
                continue
            vals = np.asarray(batch[col], dtype=np.float64)
            out[name] = operators._AGG_FNS[fn](
                vals[order] if order is not None else vals, starts)
    else:
        # Same-mode aggregates stack into one kernel call over the groups'
        # row offsets: each group is one contiguous run of the sorted rows.
        for mode in ("sum", "min", "max"):
            group = [(name, col) for name, fn, col in aggs if fn == mode]
            if not group:
                continue
            vals = np.empty((len(group), n), dtype=np.float32)
            for row, (_, col) in enumerate(group):
                v = np.asarray(batch[col], dtype=np.float32)
                vals[row] = v[order] if order is not None else v
            red = _to_host(sr_kernel.segment_reduce(
                torch.from_numpy(vals).to(device), offsets=offsets,
                mode=mode))
            for row, (name, _) in enumerate(group):
                out[name] = red[row].astype(np.float64)
    for name, fn, _ in aggs:
        if fn == "count":
            out[name] = counts.astype(np.int64)
    # Match the interpreted backend's column order: keys, then aggs.
    return ColumnBatch({name: out[name]
                        for name in list(keys) + [a[0] for a in aggs]})


# ---------------------------------------------------------------------------
# Pipeline drivers
# ---------------------------------------------------------------------------

def run_pipeline_torch(batch: ColumnBatch, ops: list[dict],
                       device: torch.device) -> ColumnBatch:
    """Execute a pipeline spec on the torch backend. Result-compatible
    with ``operators.run_pipeline_ops`` (modulo float32 accumulation)."""
    i = 0
    while i < len(ops):
        kind = ops[i]["op"]
        if kind in ("filter", "project"):
            j = i
            while j < len(ops) and ops[j]["op"] in ("filter", "project"):
                j += 1
            batch = _run_fused(batch, ops[i:j], device)
            i = j
        elif kind == "hash_join":
            # The join and every following filter/project run together:
            # predicates AND into the probe's match mask, so the join
            # output compacts once, after all of them.
            j = i + 1
            while j < len(ops) and ops[j]["op"] in ("filter", "project"):
                j += 1
            batch = _run_tail(batch, ops[i:j], None, device)
            i = j
        elif kind == "hash_agg":
            batch = _run_hash_agg(batch, ops[i]["keys"], ops[i]["aggs"],
                                  device)
            i += 1
        elif kind == "udf":
            batch = operators.op_udf(batch, ops[i]["name"],
                                     **ops[i].get("kwargs", {}))
            i += 1
        else:
            raise ValueError(f"unknown operator {kind!r}")
    return batch


# Ops whose output over a concatenation of morsels equals the
# concatenation of their per-morsel outputs, bit for bit: filters and
# projections are row-local, and a hash-join probe depends only on the
# (whole) build side, emitting matches in probe order. Aggregates and
# UDFs are barriers — they need the full fragment.
STREAMABLE_OPS = ("filter", "project", "hash_join")


def streamable_prefix(ops: list[dict]) -> int:
    """Number of leading ops safe to evaluate morsel-at-a-time with
    bit-identical concatenated output (see ``STREAMABLE_OPS``). The
    out-of-core worker streams this prefix and accumulates (spilling
    under memory pressure) before the first barrier op."""
    for i, op in enumerate(ops):
        if op["op"] not in STREAMABLE_OPS:
            return i
    return len(ops)


def _fusable_tail_start(ops: list[dict]) -> int:
    """Index where the trailing ``[hash_join?] + (filter|project)*`` run
    begins (``len(ops)`` when the pipeline ends in an agg/udf)."""
    t = len(ops)
    while t > 0 and ops[t - 1]["op"] in ("filter", "project"):
        t -= 1
    if t > 0 and ops[t - 1]["op"] == "hash_join":
        t -= 1
    return t


def run_pipeline_partition(batch: ColumnBatch, ops: list[dict],
                           key_col: str, partitions: int,
                           backend: str = "numpy",
                           device="cuda") -> list[ColumnBatch]:
    """Execute a pipeline spec and radix-partition its output for a
    shuffle write, returning ``partitions`` contiguous ColumnBatches.

    On the torch backend the trailing ``[hash_join?] +
    (filter|project)*`` run and the partition assignment run as one tail
    on ``device`` (see ``_FusedTail``); the numpy backend is the
    interpreted reference: ``run_pipeline_ops`` +
    ``operators.radix_partition``.

    A trailing ``hash_agg`` partitioned by one of its own group keys —
    the optimizer's partial pre-agg shuffle shape — does not split the
    tail: partitioning by a group key commutes with the per-fragment
    aggregation, so the segment BEFORE the agg runs with the partition
    assignment and the aggregation runs per partition slice. The stable
    partition preserves each group's row order, so the per-slice
    aggregation sees the same values in the same order as aggregating
    first; the pairwise sum tree's association can still shift with a
    group's position in its chunk, so float sums may differ from
    agg-then-partition in the last ulp — well inside the backend's
    rtol=1e-6 contract, but not bit-identical.
    """
    if backend == "numpy":
        return operators.radix_partition(
            operators.run_pipeline_ops(batch, ops), key_col, partitions)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    t = _fusable_tail_start(ops)
    if t == len(ops) and ops and ops[-1]["op"] == "hash_agg" \
            and key_col in ops[-1]["keys"]:
        s = _fusable_tail_start(ops[:-1])
        seg = ops[s:-1]
        if seg:   # something to fuse the assignment into
            agg = ops[-1]
            batch = run_pipeline_torch(batch, ops[:s], device)
            parts = _run_tail(batch, seg, (key_col, partitions), device)
            return [_run_hash_agg(p, agg["keys"], agg["aggs"], device)
                    for p in parts]
    batch = run_pipeline_torch(batch, ops[:t], device)
    if t == len(ops):
        return operators.radix_partition(batch, key_col, partitions)
    return _run_tail(batch, ops[t:], (key_col, partitions), device)


def run_pipeline(batch: ColumnBatch, ops: list[dict],
                 backend: str = "numpy", device="cuda") -> ColumnBatch:
    """Execute a pipeline spec on ``backend`` ("numpy" | "torch"; the
    torch backend runs on ``device``)."""
    if backend == "numpy":
        return operators.run_pipeline_ops(batch, ops)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    return run_pipeline_torch(batch, ops, resolve_device(device))


def run_pipeline_collect(batch: ColumnBatch, ops: list[dict],
                         backend: str = "numpy",
                         device="cuda") -> ColumnBatch:
    """Execute a COLLECT fragment's pipeline spec.

    Same results as ``run_pipeline``, but on the torch backend a trailing
    keyed ``hash_agg`` — the optimizer's collapsed partial+final
    aggregate after a combine-shuffle elision — runs with its preceding
    ``[hash_join?] + (filter|project)*`` segment through the
    ``_FusedTail`` machinery at a single partition: the join probe, the
    fused predicate mask, the derived projections and the live-row
    compaction run as one tail (exactly like the shuffle fragment's
    partition fusion, with r=1), then the aggregation runs over the
    compacted slice. Integer group keys only; other shapes fall through
    to the plain drivers unchanged.
    """
    if backend == "torch" and ops and ops[-1]["op"] == "hash_agg" \
            and ops[-1]["keys"]:
        agg = ops[-1]
        s = _fusable_tail_start(ops[:-1])
        seg = ops[s:-1]
        key0 = agg["keys"][0]
        # Only take the fused path when the partition key is an integer —
        # a float group key would push the WHOLE segment onto the
        # interpreted fallback inside _FusedTail.
        key_is_int = key0 not in batch \
            or np.asarray(batch[key0]).dtype.kind in "iu"
        if seg and key_is_int:
            dev = resolve_device(device)
            head = run_pipeline_torch(batch, ops[:s], dev)
            parts = _run_tail(head, seg, (key0, 1), dev)
            return _run_hash_agg(parts[0], agg["keys"], agg["aggs"], dev)
    return run_pipeline(batch, ops, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Query-level compiled-plan cache
# ---------------------------------------------------------------------------

class CompiledPlanCache:
    """Query-level view of the compiled-stage cache.

    The operative sharing lives in the canonical-keyed lru caches above
    (``_compile_segment`` / ``_compile_tail``): two plans with the same
    ``plans.plan_shape_hash`` hand those caches identical keys, so a
    plan-level hit means every compiled stage the query's fragments will
    look up is already resident (modulo lru eviction). This class keys
    that property by shape hash — an LRU of the shapes seen — and exposes
    the hit/miss counters that serving metrics report.

    Literal values are NOT part of the key (they travel as a separate
    binding); tables are keyed positionally, so a same-shape query over
    different tables also hits. ``maxsize`` bounds remembered shapes.
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, plan) -> tuple[str, bool]:
        """Record a query against the cache. Returns ``(shape_hash,
        hit)``; on a miss the shape is inserted so the next same-shape
        query hits."""
        key = engine_plans.plan_shape_hash(plan)
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return key, True
        self.misses += 1
        self._entries[key] = plan.name
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return key, False

    def contains(self, shape_hash: str) -> bool:
        return shape_hash in self._entries

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries), **TRACE_CACHE_STATS}

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0


# Process-wide instance used by ``Coordinator.execute`` (the stage caches
# it fronts are process-wide too).
PLAN_CACHE = CompiledPlanCache()
