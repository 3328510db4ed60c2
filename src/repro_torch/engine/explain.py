"""Query explainer: logical plan -> applied rules -> physical pipelines.

    PYTHONPATH=src python -m repro_torch.engine.explain tpch_q12

prints the declarative plan a query was authored as, every optimizer
rule that fired while lowering it (predicate pushdown, projection
pruning, aggregate splitting, build-side and shuffle fan-out choices),
and the physical pipelines both execution backends run. ``explain()`` is
the library entry point for the same rendering.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.engine import logical as logical_mod
from repro_torch.engine import optimizer
from repro_torch.engine.logical import LogicalQuery
from repro_torch.engine.plans import (CollectOutput, Pipeline, QueryPlan,
                                ShuffleOutput, TableInput)


def _fmt_output(out) -> str:
    if isinstance(out, ShuffleOutput):
        return (f"shuffle(by={out.partition_by}, "
                f"partitions={out.partitions}, tier={out.tier})")
    if isinstance(out, CollectOutput):
        return "collect"
    return repr(out)


def _fmt_input(inp) -> str:
    if isinstance(inp, TableInput):
        return f"table {inp.table} {inp.columns}"
    return f"shuffle from {inp.from_pipeline}"


def _fmt_op(op: dict) -> str:
    kind = op["op"]
    if kind == "filter":
        return f"filter {op['expr']!r}"
    if kind == "project":
        return f"project {op['columns']!r}"
    if kind == "hash_agg":
        return f"hash_agg keys={op['keys']} aggs={op['aggs']}"
    if kind == "hash_join":
        return (f"hash_join probe.{op['left_key']} = "
                f"build.{op['right_key']}")
    if kind == "udf":
        return f"udf {op['name']} kwargs={op.get('kwargs', {})}"
    return repr(op)


def format_pipeline(pipe: Pipeline) -> str:
    lines = [f"{pipe.name}: {_fmt_input(pipe.input)} "
             f"-> {_fmt_output(pipe.output)}"]
    if pipe.partitioning is not None:
        lines.append(f"  input partitioning: "
                     f"hash({pipe.partitioning['key']}) % "
                     f"{pipe.partitioning['fanout']} "
                     f"(relied on: shuffle elided)")
    if pipe.input2 is not None:
        lines.append(f"  build side: {_fmt_input(pipe.input2)}")
    for op in pipe.ops:
        lines.append(f"  {_fmt_op(op)}")
    return "\n".join(lines)


def format_physical(plan: QueryPlan) -> str:
    return "\n".join(format_pipeline(p) for p in plan.pipelines)


def format_adaptive(result) -> str:
    """Render a ``QueryResult``'s adaptive-execution section: the
    ``adaptive:`` decision lines recorded at stage boundaries by
    ``engine.adaptive``, the revision/speculation counters, and per-stage
    timings. Under the static coordinator the section shows zero
    revisions — the before/after transcript in docs/ARCHITECTURE.md is
    exactly this rendering."""
    lines = ["adaptive execution", "=================="]
    lines += [f"- {ln}" for ln in result.adaptive_trace] \
        or ["- (no revisions)"]
    lines.append(f"counters: replans={result.replans} "
                 f"speculative_launched={result.speculative_launched} "
                 f"speculative_won={result.speculative_won}")
    failure = getattr(result, "failure", None)
    if failure is not None:
        lines.append(
            f"FAILED: [{failure['kind']}] stage {failure['stage']!r} "
            f"after {failure['attempts']} attempt(s) — "
            f"{failure['message']}")
    lines.append("stage timings")
    for name, m in result.stage_metrics.items():
        lines.append(f"  {name}: start={m['start']:.3f}s "
                     f"end={m['end']:.3f}s "
                     f"duration={m['duration']:.3f}s "
                     f"workers={m['workers']} "
                     f"speculative={m.get('speculative', 0)}")
    return "\n".join(lines)


def explain(query: LogicalQuery, stats: Optional[optimizer.Stats] = None,
            backend: str = "torch", result=None,
            memory_budget: Optional[float] = None) -> str:
    from repro_torch.engine import compile as engine_compile
    from repro_torch.engine import plans as plans_mod

    plan, report = optimizer.lower(query, stats=stats, backend=backend,
                                   memory_budget=memory_budget)
    shape_hash = plans_mod.plan_shape_hash(plan)
    cache_state = "hit" if engine_compile.PLAN_CACHE.contains(shape_hash) \
        else "miss"
    sections = [
        f"query: {query.name} (backend={backend})",
        f"plan shape: {shape_hash[:16]} "
        f"(compiled-plan cache: {cache_state})",
        "",
        "logical plan",
        "============",
        logical_mod.format_node(report.logical_root),
        "",
        "applied rules",
        "=============",
    ]
    sections += [f"- {r}" for r in report.rules] or ["- (none)"]
    sections += ["", "physical plan", "=============",
                 format_physical(plan)]
    if result is not None:
        # Post-execution view: what the adaptive executor actually did
        # to this plan at run time (pass the returned QueryResult).
        sections += ["", format_adaptive(result)]
    return "\n".join(sections)


def main(argv=None) -> int:
    from repro_torch.engine import queries

    ap = argparse.ArgumentParser(
        description="Show a query's logical plan, the optimizer rules "
                    "applied, and the lowered physical pipelines.")
    ap.add_argument("query", nargs="?", default="tpch_q12",
                    help="query name (e.g. tpch_q1, tpch_q6, tpch_q12, "
                         "tpcxbb_q3)")
    ap.add_argument("--backend", default="torch",
                    choices=["numpy", "torch"],
                    help="backend whose measured throughput drives "
                         "fan-out choices (torch is the engine default; "
                         "numpy is the interpreted reference)")
    ap.add_argument("--memory-budget", type=float, default=None,
                    metavar="MIB",
                    help="per-worker memory cap in MiB; adds the memory "
                         "pressure term to shuffle fan-out derivation "
                         "and traces it under 'applied rules'")
    ap.add_argument("--table-mib", action="append", default=[],
                    metavar="TABLE=MIB",
                    help="planner statistic: table size in MiB "
                         "(repeatable); without stats fan-out falls back "
                         "to the default and the memory term is moot")
    ap.add_argument("--list", action="store_true",
                    help="list available queries")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(queries.LOGICAL_BUILDERS):
            print(name)
        return 0
    builder = queries.LOGICAL_BUILDERS.get(args.query)
    if builder is None:
        print(f"unknown query {args.query!r}; available: "
              f"{sorted(queries.LOGICAL_BUILDERS)}", file=sys.stderr)
        return 2
    budget = None if args.memory_budget is None \
        else args.memory_budget * 1024 * 1024
    stats = None
    if args.table_mib:
        table_bytes = {}
        for spec in args.table_mib:
            table, _, mib = spec.partition("=")
            table_bytes[table] = float(mib) * 1024 * 1024
        stats = optimizer.Stats(table_bytes)
    print(explain(builder(), stats=stats, backend=args.backend,
                  memory_budget=budget))
    return 0


if __name__ == "__main__":
    sys.exit(main())
