"""Benchmark regression gate for the port's engine benchmarks.

``python -m repro_torch.bench.check_regression`` checks the recorded
speedups in ``BENCH_engine_torch.json`` (written by
``repro_torch.bench.engine_bench``) with the reference's gates:

* every ``*speedup*`` entry must be >= 1.0 — an optimized path that runs
  slower than the path it replaced is a regression, full stop;
* with a baseline (``--baseline FILE``, or the committed copy via
  ``git show HEAD:BENCH_engine_torch.json`` when available), every
  speedup must also stay within ``--tolerance`` (default 0.5, i.e. at
  least half) of the baseline's recorded value — catching slow decay
  that stays above 1.0. Microbenchmark noise across machines is real,
  hence the loose default;
* the ``planning`` section's ``overhead_frac`` (logical->physical
  lowering cost over an end-to-end Q12 run) must stay under
  ``PLANNING_OVERHEAD_MAX`` — the optimizer is supposed to be free
  relative to the queries it plans;
* ``--require-section NAME[,NAME...]`` (repeatable) asserts that each
  named section exists in the current results AND contains at least one
  speedup entry — so a refactor cannot silently drop a benchmark the PR
  acceptance depends on (e.g.
  ``--require-section join_pipeline,partition_fusion``).

Exit code 0 when clean, 1 with a per-metric report otherwise. Use
``--current FILE`` to gate freshly produced results instead of the
checked-in file; pass ``--run`` to execute the benchmarks first (on the
card).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BENCH_NAME = "BENCH_engine_torch.json"
DEFAULT_BENCH = REPO_ROOT / BENCH_NAME
PLANNING_OVERHEAD_MAX = 0.01        # lowering < 1% of Q12 runtime
ADAPTIVE_P99_MIN = 1.3              # adaptive vs static under chaos, p99
# Out-of-core: a spilling run (fixed per-worker cap, multiple spill
# rounds, spilled join build) must stay within this slowdown of the
# unbudgeted in-memory run at EQUAL row counts — spill trades bounded
# memory for bandwidth, not for an order of magnitude of runtime.
SPILL_OVERHEAD_MAX = 4.0
# Worker-failure fault domain: lineage recovery (re-run exactly the dead
# attempt under attempt-scoped commits) vs the stage-rerun-only static
# baseline under the same seeded crash/OOM/invoke-fail schedule. The
# sweep measures ~1.5x at the p99 (one killed fragment holds the whole
# exchange barrier, and the static leg pays a full stage per kill); the
# floor leaves margin for schedule drift when fault constants move.
FAULT_RECOVERY_P99_MIN = 1.25


def collect_speedups(obj, prefix="") -> dict[str, float]:
    """All numeric values under keys containing 'speedup', flattened."""
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, (int, float)) and "speedup" in str(k):
                out[path] = float(v)
            else:
                out.update(collect_speedups(v, path))
    return out


def load_committed_baseline() -> dict | None:
    try:
        text = subprocess.run(
            ["git", "show", f"HEAD:{BENCH_NAME}"], cwd=REPO_ROOT,
            capture_output=True, text=True, timeout=30, check=True).stdout
        return json.loads(text)
    except Exception:
        return None


def check_required_sections(current: dict,
                            required: list[str]) -> list[str]:
    """Each required section must exist and record >= 1 speedup entry."""
    failures = []
    for name in required:
        section = current.get(name)
        if not isinstance(section, dict):
            failures.append(f"required section {name!r} is missing from "
                            "the results")
        elif not collect_speedups(section):
            failures.append(f"required section {name!r} records no "
                            "speedup entry")
    return failures


def check(current: dict, baseline: dict | None, tolerance: float,
          required_sections: list[str] | None = None) -> list[str]:
    failures = check_required_sections(current, required_sections or [])
    speedups = collect_speedups(current)
    if not speedups:
        return failures + ["no speedup entries found in current results"]
    base_speedups = collect_speedups(baseline) if baseline else {}
    for name, value in sorted(speedups.items()):
        if value < 1.0:
            failures.append(
                f"{name}: {value:.3f}x < 1.0 — the optimized path lost "
                "to the path it replaced")
            continue
        base = base_speedups.get(name)
        if base is not None and base > 0 and value < tolerance * base:
            failures.append(
                f"{name}: {value:.3f}x dropped below {tolerance:.0%} of "
                f"the committed baseline ({base:.3f}x)")
    planning = current.get("planning", {})
    frac = planning.get("overhead_frac")
    # Exclusive bound, matching engine_bench.EXPECT's inclusive ceiling.
    if frac is not None and frac > PLANNING_OVERHEAD_MAX:
        failures.append(
            f"planning.overhead_frac: {frac:.4f} > "
            f"{PLANNING_OVERHEAD_MAX} — logical->physical lowering costs "
            "more than 1% of a Q12 run")
    serving = current.get("concurrent_serving", {})
    rate = serving.get("plan_cache_hit_rate")
    n = serving.get("n_queries")
    if rate is not None and n:
        # N same-shape queries on a fresh cache: the first misses, every
        # follower must hit — anything below (N-1)/N means shape-
        # compatible queries stopped sharing compiled traces.
        floor = (n - 1) / n
        if rate < floor:
            failures.append(
                f"concurrent_serving.plan_cache_hit_rate: {rate:.3f} < "
                f"{floor:.3f} — same-shape queries are missing the "
                "compiled-plan cache")
    ooc = current.get("out_of_core", {})
    for key, slow in sorted(ooc.items()):
        if not key.endswith("spill_slowdown"):
            continue
        if slow > SPILL_OVERHEAD_MAX:
            failures.append(
                f"out_of_core.{key}: {slow:.3f}x > {SPILL_OVERHEAD_MAX}x "
                "— spilling under the fixed per-worker cap costs more "
                "than the bounded overhead budget vs the in-memory run")
    chaos = current.get("adaptive_chaos", {})
    p99 = chaos.get("p99_speedup")
    if p99 is not None and p99 < ADAPTIVE_P99_MIN:
        # The paper's tail argument: one straggling or lost-write
        # fragment holds the whole exchange barrier, so adaptivity is
        # judged at the p99 of modeled runtime, not the mean.
        failures.append(
            f"adaptive_chaos.p99_speedup: {p99:.3f}x < "
            f"{ADAPTIVE_P99_MIN}x — adaptive execution stopped beating "
            "the static coordinator at the tail under injected chaos")
    fault = current.get("fault_recovery", {})
    fp99 = fault.get("p99_speedup")
    if fp99 is not None and fp99 < FAULT_RECOVERY_P99_MIN:
        failures.append(
            f"fault_recovery.p99_speedup: {fp99:.3f}x < "
            f"{FAULT_RECOVERY_P99_MIN}x — lineage recovery stopped "
            "beating whole-stage re-runs at the tail under injected "
            "worker failures")
    if fault and fault.get("kills", 0) + fault.get("ooms", 0) + \
            fault.get("invoke_fails", 0) == 0:
        failures.append(
            "fault_recovery: the chaos sweep injected no faults — the "
            "comparison gates nothing")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--current", type=pathlib.Path, default=DEFAULT_BENCH,
                    help=f"results file to gate (default: {BENCH_NAME})")
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="baseline file (default: committed "
                         f"{BENCH_NAME} via git, if available)")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="minimum fraction of the baseline speedup "
                         "(default 0.5)")
    ap.add_argument("--run", action="store_true",
                    help="run repro_torch.bench.engine_bench first")
    ap.add_argument("--require-section", action="append", default=[],
                    metavar="NAME[,NAME...]",
                    help="fail unless each named result section exists "
                         "and records a speedup (repeatable, "
                         "comma-separable)")
    args = ap.parse_args(argv)
    required = [s for arg in args.require_section
                for s in arg.split(",") if s]

    if args.run:
        from repro_torch.bench import engine_bench
        engine_bench.main(["--out", str(args.current)])

    current = json.loads(args.current.read_text())
    if args.baseline is not None:
        baseline = json.loads(args.baseline.read_text())
    else:
        baseline = load_committed_baseline()

    failures = check(current, baseline, args.tolerance,
                     required_sections=required)
    speedups = collect_speedups(current)
    for name, value in sorted(speedups.items()):
        print(f"  {name}: {value:.3f}x")
    frac = current.get("planning", {}).get("overhead_frac")
    if frac is not None:
        print(f"  planning.overhead_frac: {frac:.5f} "
              f"(max {PLANNING_OVERHEAD_MAX})")
    rate = current.get("concurrent_serving", {}).get("plan_cache_hit_rate")
    if rate is not None:
        print(f"  concurrent_serving.plan_cache_hit_rate: {rate:.3f}")
    p99 = current.get("adaptive_chaos", {}).get("p99_speedup")
    if p99 is not None:
        print(f"  adaptive_chaos.p99_speedup: {p99:.3f}x "
              f"(min {ADAPTIVE_P99_MIN}x)")
    fp99 = current.get("fault_recovery", {}).get("p99_speedup")
    if fp99 is not None:
        print(f"  fault_recovery.p99_speedup: {fp99:.3f}x "
              f"(min {FAULT_RECOVERY_P99_MIN}x)")
    for key, slow in sorted(current.get("out_of_core", {}).items()):
        if key.endswith("spill_slowdown"):
            print(f"  out_of_core.{key}: {slow:.3f}x "
                  f"(max {SPILL_OVERHEAD_MAX}x)")
    if failures:
        print("\nREGRESSIONS:")
        for f in failures:
            print(f"  FAIL {f}")
        return 1
    print(f"\nok: {len(speedups)} speedup metrics >= 1.0"
          + (" and within tolerance of baseline" if baseline else
             " (no baseline available)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
