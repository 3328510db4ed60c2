"""Benchmark runner of the port: every paper figure and table benchmark,
the query-level ones on the port's engine, and the engine data-plane
sections, printed as ``name,us_per_call,derived`` CSV with each derived
value held to its ``EXPECT`` band (the reference's bands).

    python -m repro_torch.bench.run

The counterpart of ``benchmarks/run.py``. Its modules are
``paper_figures``, ``paper_queries`` (Table 6 on the ``torch`` backend on
the card), ``engine_bench`` (every section on the card, nothing
written) and ``h100_roofline`` (the dry run's artifacts,
``artifacts/torch/dryrun/``, on the H100's roofline; no rows before
``python -m repro_torch.launch.dryrun`` has run). Exits 1 when a
benchmark raised or a value fell outside its band, after printing every
row.
"""
from __future__ import annotations

import sys


def run(modules) -> list[tuple[str, str]]:
    """Print every module's rows; return the band failures and errors."""
    failures = []
    print("name,us_per_call,derived")
    for mod in modules:
        expect = getattr(mod, "EXPECT", {})
        for fn in mod.ALL:
            try:
                rows = fn()
            except Exception as e:  # noqa: BLE001
                failures.append((fn.__name__, repr(e)))
                print(f"{fn.__name__},ERROR,{e!r}")
                continue
            for name, us, derived in rows:
                print(f"{name},{us:.1f},{derived:.6g}")
                if name in expect:
                    lo, hi = expect[name]
                    if not (lo <= derived <= hi):
                        failures.append((name, f"{derived} not in "
                                               f"[{lo}, {hi}]"))
    return failures


def main(modules=None) -> None:
    if modules is None:
        from repro_torch.bench import engine_bench, h100_roofline, \
            paper_figures, paper_queries
        modules = [paper_figures, paper_queries, engine_bench, h100_roofline]
    failures = run(modules)
    if failures:
        print("\nBOUND FAILURES:", file=sys.stderr)
        for name, msg in failures:
            print(f"  {name}: {msg}", file=sys.stderr)
        raise SystemExit(1)
    print("# all expected bounds satisfied")


if __name__ == "__main__":
    main()
