"""Multi-query serving quickstart: N same-shape queries from two
tenants, interleaved on one shared elastic pool under a fixed worker
budget, vs the same machinery run serially.

Shows the three serving-layer wins in one run:
  * compiled-plan cache — the first query pays the plan's compilation,
    the N-1 same-shape followers (different literals!) skip it;
  * shared-pool interleaving — model-time throughput beats the serial
    baseline at the SAME worker budget;
  * result cache — repeating a byte-identical query replays its merged
    result from the object store with zero pool work, until an input
    table changes (etag bump) and the entry invalidates.

    PYTHONPATH=src python -m \\
        repro_torch.examples.concurrent_serving_quickstart [--device cuda]

The port's copy of ``examples/concurrent_serving_quickstart.py``, on the
port's ``QueryServer`` with the torch backend on the card.
"""
import argparse
import time

from repro_torch.core.storage_service import ObjectStore
from repro_torch.engine import compile as engine_compile
from repro_torch.engine import datagen, queries
from repro_torch.serve.query_server import QueryRequest, QueryServer

N_QUERIES = 8
BUDGET = 16                      # shared worker budget for ALL queries


def make_server(store, tables, device) -> QueryServer:
    srv = QueryServer(store, worker_budget=BUDGET, rng_seed=0,
                      device=device)
    for name, keys in tables.items():
        srv.register_table(name, keys)
    return srv


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend (default: cuda)")
    args = ap.parse_args(argv)
    store = ObjectStore()
    tables = {
        "lineitem": datagen.load_table(store, "lineitem", 60_000, 12),
        "orders": datagen.load_table(store, "orders", 15_000, 6),
    }
    base = datagen.DATE_1994_01_01
    # Same plan SHAPE, different filter literals, two tenants.
    requests = lambda: [  # noqa: E731
        QueryRequest(queries.q12_logical(year_lo=base + 30 * i),
                     tenant=f"tenant{i % 2}")
        for i in range(N_QUERIES)
    ]

    engine_compile.PLAN_CACHE.clear()
    t0 = time.perf_counter()
    serial = make_server(store, tables, args.device).serve(
        requests(), interleave=False)
    serial_wall = time.perf_counter() - t0

    engine_compile.PLAN_CACHE.clear()   # honest first-query miss below
    t0 = time.perf_counter()
    inter = make_server(store, tables, args.device).serve(requests())
    inter_wall = time.perf_counter() - t0

    print(f"{N_QUERIES} same-shape Q12 variants, budget {BUDGET} workers")
    print(f"  serial      : {serial.makespan_s:7.2f}s model "
          f"({serial.throughput_qps:.2f} q/s, wall {serial_wall:.2f}s)")
    print(f"  interleaved : {inter.makespan_s:7.2f}s model "
          f"({inter.throughput_qps:.2f} q/s, wall {inter_wall:.2f}s)")
    speedup = inter.throughput_qps / serial.throughput_qps
    print(f"  speedup     : {speedup:.2f}x at the same budget")
    print(f"  plan cache  : {inter.plan_cache_hits} hits / "
          f"{inter.plan_cache_misses} miss "
          f"(hit rate {inter.plan_cache_hit_rate:.0%})")
    print(f"  latency p50 : {inter.p50_latency_s:.2f}s   "
          f"p99: {inter.p99_latency_s:.2f}s")
    for tenant, counters in sorted(inter.admission.items()):
        print(f"  {tenant}: {counters}")

    # Result cache: a byte-identical repeat is free ...
    srv = make_server(store, tables, args.device)
    srv.serve([QueryRequest(queries.q12_logical(year_lo=base))])
    replay = srv.serve([QueryRequest(queries.q12_logical(year_lo=base))])
    print(f"repeat query: result_cache_hits={replay.result_cache_hits}, "
          f"latency {replay.queries[0].latency_s:.3f}s")
    # ... until an input table changes (etag bump invalidates).
    k = tables["lineitem"][0]
    store.put(k, store.get(k))
    rerun = srv.serve([QueryRequest(queries.q12_logical(year_lo=base))])
    print(f"after table overwrite: result_cache_hits="
          f"{rerun.result_cache_hits} "
          f"(invalidated={srv.result_cache.invalidated})")
    return {"serial": serial, "interleaved": inter, "replay": replay,
            "rerun": rerun, "store": store, "tables": tables}


if __name__ == "__main__":
    main()
