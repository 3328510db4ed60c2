"""Quickstart for the logical query API: author a query declaratively,
inspect what the optimizer does to it, and run it on the serverless
engine in both execution backends.

    PYTHONPATH=src python -m repro_torch.examples.logical_api_quickstart \\
        [--device cuda]

The port's copy of ``examples/logical_api_quickstart.py``. The engine
defaults to the "torch" backend on the card; "numpy" is the interpreted
float64 reference (expect the aggregate results below to agree to ~6
significant digits — the rtol=1e-6 float contract in docs/BACKENDS.md).
docs/ARCHITECTURE.md walks the whole engine.
"""
import argparse

import numpy as np

from repro_torch.core.storage_service import ObjectStore
from repro_torch.engine import Coordinator, col, datagen, explain, scan, sum_


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend (default: cuda)")
    args = ap.parse_args(argv)
    # A revenue-by-shipmode query written against the logical builder:
    # no pipelines, no shuffle wiring, no partial/final aggregate split —
    # the optimizer derives all of that.
    query = (
        scan("lineitem")
        .filter((col("l_shipdate") >= datagen.DATE_1995_01_01)
                & (col("l_quantity") < 30.0))
        .select("l_shipmode",
                (col("l_extendedprice") * (1 - col("l_discount")))
                .alias("disc_price"))
        .group_by("l_shipmode")
        .agg(sum_("disc_price").alias("revenue"))
        .collect("revenue_by_shipmode"))

    # What the planner will do: logical plan, applied rules, pipelines.
    print(explain.explain(query))
    print()

    # Load a small synthetic lineitem table and run the query. The
    # coordinator lowers logical plans itself (Coordinator.run), using
    # the registered tables' object sizes as planner statistics.
    store = ObjectStore()
    keys = datagen.load_table(store, "lineitem", rows=50_000, partitions=8)
    results = {}
    for backend in ("numpy", "torch"):
        coord = Coordinator(store, mode="elastic", backend=backend,
                            device=args.device)
        coord.register_table("lineitem", keys)
        res = coord.run(query, query_id=f"quickstart-{backend}")
        results[backend] = res
        order = np.argsort(res.result["l_shipmode"])
        print(f"[{backend}] runtime={res.runtime_s:.3f}s "
              f"cost=${res.faas_cost_usd + res.storage_cost_usd:.6f}")
        for i in order:
            print(f"  shipmode={int(res.result['l_shipmode'][i])} "
                  f"revenue={float(res.result['revenue'][i]):,.2f}")

    # Shuffle elision: store the table HASH-partitioned and declare the
    # layout on the scan — a query keyed on the partition key then needs
    # no shuffle at all (the combine collapses into the scan fragments;
    # watch for "shuffle_elision: ... ELIDED" in the applied rules and a
    # plan with zero shuffle outputs).
    hkeys = datagen.load_table_hash_partitioned(
        store, "lineitem", rows=50_000, partition_key="l_orderkey",
        fanout=8, prefix="hashed")
    per_order = (
        scan("lineitem", ["l_orderkey", "l_extendedprice", "l_discount"],
             partitioned_by=("l_orderkey", 8))
        .select("l_orderkey",
                (col("l_extendedprice") * (1 - col("l_discount")))
                .alias("disc_price"))
        .group_by("l_orderkey")
        .agg(sum_("disc_price").alias("revenue"))
        .collect("revenue_by_order"))
    print()
    print(explain.explain(per_order))
    coord = Coordinator(store, mode="elastic", device=args.device)
    coord.register_table("lineitem", hkeys)
    res = coord.run(per_order, query_id="quickstart-elided")
    results.update(elided=res, store=store, hashed_keys=hkeys,
                   per_order=per_order)
    print(f"[elided] {res.result.num_rows} orders, "
          f"runtime={res.runtime_s:.3f}s, shuffle objects written: "
          f"{len(store.list('shuffle/quickstart-elided/'))}")
    return results


if __name__ == "__main__":
    main()
