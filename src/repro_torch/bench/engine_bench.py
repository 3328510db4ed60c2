"""Engine data-plane and control-plane benchmarks of the port: the
sections of the reference's ``benchmarks/engine_bench.py``, at its sizes
and repeats, with the ``torch`` backend on a device (the card unless
``--device cpu``) in place of the reference's ``jit``.

    python -m repro_torch.bench.engine_bench [--section NAME[,NAME...]]
                                             [--device cuda] [--out FILE]

* serde, shuffle — the frame codec and the radix partitioner (host code,
                  no backend);
* pipeline, join_pipeline, dup_key_join, partition_fusion — one fragment
                  shape each, the interpreted ``numpy`` backend against
                  ``torch`` on the device in the same process (min-of-N,
                  alternating). Each also records the device's
                  host<->device copy time of one ``torch`` run on its own
                  (``copy_s``, from ``torch.profiler``);
* planning      — logical->physical lowering against a Q12 run;
* shuffle_elision, concurrent_serving, tiered_exchange, adaptive_chaos,
  fault_recovery — end-to-end comparisons in the coordinator's model
                  time, on the ``torch`` backend;
* out_of_core   — the join and agg fragments at 10x rows, in memory,
                  accounted and under a spill cap, on ``torch``.

Every timed window waits for the device before it closes. The results go
to ``BENCH_engine_torch.json`` at the repository root (``--out`` to write
elsewhere), which ``core.bench_profile`` reads for the ``torch``
backend's planner throughput (``pipeline.batch_mib`` over
``pipeline.torch_s``); a ``device`` entry names the device and, on a
card, ``nvidia-smi``'s name and power limit. ``--section`` runs only the
named sections and merges them into the existing file.
``repro_torch.bench.check_regression`` gates the file.
``engine_data_plane`` (with ``EXPECT``, the reference's bands) is
``repro_torch.bench.run``'s hook: every section, nothing written, as
the reference's rows.
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from repro_torch.engine import columnar, compile as engine_compile, operators
from repro_torch.engine import optimizer, queries
from repro_torch.engine.columnar import ColumnBatch
from repro_torch.engine.worker import radix_partition

MIB = 1024.0 ** 2
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO_ROOT / "BENCH_engine_torch.json"

SERDE_ROWS = 500_000
SHUFFLE_ROWS = 500_000
SHUFFLE_PARTITIONS = 32
PIPELINE_ROWS = 2_000_000
JOIN_PROBE_ROWS = 1_000_000
JOIN_BUILD_ROWS = 250_000
JOIN_PARTITIONS = 32
REPEATS = 9


def _lineitem(rows: int, seed: int = 0) -> ColumnBatch:
    r = np.random.default_rng(seed)
    return ColumnBatch({
        "l_orderkey": r.integers(1, rows // 4, size=rows, dtype=np.int64),
        "l_quantity": r.integers(1, 51, size=rows).astype(np.float64),
        "l_extendedprice": np.round(r.uniform(900.0, 105000.0, rows), 2),
        "l_discount": np.round(r.integers(0, 11, size=rows) * 0.01, 2),
        "l_tax": np.round(r.integers(0, 9, size=rows) * 0.01, 2),
        "l_returnflag": r.integers(0, 3, size=rows, dtype=np.int8),
        "l_linestatus": r.integers(0, 2, size=rows, dtype=np.int8),
        "l_shipdate": r.integers(0, 2555, size=rows, dtype=np.int32),
    })


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _timed(fn, device) -> float:
    """Wall time of ``fn``; on a card the window opens and closes with
    the device idle, so it holds all of ``fn``'s device work."""
    sync = torch.cuda.synchronize if _on_card(device) else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def _best(fn, device, repeats: int = REPEATS) -> float:
    """Min-of-N wall time (the usual microbenchmark noise floor)."""
    gc.collect()
    return min(_timed(fn, device) for _ in range(repeats))


def _best_pair(fn_a, fn_b, device,
               repeats: int = REPEATS) -> tuple[float, float]:
    """Min-of-N for two competitors, alternating A/B each round so VM
    noise phases (frequency scaling, neighbors) hit both sides equally."""
    gc.collect()
    best_a = best_b = float("inf")
    for _ in range(repeats):
        best_a = min(best_a, _timed(fn_a, device))
        best_b = min(best_b, _timed(fn_b, device))
    return best_a, best_b


def _copy_s(fn, device) -> float:
    """Device time of the host<->device copies of one run of ``fn``
    (``torch.profiler``); 0 when the backend runs on the host."""
    if not _on_card(device):
        return 0.0
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and "Memcpy" in evt.key) / 1e6


def _vs_numpy(out: dict, rows: int, run, device) -> dict:
    """The numpy-vs-torch fields of a data-plane section: min-of-N of
    ``run("numpy")`` and ``run("torch")`` alternating, and the copy time
    of one torch run."""
    numpy_s, torch_s = _best_pair(lambda: run("numpy"),
                                  lambda: run("torch"), device)
    copy_s = _copy_s(lambda: run("torch"), device)
    out.update({
        "numpy_s": numpy_s, "torch_s": torch_s,
        "numpy_mrows_s": rows / numpy_s / 1e6,
        "torch_mrows_s": rows / torch_s / 1e6,
        "copy_s": copy_s, "copy_share": copy_s / torch_s,
        "speedup": numpy_s / torch_s,
    })
    return out


# ---------------------------------------------------------------------------
# 1) serialize / deserialize throughput
# ---------------------------------------------------------------------------

def bench_serde(device: str = "cuda") -> dict:
    batch = _lineitem(SERDE_ROWS)
    mb = batch.nbytes() / MIB
    npz = columnar.serialize(batch)
    frame = columnar.serialize_frame(batch)
    out = {
        "batch_mib": mb,
        "npz_ser_mib_s": mb / _best(lambda: columnar.serialize(batch),
                                    device),
        "frame_ser_mib_s": mb / _best(
            lambda: columnar.serialize_frame(batch), device),
        "npz_deser_mib_s": mb / _best(lambda: columnar.deserialize(npz),
                                      device),
        "frame_deser_mib_s": mb / _best(
            lambda: columnar.deserialize(frame), device),
        "npz_bytes": len(npz),
        "frame_bytes": len(frame),
    }
    out["ser_speedup"] = out["frame_ser_mib_s"] / out["npz_ser_mib_s"]
    out["deser_speedup"] = out["frame_deser_mib_s"] / out["npz_deser_mib_s"]
    return out


# ---------------------------------------------------------------------------
# 2) shuffle partitioning: seed per-partition rescan+npz vs radix+frames
# ---------------------------------------------------------------------------

def _shuffle_seed(batch: ColumnBatch, r: int) -> list[bytes]:
    """The seed engine's writer loop: one full-batch scan per partition,
    npz-compressed objects."""
    assign = np.asarray(batch["l_orderkey"]).astype(np.int64) % r
    return [columnar.serialize(batch.select(assign == p)) for p in range(r)]


def _shuffle_radix(batch: ColumnBatch, r: int) -> list[bytes]:
    return [columnar.serialize_frame(p)
            for p in radix_partition(batch, "l_orderkey", r)
            if p.num_rows]


def bench_shuffle(device: str = "cuda") -> dict:
    batch = _lineitem(SHUFFLE_ROWS, seed=1)
    r = SHUFFLE_PARTITIONS
    seed_s = _best(lambda: _shuffle_seed(batch, r), device)
    radix_s = _best(lambda: _shuffle_radix(batch, r), device)
    mb = batch.nbytes() / MIB
    return {
        "rows": batch.num_rows, "partitions": r, "batch_mib": mb,
        "seed_s": seed_s, "radix_s": radix_s,
        "seed_mib_s": mb / seed_s, "radix_mib_s": mb / radix_s,
        "speedup": seed_s / radix_s,
    }


# ---------------------------------------------------------------------------
# 3) torch on the device vs interpreted (numpy) operator pipeline
# ---------------------------------------------------------------------------

# A Q1/Q6/Q12-blend: selective multi-predicate filter (range + set
# membership), derived-column projection, grouped aggregation — the agg
# profile mirrors Q1's (sums + count).
_PIPELINE_OPS = [
    {"op": "filter", "expr": ["and",
                              ["ge", "l_shipdate", 731],
                              ["lt", "l_shipdate", 731 + 365],
                              ["between", "l_discount", 0.05, 0.07],
                              ["in", "l_returnflag", [0, 2]],
                              ["lt", "l_quantity", 24.0]]},
    {"op": "project", "columns": [
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount",
        ["disc_price", ["mul", "l_extendedprice", ["sub1", "l_discount"]]],
        ["charge", ["mul", ["mul", "l_extendedprice", ["sub1", "l_discount"]],
                    ["add1", "l_tax"]]]]},
    {"op": "hash_agg", "keys": ["l_returnflag", "l_linestatus"],
     "aggs": [["sum_qty", "sum", "l_quantity"],
              ["sum_base_price", "sum", "l_extendedprice"],
              ["sum_disc_price", "sum", "disc_price"],
              ["sum_charge", "sum", "charge"],
              ["sum_disc", "sum", "l_discount"],
              ["count_order", "count", "l_quantity"]]},
]


def bench_pipeline(device: str = "cuda") -> dict:
    batch = _lineitem(PIPELINE_ROWS, seed=2)

    def run(backend):
        return engine_compile.run_pipeline(batch, _PIPELINE_OPS,
                                           backend=backend, device=device)

    run("torch")    # warm both paths (the kernels build on first use)
    run("numpy")
    return _vs_numpy({"rows": batch.num_rows,
                      "batch_mib": batch.nbytes() / MIB},
                     batch.num_rows, run, device)


# ---------------------------------------------------------------------------
# 4) Q12-style join fragment: interpreted join + ops + radix partition vs
#    the compiled backend's fused join -> ops -> partition tail
# ---------------------------------------------------------------------------

# The Q12 join fragment's shape: probe the lineitem shuffle slice against
# the orders build side (referential keys: every probe row matches, as in
# TPC-H), derive the priority flags with case_in, and radix-partition the
# join output by orderkey for the next shuffle.
URGENT, HIGH, MAIL, SHIP = 0, 1, 2, 5


def _join_fragment(rows: int, build_rows: int, seed: int = 3):
    r = np.random.default_rng(seed)
    probe = ColumnBatch({
        "l_orderkey": r.integers(1, build_rows + 1, size=rows,
                                 dtype=np.int64),
        "l_shipmode": r.integers(0, 7, size=rows, dtype=np.int8),
    })
    build = ColumnBatch({
        "o_orderkey": r.permutation(np.arange(1, build_rows + 1)
                                    ).astype(np.int64),
        "o_orderpriority": r.integers(0, 5, size=build_rows,
                                      dtype=np.int8),
    })
    ops = [
        {"op": "hash_join", "left_key": "l_orderkey",
         "right_key": "o_orderkey", "build": build},
        {"op": "filter", "expr": ["in", "l_shipmode", [MAIL, SHIP]]},
        {"op": "project", "columns": [
            "l_orderkey", "l_shipmode",
            ["high_line", ["case_in", "o_orderpriority", [URGENT, HIGH]]],
            ["low_line", ["sub1", ["case_in", "o_orderpriority",
                                   [URGENT, HIGH]]]]]},
    ]
    return probe, build, ops


def bench_join_pipeline(device: str = "cuda") -> dict:
    probe, build, ops = _join_fragment(JOIN_PROBE_ROWS, JOIN_BUILD_ROWS)
    r = JOIN_PARTITIONS

    def run(backend):
        return engine_compile.run_pipeline_partition(
            probe, ops, "l_orderkey", r, backend=backend, device=device)

    parts_np = run("numpy")     # warm both paths (kernels build on first use)
    parts_torch = run("torch")
    rows_out = sum(p.num_rows for p in parts_np)
    assert rows_out == sum(p.num_rows for p in parts_torch)
    mb = (probe.nbytes() + build.nbytes()) / MIB
    return _vs_numpy({
        "probe_rows": probe.num_rows, "build_rows": build.num_rows,
        "rows_out": rows_out, "partitions": r, "batch_mib": mb},
        probe.num_rows, run, device)


# ---------------------------------------------------------------------------
# 5) duplicate-key join: interpreted expansion vs compiled counts/prefix
#    range probe + in-trace expansion
# ---------------------------------------------------------------------------

DUP_PROBE_ROWS = 1_000_000
DUP_BUILD_UNIQUE = 150_000
DUP_SKEW = 4            # key k appears 1 + (k % DUP_SKEW) times


def _dup_join_fragment(rows: int, uniq: int, seed: int = 4):
    r = np.random.default_rng(seed)
    keys = np.arange(1, uniq + 1, dtype=np.int64)
    bk = np.repeat(keys, 1 + (keys % DUP_SKEW))
    perm = r.permutation(len(bk))
    build = ColumnBatch({
        "o_orderkey": bk[perm],
        "o_orderpriority": r.integers(0, 5, len(bk)).astype(np.int8)[perm],
    })
    probe = ColumnBatch({
        "l_orderkey": r.integers(1, uniq + 1, size=rows, dtype=np.int64),
        "l_shipmode": r.integers(0, 7, size=rows, dtype=np.int8),
    })
    ops = [
        {"op": "hash_join", "left_key": "l_orderkey",
         "right_key": "o_orderkey", "build": build},
        {"op": "filter", "expr": ["in", "l_shipmode", [MAIL, SHIP]]},
        {"op": "project", "columns": [
            "l_orderkey", "l_shipmode",
            ["high_line", ["case_in", "o_orderpriority", [URGENT, HIGH]]]]},
    ]
    return probe, build, ops


def bench_dup_key_join(device: str = "cuda") -> dict:
    probe, build, ops = _dup_join_fragment(DUP_PROBE_ROWS, DUP_BUILD_UNIQUE)
    r = JOIN_PARTITIONS

    def run(backend):
        return engine_compile.run_pipeline_partition(
            probe, ops, "l_orderkey", r, backend=backend, device=device)

    parts_np = run("numpy")     # warm both paths (kernels build on first use)
    parts_torch = run("torch")
    rows_out = sum(p.num_rows for p in parts_np)
    assert rows_out == sum(p.num_rows for p in parts_torch)
    assert rows_out > probe.num_rows * 0.2   # dups actually expanded
    return _vs_numpy({
        "probe_rows": probe.num_rows, "build_rows": build.num_rows,
        "build_unique_keys": DUP_BUILD_UNIQUE, "rows_out": rows_out,
        "partitions": r}, probe.num_rows, run, device)


# ---------------------------------------------------------------------------
# 6) mid-plan partition fusion: partial pre-agg shuffle fragment
# ---------------------------------------------------------------------------

FUSION_ROWS = 2_000_000
FUSION_PARTITIONS = 8

# The optimizer's agg-split shape: the scan pipeline filters, projects,
# partially aggregates, and shuffles by a group key. On the torch backend
# the segment + partition assignment trace as one call and the agg runs
# per partition slice; the numpy reference aggregates first and radix-
# partitions the agg output.
_FUSION_OPS = [
    {"op": "filter", "expr": ["and",
                              ["ge", "l_shipdate", 366],
                              ["lt", "l_shipdate", 366 + 3 * 365]]},
    {"op": "project", "columns": [
        "l_returnflag", "l_linestatus", "l_quantity",
        ["disc_price", ["mul", "l_extendedprice", ["sub1", "l_discount"]]]]},
    {"op": "hash_agg", "keys": ["l_returnflag", "l_linestatus"],
     "aggs": [["sum_qty", "sum", "l_quantity"],
              ["sum_disc_price", "sum", "disc_price"],
              ["count_order", "count", "l_quantity"]]},
]


def bench_partition_fusion(device: str = "cuda") -> dict:
    batch = _lineitem(FUSION_ROWS, seed=5)
    r = FUSION_PARTITIONS

    def run(backend):
        return engine_compile.run_pipeline_partition(
            batch, _FUSION_OPS, "l_returnflag", r, backend=backend,
            device=device)

    parts_np = run("numpy")     # warm both paths
    parts_torch = run("torch")
    assert sum(p.num_rows for p in parts_np) == \
        sum(p.num_rows for p in parts_torch) > 0
    return _vs_numpy({"rows": batch.num_rows, "partitions": r,
                      "batch_mib": batch.nbytes() / MIB},
                     batch.num_rows, run, device)


# ---------------------------------------------------------------------------
# 7) planning: logical -> physical lowering overhead per paper query
# ---------------------------------------------------------------------------

PLANNING_Q12_ROWS = 60_000
PLANNING_Q12_PARTS = 12


def _q12_runtime_s(device) -> float:
    """Best-of-3 warmed wall time of an end-to-end Q12 run on a small
    in-memory store — the denominator of the planning-overhead fraction.
    Warmed + min-of-N so the gated ratio is stable run to run (and uses
    the FASTEST runtime, the conservative denominator for the < 1%
    check)."""
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.engine import datagen
    from repro_torch.engine.coordinator import Coordinator

    store = ObjectStore()
    coord = Coordinator(store, mode="elastic", backend="torch",
                        device=device)
    coord.register_table("lineitem", datagen.load_table(
        store, "lineitem", PLANNING_Q12_ROWS, PLANNING_Q12_PARTS))
    coord.register_table("orders", datagen.load_table(
        store, "orders", PLANNING_Q12_ROWS // 4, PLANNING_Q12_PARTS // 2))
    plan = queries.q12_plan()   # lowering happens OUTSIDE the timed region
    coord.execute(plan, query_id="bench-planning-q12-warm")
    return _best(lambda: coord.execute(plan, query_id="bench-planning-q12"),
                 device, repeats=3)


def bench_planning(device: str = "cuda") -> dict:
    builders = {
        "q1": queries.q1_logical,
        "q6": queries.q6_logical,
        "q12": queries.q12_logical,
        "bb_q3": lambda: queries.bb_q3_logical("tables/item/part-00000"),
    }
    out: dict = {}
    for name, build in builders.items():
        out[f"{name}_lower_s"] = _best(lambda b=build: optimizer.plan(b()),
                                       device)
    q12_runtime = _q12_runtime_s(device)
    out["q12_runtime_s"] = q12_runtime
    out["overhead_frac"] = out["q12_lower_s"] / q12_runtime
    return out


# ---------------------------------------------------------------------------
# 8) shuffle elision: elided vs unelided end-to-end agg-after-join
# ---------------------------------------------------------------------------

ELISION_ROWS = 1_200_000
ELISION_ORDERS = 300_000
ELISION_PARTITIONS = 16


def _elision_query(n: int):
    from repro_torch.engine.logical import col, count_, max_, scan, sum_

    return (
        scan("lineitem", ["l_orderkey", "l_quantity", "l_extendedprice",
                          "l_discount"],
             partitioned_by=("l_orderkey", n))
        .join(scan("orders", ["o_orderkey", "o_totalprice"],
                   partitioned_by=("o_orderkey", n)),
              on=("l_orderkey", "o_orderkey"))
        .select("l_orderkey", "l_quantity",
                (col("l_extendedprice") * (1 - col("l_discount")))
                .alias("revenue"),
                "o_totalprice")
        .group_by("l_orderkey")
        .agg(sum_("revenue").alias("revenue"),
             sum_("l_quantity").alias("qty"),
             count_("revenue").alias("n_lines"),
             max_("o_totalprice").alias("o_total"))
        .collect("elision_bench", shuffle_partitions=n))


def bench_shuffle_elision(device: str = "cuda") -> dict:
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.engine import datagen
    from repro_torch.engine.coordinator import Coordinator

    n = ELISION_PARTITIONS
    store = ObjectStore()
    tables = {
        "lineitem": datagen.load_table_hash_partitioned(
            store, "lineitem", ELISION_ROWS, "l_orderkey", n),
        "orders": datagen.load_table_hash_partitioned(
            store, "orders", ELISION_ORDERS, "o_orderkey", n),
    }
    q = _elision_query(n)
    out: dict = {"rows": ELISION_ROWS, "orders_rows": ELISION_ORDERS,
                 "partitions": n}
    results = {}
    for tag, elide in (("elided", True), ("unelided", False)):
        # A fresh coordinator (same seed) per variant: both plans see the
        # identical cold-start/straggler noise sequence, so the modeled
        # runtime — and therefore the gated speedup — is deterministic.
        coord = Coordinator(store, mode="elastic", backend="torch",
                            device=device, rng_seed=0)
        for t, keys in tables.items():
            coord.register_table(t, keys)
        stats = optimizer.Stats.from_store(store, coord.table_keys)
        # Pin both variants to object-tier shuffles: this section gates
        # SHUFFLE ELISION, and under auto placement the break-even rule
        # would route the unelided combine onto the KV tier and eat the
        # very gap being measured (tiered_exchange gates that win).
        plan = optimizer.plan(q, stats=stats, backend="torch",
                              shuffle_elision=elide,
                              exchange_tiers="object")
        qid = f"bench-elision-{tag}"
        # First run: fresh (cold) pool — the deterministic modeled e2e
        # runtime a one-shot serverless query sees. Wall time is
        # best-of-3 after the first run has built the kernels.
        res = coord.execute(plan, f"{qid}-cold")
        wall = min(_timed(lambda i=i: coord.execute(plan, f"{qid}-{i}"),
                          device) for i in range(3))
        results[tag] = res
        out[f"{tag}_pipelines"] = len(plan.pipelines)
        out[f"{tag}_model_runtime_s"] = res.runtime_s
        out[f"{tag}_wall_s"] = wall
        out[f"{tag}_cost_usd"] = res.faas_cost_usd + res.storage_cost_usd
        out[f"{tag}_shuffle_objects"] = len(
            store.list(f"shuffle/{qid}-cold/"))
        out[f"{tag}_storage_writes"] = results[tag].request_stats.writes
    assert results["elided"].result.num_rows == \
        results["unelided"].result.num_rows > 0
    assert out["elided_shuffle_objects"] == 0    # every shuffle elided
    out["speedup"] = out["unelided_model_runtime_s"] / \
        out["elided_model_runtime_s"]
    out["cost_ratio"] = out["unelided_cost_usd"] / out["elided_cost_usd"]
    return out


# ---------------------------------------------------------------------------
# 9) multi-query serving: interleaved shared-pool execution + compiled-plan
#    cache vs serial execution of the same query stream
# ---------------------------------------------------------------------------

SERVING_N_QUERIES = 8
SERVING_BUDGET = 16          # fixed shared worker budget
SERVING_ROWS = 60_000
SERVING_PARTS = 12


def bench_concurrent_serving(device: str = "cuda") -> dict:
    """N same-shape Q12 queries (different year literals) served on one
    shared elastic pool at a fixed worker budget, interleaved vs serial.

    The throughput comparison is in MODEL time (deterministic per seed —
    the same serverless execution model the shuffle_elision bench
    gates); the compiled-plan cache hit rate is measured on a fresh
    cache, so the first query misses and the N-1 same-shape followers
    hit — wall times are recorded alongside to show the retrace savings.
    """
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.engine import datagen
    from repro_torch.serve.query_server import QueryRequest, QueryServer

    store = ObjectStore()
    tables = {
        "lineitem": datagen.load_table(store, "lineitem", SERVING_ROWS,
                                       SERVING_PARTS),
        "orders": datagen.load_table(store, "orders", SERVING_ROWS // 4,
                                     SERVING_PARTS // 2),
    }
    base = datagen.DATE_1994_01_01

    def requests():
        # Same plan SHAPE, different filter literals, two tenants.
        return [QueryRequest(queries.q12_logical(year_lo=base + 30 * i),
                             tenant=f"tenant{i % 2}")
                for i in range(SERVING_N_QUERIES)]

    def make_server():
        srv = QueryServer(store, worker_budget=SERVING_BUDGET, rng_seed=0,
                          backend="torch", device=device)
        for t, keys in tables.items():
            srv.register_table(t, keys)
        return srv

    # Serial baseline first: same machinery, one query at a time. This
    # run also builds the kernels and fills the stage caches.
    engine_compile.PLAN_CACHE.clear()
    reports = {}
    serial_wall = _timed(lambda: reports.update(serial=make_server().serve(
        requests(), interleave=False)), device)
    # Fresh plan cache so the interleaved run records the honest
    # first-query-miss hit rate; stage caches stay warm (wall time shows
    # it).
    engine_compile.PLAN_CACHE.clear()
    inter_wall = _timed(lambda: reports.update(
        inter=make_server().serve(requests())), device)
    serial, inter = reports["serial"], reports["inter"]

    assert all(s.result.result.num_rows > 0 for s in inter.queries)
    out = {
        "n_queries": SERVING_N_QUERIES, "worker_budget": SERVING_BUDGET,
        "rows": SERVING_ROWS,
        "serial_makespan_s": serial.makespan_s,
        "serial_throughput_qps": serial.throughput_qps,
        "serial_p50_latency_s": serial.p50_latency_s,
        "serial_p99_latency_s": serial.p99_latency_s,
        "interleaved_makespan_s": inter.makespan_s,
        "interleaved_throughput_qps": inter.throughput_qps,
        "p50_latency_s": inter.p50_latency_s,
        "p99_latency_s": inter.p99_latency_s,
        "plan_cache_hits": inter.plan_cache_hits,
        "plan_cache_misses": inter.plan_cache_misses,
        "plan_cache_hit_rate": inter.plan_cache_hit_rate,
        "serial_wall_s": serial_wall,
        "interleaved_wall_s": inter_wall,
        "admission": inter.admission,
        "speedup": inter.throughput_qps / serial.throughput_qps,
    }
    return out


# ---------------------------------------------------------------------------
# 10) tiered exchange: cost-based shuffle placement vs forcing one tier
# ---------------------------------------------------------------------------

TIERED_ROWS = 400_000
TIERED_ORDERS = 100_000
TIERED_PARTS = 8


def _measure_exchange_bw(make_store) -> float:
    """Measured per-client throughput of one exchange tier (bytes/s):
    round-trip 4 MiB objects through the store's metered put/get path.
    Recorded into the bench section so the optimizer's break-even reads a
    measured profile instead of the ServiceProfile nominal bandwidth."""
    st = make_store()
    blob = b"\x00" * (4 * 1024 * 1024)
    st.put("bw/warm", blob)
    st.get("bw/warm")
    moved = 0
    t0 = time.perf_counter()
    for i in range(8):
        st.put(f"bw/{i}", blob)
        st.get(f"bw/{i}")
        moved += 2 * len(blob)
    return moved / max(time.perf_counter() - t0, 1e-9)


def _tiered_query(n: int):
    """Q12-shaped join + low-cardinality aggregate, unfiltered: the row
    and build shuffles carry the full projected tables (bulk — above the
    exchange break-even size), the l_shipmode combine carries a handful
    of groups (hot and tiny — below it)."""
    from repro_torch.engine.logical import col, count_, scan, sum_

    lineitem = scan("lineitem", ["l_orderkey", "l_shipmode",
                                 "l_extendedprice", "l_discount"])
    orders = scan("orders", ["o_orderkey", "o_orderpriority"])
    return (
        lineitem.join(orders, on=("l_orderkey", "o_orderkey"))
        .select("l_shipmode",
                (col("l_extendedprice") * (1 - col("l_discount")))
                .alias("revenue"),
                "o_orderpriority")
        .group_by("l_shipmode")
        .agg(sum_("revenue").alias("revenue"),
             count_("revenue").alias("n_lines"))
        .collect("tiered_q12_style", shuffle_partitions=n))


def bench_tiered_exchange(device: str = "cuda") -> dict:
    """A Q12-shaped join + aggregate under the three exchange placements:
    break-even auto (the optimizer's per-shuffle choice), all-object,
    all-KV. The plan has the shape placement is about — two bulk shuffles
    feeding the join and one tiny combine shuffle — so auto must route
    the combine to the memory KV tier and keep the bulk shuffles on the
    object store, beating all-object on modeled runtime (the combine's
    request barriers collapse from ~100 ms of object-store tail latency
    to ~1 ms) and all-KV on cost (bulk bytes pay KV transfer + capacity
    rent for no runtime win)."""
    from repro_torch.core.storage_service import KVStore, ObjectStore
    from repro_torch.engine import datagen, plans
    from repro_torch.engine.coordinator import Coordinator

    store = ObjectStore()
    tables = {
        "lineitem": datagen.load_table(store, "lineitem", TIERED_ROWS,
                                       TIERED_PARTS),
        "orders": datagen.load_table(store, "orders", TIERED_ORDERS,
                                     TIERED_PARTS // 2),
    }
    out: dict = {"rows": TIERED_ROWS, "orders_rows": TIERED_ORDERS,
                 "partitions": TIERED_PARTS,
                 "object_exchange_bytes_per_s":
                     _measure_exchange_bw(ObjectStore),
                 "kv_exchange_bytes_per_s": _measure_exchange_bw(KVStore)}
    results = {}
    for tag in ("placed", "all_object", "all_kv"):
        tiers = {"placed": "auto", "all_object": "object",
                 "all_kv": "kv"}[tag]
        # Fresh coordinator per variant (same seed): identical stochastic
        # latency draws, so the modeled runtime delta is placement alone.
        # Provisioned mode pre-boots the pool — exchange barriers, not
        # cold starts, are the term under test (paper Table 6).
        coord = Coordinator(store, mode="provisioned", backend="torch",
                            device=device, rng_seed=0)
        for t, keys in tables.items():
            coord.register_table(t, keys)
        stats = optimizer.Stats.from_store(store, coord.table_keys)
        plan = optimizer.plan(_tiered_query(TIERED_PARTS), stats=stats,
                              backend="torch", exchange_tiers=tiers)
        qid = f"bench-tiered-{tag}"
        res = coord.execute(plan, f"{qid}-cold")
        wall = min(_timed(lambda i=i: coord.execute(plan, f"{qid}-{i}"),
                          device) for i in range(3))
        results[tag] = res
        shuffle_tiers = [p.output.tier for p in plan.pipelines
                         if isinstance(p.output, plans.ShuffleOutput)]
        out[f"{tag}_kv_shuffles"] = shuffle_tiers.count("kv")
        out[f"{tag}_object_shuffles"] = shuffle_tiers.count("object")
        out[f"{tag}_model_runtime_s"] = res.runtime_s
        out[f"{tag}_wall_s"] = wall
        out[f"{tag}_cost_usd"] = res.faas_cost_usd + res.storage_cost_usd
        out[f"{tag}_exchange_cost_usd"] = res.exchange_cost_usd
    # The break-even split actually split: combine on KV, bulk on object.
    assert out["placed_kv_shuffles"] >= 1
    assert out["placed_object_shuffles"] >= 1
    assert results["placed"].result.num_rows == \
        results["all_object"].result.num_rows == \
        results["all_kv"].result.num_rows > 0
    out["speedup"] = out["all_object_model_runtime_s"] / \
        out["placed_model_runtime_s"]
    out["cost_vs_all_kv_speedup"] = out["all_kv_cost_usd"] / \
        out["placed_cost_usd"]
    out["cost_vs_all_object_ratio"] = out["all_object_cost_usd"] / \
        out["placed_cost_usd"]
    return out


# ---------------------------------------------------------------------------
# 11) adaptive execution under chaos injection
# ---------------------------------------------------------------------------

ADAPT_ROWS = 6_000
ADAPT_ORDERS = 1_200
ADAPT_PARTS = 8
ADAPT_SEEDS = 10
ADAPT_SLOW_PROB = 0.15
ADAPT_DROP_PROB = 0.08


def _adaptive_query(n: int):
    from repro_torch.engine.logical import col, scan, sum_

    return (
        scan("lineitem", ["l_orderkey", "l_extendedprice", "l_discount"])
        .join(scan("orders", ["o_orderkey", "o_totalprice"]),
              on=("l_orderkey", "o_orderkey"))
        .select("l_orderkey",
                (col("l_extendedprice") * (1 - col("l_discount")))
                .alias("revenue"), "o_totalprice")
        .group_by("l_orderkey")
        .agg(sum_("revenue").alias("revenue"))
        .collect("adaptive_chaos_q", shuffle_partitions=n))


def _canonical(batch) -> dict:
    cols = sorted(batch.keys())
    order = np.lexsort([np.asarray(batch[c]) for c in cols])
    return {c: np.asarray(batch[c])[order] for c in cols}


def bench_adaptive_chaos(device: str = "cuda") -> dict:
    """Adaptive vs static execution of the same join+aggregate under
    seeded chaos injection (lognormal worker slowdowns + dropped shuffle
    writes). The adaptive coordinator speculates on stragglers past the
    lognormal expected-max barrier, repairs lost writes by targeted
    duplicate re-execution (static re-runs whole producer stages), and
    re-derives shuffle fan-out from observed bytes at each boundary. The
    paper's tail argument is about p99, not the mean — one straggling or
    retried fragment holds the whole exchange barrier — so the gate is
    the p99 modeled-runtime ratio across the seed sweep. Deterministic:
    every fault decision is a pure function of (seed, identity)."""
    from repro_torch.core.chaos import ChaosPolicy
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.engine import datagen
    from repro_torch.engine.adaptive import ADAPTIVE, STATIC, AdaptiveCoordinator

    runtimes: dict = {"static": [], "adaptive": []}
    counters = {"speculative_launched": 0, "speculative_won": 0,
                "replans": 0, "static_recoveries": 0}
    for seed in range(ADAPT_SEEDS):
        per_variant = {}
        for tag, policy in (("static", STATIC), ("adaptive", ADAPTIVE)):
            store = ObjectStore()
            li = datagen.load_table(store, "lineitem", ADAPT_ROWS,
                                    ADAPT_PARTS, seed=seed)
            od = datagen.load_table(store, "orders", ADAPT_ORDERS,
                                    ADAPT_PARTS, seed=seed)
            # Chaos attaches AFTER the base tables land (only shuffle/
            # intermediates are re-executable) and to BOTH tiers — the
            # planner routes tiny exchanges to the KV tier.
            chaos = ChaosPolicy(seed=seed, slow_prob=ADAPT_SLOW_PROB,
                                drop_prob=ADAPT_DROP_PROB)
            store.chaos = chaos
            coord = AdaptiveCoordinator(store, policy=policy,
                                        mode="provisioned", backend="torch",
                                        device=device, rng_seed=seed,
                                        chaos=chaos)
            coord.kv_store.chaos = chaos
            coord.register_table("lineitem", li)
            coord.register_table("orders", od)
            res = coord.run(_adaptive_query(ADAPT_PARTS),
                            query_id=f"chaos-{seed}")
            runtimes[tag].append(res.runtime_s)
            per_variant[tag] = res
            if tag == "adaptive":
                counters["speculative_launched"] += res.speculative_launched
                counters["speculative_won"] += res.speculative_won
                counters["replans"] += res.replans
            else:
                counters["static_recoveries"] += sum(
                    "re-executed producer stage" in ln
                    for ln in res.adaptive_trace)
        # Same faults, same answer: chaos must never change the result
        # (duplicates are idempotent, repairs are byte-identical).
        a = _canonical(per_variant["static"].result)
        b = _canonical(per_variant["adaptive"].result)
        assert list(a) == list(b)
        for c in a:
            # rtol covers float association — replanned fan-outs legally
            # reorder the additions inside the sum aggregate.
            np.testing.assert_allclose(a[c], b[c], rtol=1e-6, atol=1e-8)

    out: dict = {"rows": ADAPT_ROWS, "orders_rows": ADAPT_ORDERS,
                 "partitions": ADAPT_PARTS, "seeds": ADAPT_SEEDS,
                 "slow_prob": ADAPT_SLOW_PROB, "drop_prob": ADAPT_DROP_PROB,
                 **counters}
    for tag in ("static", "adaptive"):
        rt = np.asarray(runtimes[tag])
        out[f"{tag}_mean_runtime_s"] = float(rt.mean())
        out[f"{tag}_p99_runtime_s"] = float(np.percentile(rt, 99))
    out["p99_speedup"] = out["static_p99_runtime_s"] / \
        out["adaptive_p99_runtime_s"]
    out["mean_speedup"] = out["static_mean_runtime_s"] / \
        out["adaptive_mean_runtime_s"]
    return out


# ---------------------------------------------------------------------------
# 12) out-of-core execution: budgeted morsel streaming + spill at 10x rows
# ---------------------------------------------------------------------------

OOC_JOIN_PROBE_ROWS = 10 * JOIN_PROBE_ROWS       # 10,000,000
OOC_JOIN_BUILD_ROWS = 10 * JOIN_BUILD_ROWS       # 2,500,000
OOC_AGG_ROWS = 10 * PIPELINE_ROWS                # 20,000,000
OOC_JOIN_PARTITIONS = 32
OOC_AGG_PARTITIONS = 8
# Per-worker cap of the budgeted leg: below the join build's ~22 MiB
# (so the build demotes to a spilled frame file) and far below either
# fragment's working set (so the partition accumulator flushes through
# multiple spill rounds).
OOC_CAP_MIB = 16.0
OOC_OBJECTS = 16             # input split: one object ~ input/16
OOC_REPEATS = 2


def _ooc_load(store, table: str, batch: ColumnBatch,
              n_objects: int) -> list[str]:
    keys = []
    step = -(-batch.num_rows // n_objects)
    for i, lo in enumerate(range(0, batch.num_rows, step)):
        key = f"tables/{table}/part-{i:05d}"
        store.put(key, columnar.serialize_frame(
            ColumnBatch({k: np.asarray(v)[lo:lo + step]
                         for k, v in batch.items()})))
        keys.append(key)
    return keys


def _ooc_fragment(store, read_keys, read_keys2, ops, key_col, r, qid,
                  budget, device, backend="torch"):
    """Best-of-``OOC_REPEATS`` wall time of one fragment after a warm-up
    round, its metrics and spill stats, and the device's copy time of
    one more run."""
    from repro_torch.engine import spill, worker

    spec = worker.FragmentSpec(
        query_id=qid, pipeline="ooc", fragment=0,
        read_keys=read_keys, read_keys2=read_keys2 or [],
        columns=None, ops=ops,
        output={"type": "shuffle", "partition_by": key_col,
                "partitions": r},
        backend=backend, device=device, missing_ok2=False,
        memory_budget=budget)
    spill.reset_stats()
    gc.collect()
    best, metrics, stats = float("inf"), None, None
    for i in range(OOC_REPEATS + 1):     # first round builds the kernels
        spill.reset_stats()
        result = []
        elapsed = _timed(lambda: result.append(
            worker.execute_fragment(store, spec)), device)
        metrics = result[0]
        stats = dict(spill.SPILL_STATS)
        if i > 0:
            best = min(best, elapsed)
    copy_s = _copy_s(lambda: worker.execute_fragment(store, spec),
                     device) if backend == "torch" else 0.0
    return best, metrics, stats, copy_s


def bench_out_of_core(device: str = "cuda") -> dict:
    """The out-of-core bench: the join and agg fragment shapes at
    10x their legacy row counts, executed through ``worker.
    execute_fragment`` three ways — legacy in-memory (no budget),
    *accounted* (unlimited budget: morsel streaming + full
    ``MemoryBudget`` accounting, no spill) and *capped* (a fixed
    ``OOC_CAP_MIB`` per-worker cap that forces the join build to spill to
    a frame file and the partition accumulator through multiple spill
    rounds). All three legs must produce byte-identical shuffle objects.

    ``*_mem_reduction_speedup`` gates that the capped leg's accounted
    peak is genuinely below the unbudgeted working set (that is what
    spilling buys); ``*_spill_slowdown`` records what it costs
    (``check_regression`` bounds it by ``SPILL_OVERHEAD_MAX``)."""
    from repro_torch.core.storage_service import ObjectStore

    cap = OOC_CAP_MIB * MIB
    out: dict = {"cap_mib": OOC_CAP_MIB, "objects": OOC_OBJECTS,
                 "join_probe_rows": OOC_JOIN_PROBE_ROWS,
                 "join_build_rows": OOC_JOIN_BUILD_ROWS,
                 "join_partitions": OOC_JOIN_PARTITIONS,
                 "agg_rows": OOC_AGG_ROWS,
                 "agg_partitions": OOC_AGG_PARTITIONS}

    # -- join fragment: hash_join -> filter -> project, shuffled --------
    probe, build, ops = _join_fragment(OOC_JOIN_PROBE_ROWS,
                                       OOC_JOIN_BUILD_ROWS, seed=7)
    ops = [{k: v for k, v in op.items() if k != "build"} for op in ops]
    store = ObjectStore()
    probe_keys = _ooc_load(store, "ooc_probe", probe, OOC_OBJECTS)
    build_keys = _ooc_load(store, "ooc_build", build, OOC_OBJECTS // 4)
    out["join_input_mib"] = (probe.nbytes() + build.nbytes()) / MIB
    del probe, build
    legs = {}
    for tag, budget in (("baseline", None), ("accounted", float("inf")),
                        ("capped", cap)):
        legs[tag] = _ooc_fragment(
            store, probe_keys, build_keys, ops, "l_orderkey",
            OOC_JOIN_PARTITIONS, f"ooc-join-{tag}", budget, device)
    legs["numpy"] = _ooc_fragment(
        store, probe_keys, build_keys, ops, "l_orderkey",
        OOC_JOIN_PARTITIONS, "ooc-join-numpy", None, device,
        backend="numpy")
    _ooc_record(out, store, "join", legs, "ooc-join")
    assert legs["capped"][2]["spilled_builds"] >= 1    # build went to disk

    # -- agg fragment: filter -> project -> partial hash_agg, shuffled --
    batch = _lineitem(OOC_AGG_ROWS, seed=8)
    store = ObjectStore()
    agg_keys = _ooc_load(store, "ooc_lineitem", batch, OOC_OBJECTS)
    out["agg_input_mib"] = batch.nbytes() / MIB
    del batch
    legs = {}
    for tag, budget in (("baseline", None), ("accounted", float("inf")),
                        ("capped", cap)):
        legs[tag] = _ooc_fragment(
            store, agg_keys, None, _FUSION_OPS, "l_returnflag",
            OOC_AGG_PARTITIONS, f"ooc-agg-{tag}", budget, device)
    legs["numpy"] = _ooc_fragment(
        store, agg_keys, None, _FUSION_OPS, "l_returnflag",
        OOC_AGG_PARTITIONS, "ooc-agg-numpy", None, device,
        backend="numpy")
    _ooc_record(out, store, "agg", legs, "ooc-agg")
    assert out["agg_spill_rounds"] >= 2     # multiple accumulator flushes
    return out


def _ooc_record(out: dict, store, what: str, legs: dict,
                qid_prefix: str) -> None:
    """Record one fragment shape's three legs + assert byte-identity of
    the shuffle objects across them."""
    base_keys = sorted(store.list(f"shuffle/{qid_prefix}-baseline/"))
    for tag in ("accounted", "capped"):
        keys = sorted(store.list(f"shuffle/{qid_prefix}-{tag}/"))
        assert [k.rsplit("/", 1)[-1] for k in keys] == \
            [k.rsplit("/", 1)[-1] for k in base_keys]
        for k, bk in zip(keys, base_keys):
            assert store.get(k) == store.get(bk), (what, tag, k)
    base_s, _, _, base_copy_s = legs["baseline"]
    acct_s, acct_m, _, _ = legs["accounted"]
    cap_s, cap_m, cap_stats, cap_copy_s = legs["capped"]
    numpy_s = legs["numpy"][0]
    rows = cap_m.rows_in
    out[f"{what}_baseline_s"] = base_s
    out[f"{what}_accounted_s"] = acct_s
    out[f"{what}_capped_s"] = cap_s
    out[f"{what}_capped_mrows_s"] = rows / cap_s / 1e6
    out[f"{what}_spill_bytes"] = cap_m.spill_bytes
    out[f"{what}_spill_rounds"] = cap_m.spill_rounds
    out[f"{what}_spilled_builds"] = cap_stats["spilled_builds"]
    out[f"{what}_accounted_peak_mib"] = acct_m.mem_peak_bytes / MIB
    out[f"{what}_capped_peak_mib"] = cap_m.mem_peak_bytes / MIB
    out[f"{what}_mem_reduction_speedup"] = \
        acct_m.mem_peak_bytes / max(cap_m.mem_peak_bytes, 1)
    out[f"{what}_spill_slowdown"] = cap_s / base_s
    # The in-memory torch leg against the same fragment on numpy, and
    # the device's copy time of one run of each torch leg.
    out[f"{what}_numpy_s"] = numpy_s
    out[f"{what}_vs_numpy_speedup"] = numpy_s / base_s
    out[f"{what}_baseline_copy_s"] = base_copy_s
    out[f"{what}_capped_copy_s"] = cap_copy_s


# ---------------------------------------------------------------------------
# 13) worker-failure fault domain: crash/OOM/invoke-fail recovery
# ---------------------------------------------------------------------------

FAULT_ROWS = 16_000          # per-fragment working set clears the 64 KiB
FAULT_ORDERS = 3_200         # chaos OOM floor at 4 partitions
FAULT_PARTS = 4
FAULT_SEEDS = 10
FAULT_KILL_PROB = 0.2
FAULT_OOM_PROB = 0.1
FAULT_INVOKE_PROB = 0.1


def bench_fault_recovery(device: str = "cuda") -> dict:
    """Static vs lineage-recovering execution of the same join+aggregate
    under seeded worker-failure chaos: fragments crash after a
    deterministic prefix of their shuffle write, OOM above a chaos
    threshold (the retry takes the spill path), and cold starts fail (the
    pool retries with capped backoff). The static baseline can only
    re-run whole stages; the recovering executor re-runs exactly the dead
    attempt under the attempt-scoped commit protocol. The gate — like
    ``adaptive_chaos`` — is the p99 modeled-runtime ratio across the seed
    sweep: one killed fragment holds the whole exchange barrier.

    Correctness is asserted inline: the recovering leg must be
    BIT-identical to a fault-free run of the same policy (committed bytes
    are identical, so every adaptive decision replays identically), and
    the static leg must match at float-association tolerance."""
    import dataclasses as _dc

    from repro_torch.core.chaos import ChaosPolicy
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.engine import datagen
    from repro_torch.engine.adaptive import ADAPTIVE, STATIC, AdaptiveCoordinator

    # kill_prob at 1st-offer-only semantics: a width-n stage can need n
    # stage-level re-runs from the static executor, so give it rope —
    # the cost of every re-run is exactly what the bench measures.
    static_policy = _dc.replace(STATIC, max_recover_attempts=32)
    runtimes: dict = {"static": [], "adaptive": []}
    counters = {"kills": 0, "ooms": 0, "invoke_fails": 0,
                "attempt_retries": 0, "stage_reruns": 0}
    for seed in range(FAULT_SEEDS):
        per_leg = {}
        for tag, policy, chaotic in (("baseline", ADAPTIVE, False),
                                     ("static", static_policy, True),
                                     ("adaptive", ADAPTIVE, True)):
            store = ObjectStore()
            li = datagen.load_table(store, "lineitem", FAULT_ROWS,
                                    FAULT_PARTS, seed=seed)
            od = datagen.load_table(store, "orders", FAULT_ORDERS,
                                    FAULT_PARTS, seed=seed)
            chaos = None
            if chaotic:
                # Fresh same-seed policy per leg: both legs see the
                # IDENTICAL fault schedule (pure f(seed, identity)).
                chaos = ChaosPolicy(seed=seed, slow_prob=0.0,
                                    drop_prob=0.0,
                                    kill_prob=FAULT_KILL_PROB,
                                    oom_prob=FAULT_OOM_PROB,
                                    invoke_fail_prob=FAULT_INVOKE_PROB)
            store.chaos = chaos
            coord = AdaptiveCoordinator(store, policy=policy,
                                        mode="elastic", backend="torch",
                                        device=device, rng_seed=seed,
                                        chaos=chaos)
            coord.kv_store.chaos = chaos
            coord.register_table("lineitem", li)
            coord.register_table("orders", od)
            res = coord.run(_adaptive_query(FAULT_PARTS),
                            query_id=f"fault-{tag}-{seed}")
            per_leg[tag] = res
            if not chaotic:
                continue
            runtimes[tag].append(res.runtime_s)
            counters["kills"] += chaos.kills
            counters["ooms"] += chaos.ooms
            counters["invoke_fails"] += chaos.invoke_fails
            if tag == "adaptive":
                counters["attempt_retries"] += sum(
                    "re-ran only the dead attempt" in ln
                    for ln in res.adaptive_trace)
            else:
                counters["stage_reruns"] += sum(
                    "re-ran the stage" in ln for ln in res.adaptive_trace)
        # The recovering leg replays the fault-free leg bit for bit:
        # every commit is byte-identical, so is every decision. Sort by
        # the unique integer group key — float-primary orders would let
        # association-order noise swap near-equal rows across plans.
        def by_key(batch):
            order = np.argsort(np.asarray(batch["l_orderkey"]),
                               kind="stable")
            return {c: np.asarray(batch[c])[order] for c in batch.keys()}

        a = by_key(per_leg["baseline"].result)
        b = by_key(per_leg["adaptive"].result)
        assert list(a) == list(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])
        s = by_key(per_leg["static"].result)
        for c in a:
            np.testing.assert_allclose(a[c], s[c], rtol=1e-6, atol=1e-8)
    assert counters["kills"] + counters["ooms"] + \
        counters["invoke_fails"] > 0, "chaos sweep injected nothing"

    out: dict = {"rows": FAULT_ROWS, "orders_rows": FAULT_ORDERS,
                 "partitions": FAULT_PARTS, "seeds": FAULT_SEEDS,
                 "kill_prob": FAULT_KILL_PROB, "oom_prob": FAULT_OOM_PROB,
                 "invoke_fail_prob": FAULT_INVOKE_PROB, **counters}
    for tag in ("static", "adaptive"):
        rt = np.asarray(runtimes[tag])
        out[f"{tag}_mean_runtime_s"] = float(rt.mean())
        out[f"{tag}_p99_runtime_s"] = float(np.percentile(rt, 99))
    out["p99_speedup"] = out["static_p99_runtime_s"] / \
        out["adaptive_p99_runtime_s"]
    out["mean_speedup"] = out["static_mean_runtime_s"] / \
        out["adaptive_mean_runtime_s"]
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

SECTIONS = {
    "pipeline": bench_pipeline,
    "join_pipeline": bench_join_pipeline,
    "dup_key_join": bench_dup_key_join,
    "partition_fusion": bench_partition_fusion,
    "shuffle_elision": bench_shuffle_elision,
    "serde": bench_serde,
    "shuffle": bench_shuffle,
    "planning": bench_planning,
    "concurrent_serving": bench_concurrent_serving,
    "tiered_exchange": bench_tiered_exchange,
    "adaptive_chaos": bench_adaptive_chaos,
    "out_of_core": bench_out_of_core,
    "fault_recovery": bench_fault_recovery,
}


def config() -> dict:
    return {"serde_rows": SERDE_ROWS,
            "shuffle_rows": SHUFFLE_ROWS,
            "shuffle_partitions": SHUFFLE_PARTITIONS,
            "pipeline_rows": PIPELINE_ROWS,
            "join_probe_rows": JOIN_PROBE_ROWS,
            "join_build_rows": JOIN_BUILD_ROWS,
            "join_partitions": JOIN_PARTITIONS,
            "dup_probe_rows": DUP_PROBE_ROWS,
            "dup_build_unique": DUP_BUILD_UNIQUE,
            "dup_skew": DUP_SKEW,
            "fusion_rows": FUSION_ROWS,
            "fusion_partitions": FUSION_PARTITIONS,
            "elision_rows": ELISION_ROWS,
            "elision_orders": ELISION_ORDERS,
            "elision_partitions": ELISION_PARTITIONS,
            "serving_n_queries": SERVING_N_QUERIES,
            "serving_budget": SERVING_BUDGET,
            "serving_rows": SERVING_ROWS,
            "tiered_rows": TIERED_ROWS,
            "tiered_orders": TIERED_ORDERS,
            "tiered_partitions": TIERED_PARTS,
            "adaptive_rows": ADAPT_ROWS,
            "adaptive_orders": ADAPT_ORDERS,
            "adaptive_partitions": ADAPT_PARTS,
            "adaptive_seeds": ADAPT_SEEDS,
            "ooc_join_probe_rows": OOC_JOIN_PROBE_ROWS,
            "ooc_join_build_rows": OOC_JOIN_BUILD_ROWS,
            "ooc_agg_rows": OOC_AGG_ROWS,
            "ooc_cap_mib": OOC_CAP_MIB,
            "fault_rows": FAULT_ROWS,
            "fault_seeds": FAULT_SEEDS,
            "fault_kill_prob": FAULT_KILL_PROB,
            "fault_oom_prob": FAULT_OOM_PROB,
            "fault_invoke_fail_prob": FAULT_INVOKE_PROB,
            "repeats": REPEATS}


def device_entry(device) -> dict:
    """What ran the torch backend: the torch device and versions and, on
    a card, its name and ``nvidia-smi``'s name and power limit."""
    out = {"torch_device": device, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if _on_card(device):
        out["name"] = torch.cuda.get_device_name(torch.device(device))
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def run_sections(names, out_path: pathlib.Path = DEFAULT_OUT,
                 merge: bool = True, device: str = "cuda") -> dict:
    """Run the named sections (in ``SECTIONS``' order) with the torch
    backend on ``device`` and write them to ``out_path``, merged into
    what it holds when ``merge``."""
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown sections: {', '.join(unknown)} "
                         f"(available: {', '.join(sorted(SECTIONS))})")
    results = json.loads(out_path.read_text()) \
        if merge and out_path.exists() else {}
    results["device"] = device_entry(device)
    for name in SECTIONS:
        if name in names:
            t0 = time.perf_counter()
            results[name] = SECTIONS[name](device)
            print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    results["config"] = config()
    out_path.write_text(json.dumps(results, indent=2) + "\n")
    return results


def data_plane_rows(results: dict) -> list[tuple]:
    """The reference's ``engine_data_plane`` rows, by name and order,
    from the port's sections: its ``*_jit_*`` rows read the sections'
    ``torch_s`` and ``torch_mrows_s``."""
    sh, pp, sd = results["shuffle"], results["pipeline"], results["serde"]
    jp, pl = results["join_pipeline"], results["planning"]
    dk, pf = results["dup_key_join"], results["partition_fusion"]
    se = results["shuffle_elision"]
    cs = results["concurrent_serving"]
    te = results["tiered_exchange"]
    ac = results["adaptive_chaos"]
    oc = results["out_of_core"]
    fr = results["fault_recovery"]
    return [
        ("engine/fault_recovery_p99_speedup", 0.0, fr["p99_speedup"]),
        ("engine/fault_recovery_mean_speedup", 0.0, fr["mean_speedup"]),
        ("engine/ooc_join_mem_reduction_speedup", 0.0,
         oc["join_mem_reduction_speedup"]),
        ("engine/ooc_agg_mem_reduction_speedup", 0.0,
         oc["agg_mem_reduction_speedup"]),
        ("engine/ooc_join_spill_slowdown", 0.0, oc["join_spill_slowdown"]),
        ("engine/ooc_agg_spill_slowdown", 0.0, oc["agg_spill_slowdown"]),
        ("engine/ooc_capped_join_mrows_s", oc["join_capped_s"] * 1e6,
         oc["join_capped_mrows_s"]),
        ("engine/ooc_capped_agg_mrows_s", oc["agg_capped_s"] * 1e6,
         oc["agg_capped_mrows_s"]),
        ("engine/adaptive_chaos_p99_speedup", 0.0, ac["p99_speedup"]),
        ("engine/adaptive_chaos_mean_speedup", 0.0, ac["mean_speedup"]),
        ("engine/tiered_exchange_speedup", 0.0, te["speedup"]),
        ("engine/tiered_exchange_cost_vs_all_kv_speedup", 0.0,
         te["cost_vs_all_kv_speedup"]),
        ("engine/concurrent_serving_speedup", 0.0, cs["speedup"]),
        ("engine/concurrent_serving_hit_rate", 0.0,
         cs["plan_cache_hit_rate"]),
        ("engine/shuffle_elision_speedup", 0.0, se["speedup"]),
        ("engine/shuffle_elision_cost_ratio", 0.0, se["cost_ratio"]),
        ("engine/dup_key_join_speedup", 0.0, dk["speedup"]),
        ("engine/partition_fusion_speedup", 0.0, pf["speedup"]),
        ("engine/frame_deser_speedup", 0.0, sd["deser_speedup"]),
        ("engine/shuffle_seed_mib_s", sh["seed_s"] * 1e6, sh["seed_mib_s"]),
        ("engine/shuffle_radix_mib_s", sh["radix_s"] * 1e6,
         sh["radix_mib_s"]),
        ("engine/shuffle_speedup", 0.0, sh["speedup"]),
        ("engine/pipeline_numpy_mrows_s", pp["numpy_s"] * 1e6,
         pp["numpy_mrows_s"]),
        ("engine/pipeline_jit_mrows_s", pp["torch_s"] * 1e6,
         pp["torch_mrows_s"]),
        ("engine/fused_pipeline_speedup", 0.0, pp["speedup"]),
        ("engine/join_numpy_mrows_s", jp["numpy_s"] * 1e6,
         jp["numpy_mrows_s"]),
        ("engine/join_jit_mrows_s", jp["torch_s"] * 1e6,
         jp["torch_mrows_s"]),
        ("engine/fused_join_pipeline_speedup", 0.0, jp["speedup"]),
        ("engine/planning_q12_lower_us", pl["q12_lower_s"] * 1e6,
         pl["q12_lower_s"] * 1e6),
        ("engine/planning_overhead_frac", pl["q12_lower_s"] * 1e6,
         pl["overhead_frac"]),
    ]


def engine_data_plane(device: str = "cuda") -> list[tuple]:
    """``repro_torch.bench.run``'s hook: every section run with the torch
    backend on ``device`` (nothing written), as the reference's rows."""
    return data_plane_rows({name: fn(device)
                            for name, fn in SECTIONS.items()})


# The reference's bands (``benchmarks/engine_bench.py``), unchanged.
EXPECT = {
    "engine/shuffle_speedup": (3.0, 1000.0),
    "engine/fused_pipeline_speedup": (1.2, 1000.0),
    "engine/fused_join_pipeline_speedup": (1.5, 1000.0),
    "engine/dup_key_join_speedup": (1.0, 1000.0),
    "engine/partition_fusion_speedup": (1.0, 1000.0),
    "engine/shuffle_elision_speedup": (1.5, 1000.0),
    "engine/shuffle_elision_cost_ratio": (1.0, 1000.0),
    "engine/concurrent_serving_speedup": (1.5, 1000.0),
    "engine/concurrent_serving_hit_rate": ((SERVING_N_QUERIES - 1)
                                           / SERVING_N_QUERIES, 1.0),
    "engine/planning_overhead_frac": (0.0, 0.01),
    "engine/tiered_exchange_speedup": (1.2, 1000.0),
    "engine/tiered_exchange_cost_vs_all_kv_speedup": (1.25, 1000.0),
    "engine/adaptive_chaos_p99_speedup": (1.3, 1000.0),
    "engine/adaptive_chaos_mean_speedup": (1.0, 1000.0),
    "engine/ooc_join_mem_reduction_speedup": (1.5, 1000.0),
    "engine/ooc_agg_mem_reduction_speedup": (1.5, 1000.0),
    "engine/ooc_join_spill_slowdown": (0.0, 4.0),
    "engine/ooc_agg_spill_slowdown": (0.0, 4.0),
    "engine/fault_recovery_p99_speedup": (1.05, 1000.0),
    "engine/fault_recovery_mean_speedup": (1.0, 1000.0),
}

ALL = [engine_data_plane]


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Engine benchmarks of the port -> "
                    "BENCH_engine_torch.json")
    ap.add_argument("--section", "--sections", action="append",
                    default=[], metavar="NAME[,NAME...]",
                    help="run only the named sections (repeatable, "
                         "comma-separable; available: "
                         f"{','.join(sorted(SECTIONS))}) and merge them "
                         "into the existing results file")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend (default: cuda)")
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT,
                    help="results file (default: BENCH_engine_torch.json "
                         "at the repository root)")
    args = ap.parse_args(argv)
    from repro_torch.core.device import resolve_device
    resolve_device(args.device)        # no card: raise before any work
    names = [s for arg in args.section for s in arg.split(",") if s]
    results = run_sections(names or list(SECTIONS), args.out,
                           merge=bool(names), device=args.device)
    print(json.dumps(results, indent=2))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
