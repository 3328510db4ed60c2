#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the query engine and
LLM serving.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printing lines of its numbers:

1. build  — compile the hand-written kernels under
   ``src/repro_torch/csrc/`` (one ``nvcc`` per source, all at once); log
   ptxas' report for the three tensor-core kernels and the count of their
   HGMMA (``wgmma``: flash attention, the grouped matmul) or HMMA
   (``mma.sync``: the RWKV-6 scan) instructions, which must not be 0, and
   for the TMA-fed RG-LRU scan; no report may show spills;
2. load   — generate TPC-H ``lineitem`` (6,000,000 rows, one object: one
   paper worker's ~182 MiB SF1000 partition) and ``orders`` (1,500,000
   rows) into the port's object store;
3. queries — TPC-H Q1, Q6, Q12 and a join whose build side has duplicate
   keys, through ``Coordinator(backend="torch")`` on the card, each held
   against the port's float64 ``"numpy"`` backend (keys and counts
   exact, aggregates rtol=1e-6); every kernel must have launched and no
   interpreted fallback may have run;
4. profile — each warm query's device busy time and each kernel's own
   device time (``torch.profiler``), and its heaviest host functions
   (``cProfile``);
5. query_serving — a ``QueryServer(backend="torch", device="cuda")`` on
   the same store serves Q1, Q6, Q12 and the duplicate-key join twice
   each, from two tenants submitted 0.25 s apart, on 16 workers:
   interleaved on one shared pool, then serially on a new server, each
   result held against the numpy backend's; the compiled-plan cache must
   show 4 hits and 4 misses and the three query kernels must launch
   inside each ``serve()``; the interleaved run again under
   ``torch.profiler`` for the device's idle share; then a server with
   its result cache on replays the four repeats with no kernel launch;
6. adaptive — Q12 and the duplicate-key join on ``AdaptiveCoordinator``
   (the adaptive and the static policy) on the card under seeded chaos
   (dropped shuffle writes, killed and slowed fragments) on both storage
   tiers, seeds 0, 1 and 2: every result the fault-free numpy backend's,
   no query failed, both probes launched;
7. kernels — each query kernel's wrapper against its plain PyTorch
   version on the card at the shapes the queries gave it, timed with CUDA
   events (median and spread of five batches) beside its bound, the plain
   version and one PyTorch library call; the segmented reduction through
   the host offsets the engine passes and through ids (derived on the
   card), with no wait for the card inside the call, and its host µs
   (``perf_counter``) beside its kernels' device µs (``torch.profiler``);
   each row's launches are those of phases 3, 5 and 6;
8. serve  — ``ServingEngine`` answers 8 requests of 1,024-4,096 prompt
   tokens and 32 new tokens each, in two batches of 4, with each of three
   models at full width and depth (random bf16 weights from a seeded
   ``torch.Generator``): RecurrentGemma-2B (``impl="flash"``: the flash
   attention and RG-LRU kernels launch once per ``local`` / ``rec`` layer
   and batch, every flash launch on the tensor-core route, every RG-LRU
   launch on the TMA route), RWKV-6 1.6B
   (``impl="flash"``: the RWKV-6 scan once per ``rwkv`` layer and batch, 48
   in all, every one on the tensor-core route) and DeepSeekMoE-16B (``impl="flash_moe"``: the grouped matmul
   three times per ``moe`` layer and batch, 162 in all, every one on the
   tensor-core route; the reference attention). No other model kernel may
   launch. Each model's first batch's
   prefill is then run again on the reference route (``impl="reference"``)
   and its last-token logits held against the kernel route's (for
   DeepSeekMoE the top-k expert choices of the two routes are compared
   too); three planted faults show what RecurrentGemma's check can see;
   RWKV-6's two routes are also held together with the model widened to
   float32, where two planted faults (decays rounded to bf16, log_w
   doubled) must fail the check; one prefill and one decode step are
   profiled;
9. model kernels — after each model: its kernels against their plain
   versions at the shapes its serving phase gave them, timed as in phase 7
   (flash attention, bf16 on the tensor-core route, also at InternLM2's and
   MusicGen-medium's shapes, D = 128 and 64, and in float32 on the
   CUDA-core route, where a window edge off by one must show; the scans
   also at a strong decay, where the RWKV-6 scan is held against the step
   oracle, and the RWKV-6 scan at a ragged length and at an extreme decay
   (log_w near -60 and near -1e-3 mixed in each chunk), and on its
   one-step-at-a-time route too, timed as the earlier kernel; the RG-LRU
   scan also at near-one decays, against the recurrence stepped in
   float64 too, at a ragged shape (1, 1000, 2564) and at one batch row,
   and on its one-thread-a-lane route too, timed as the earlier kernel;
   the grouped
   matmul also in float32, with its largest error in
   each 64-column block of the output, and at the gate/up shape on its
   ``mma.sync`` route too, timed as the earlier kernel); planted faults
   must fail their checks (the RWKV-6 scan without its bonus u; the
   RG-LRU scan with the first step of every 64-step stage dropped; one
   expert's output of the grouped matmul zeroed, and columns 64-127 of
   every 128 of it zeroed).

Ends with the card's name and power limit, a ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``. Any mismatch or exception exits
non-zero without the ``ok`` line. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
LINEITEM_ROWS = 6_000_000
ORDERS_ROWS = 1_500_000
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
RTOL = 1e-6
QUERIES = ("q1", "q6", "q12", "dup_key_join")
PHASES = ("queries", "query_serving", "adaptive", "serve")  # or some
# The multi-query serving phase: each query twice, two tenants, submit
# times this far apart (model time), on a fixed worker budget.
SERVING_QUERIES = QUERIES + QUERIES
SERVING_GAP_S = 0.25
SERVING_BUDGET = 16
# The adaptive phase: these queries under chaos, for these seeds, on the
# adaptive and the static policy alike.
ADAPTIVE_QUERIES = ("q12", "dup_key_join")
ADAPTIVE_SEEDS = (0, 1, 2)
CHAOS = {"drop_prob": 0.05, "kill_prob": 0.1}
# The kernels the query engine's paths launch.
QUERY_KERNELS = ("probe", "probe_range", "segment_reduce")

# The serving phases, each model at full width and depth: its kernel
# route, and for each of its kernels the layer kind that launches it and
# how many times per layer and batch.
SERVINGS = {
    "recurrentgemma-2b": ("flash", {"flash_attention": ("local", 1),
                                    "rglru_scan": ("rec", 1)}),
    "rwkv6-1.6b": ("flash", {"rwkv6_scan": ("rwkv", 1)}),
    "deepseek-moe-16b": ("flash_moe", {"gmm": ("moe", 3)}),
}
SERVE_ARCHS = tuple(SERVINGS)     # a quick call may serve only some
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN = 4, 4096, 4128
SERVE_MIN_PROMPT = 1024           # prompt lengths drawn in [1024, 4096]
SERVE_REQUESTS, SERVE_NEW_TOKENS, SERVE_SEED = 8, 32, 0
# InternLM2-1.8B's and MusicGen-medium's attention at a 4096-token
# prefill: (B, S, H, D), Hkv. With RecurrentGemma's D = 256 they launch
# every head dim of the tensor-core flash kernel.
INTERNLM2_ATTN = ((1, 4096, 16, 128), 8)
MUSICGEN_ATTN = ((1, 4096, 24, 64), 24)
# Largest |kernel route - reference route| last-token logit allowed, per
# model: 2.5 times the largest difference between two sound routes of the
# model measured on an H100 (reasons and readings in PERF.md). For an MoE
# model the routes are held to the same expert choices.
LOGIT_TOL = {"recurrentgemma-2b": 0.35, "rwkv6-1.6b": 2.4,
             "deepseek-moe-16b": 1.5}
# RWKV-6's routes also run with the model widened to float32, where they
# differ by float32 rounding alone: 2.5 times the largest difference
# between two sound float32 routes measured on an H100 (PERF.md). The
# planted faults of ``log_controls`` must exceed it.
F32_LOGIT_TOL = {"rwkv6-1.6b": 0.033}
BF16_TOL, SCAN_TOL = 2e-2, 1e-5   # rtol = atol, as in the CPU tests
# The RWKV-6 scan in float32: the reference's own kernel tolerance (a
# chunked form against a step loop), here relative to the size of the
# terms each output sums (``within_scan``).
RWKV_TOL = 2e-4
# The grouped matmul in float32 against the float32 einsum (one order of
# float32 sums against another), relative to the size of the summed
# terms, |x| @ |w|.
GMM_F32_TOL = 1e-5
# Attention on the same inputs widened to float32: the float32 kernel
# against the float32 plain version within F32_ATTN_TOL, and the bf16
# kernel against that same float32 result within one rounding to bf16
# (half an ulp, at most BF16_ROUND of the value) plus F32_ATTN_TOL.
F32_ATTN_TOL = 1e-4
BF16_ROUND = 2.0 ** -8
BF16_FLOPS_PER_S = 989e12         # H100 SXM dense bf16 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12         # H100 SXM dense TF32 (NVIDIA data sheet)
RWKV_CHUNK = 16                   # chunk of the chunk-parallel form's bound
# The RG-LRU scan at a ragged shape: S not a whole number of the TMA
# kernel's 64-step stages, W not of its channel tiles.
RGLRU_RAGGED = (1, 1000, 2564)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def dup_key_join_plan():
    """Q12 with the join sides swapped: orders probes the filtered
    lineitem, so the build side (the right side, with no stats) repeats
    ``l_orderkey`` and the fragment takes the range probe."""
    from repro_torch.engine import datagen, optimizer, queries
    from repro_torch.engine.logical import col, count_, scan, sum_
    lo = datagen.DATE_1994_01_01
    li = (scan("lineitem")
          .filter(col("l_shipmode").isin([queries.MAIL, queries.SHIP])
                  & (col("l_commitdate") < col("l_receiptdate"))
                  & (col("l_shipdate") < col("l_commitdate"))
                  & (col("l_receiptdate") >= lo)
                  & (col("l_receiptdate") < lo + 365))
          .select("l_orderkey", "l_shipmode"))
    high = col("o_orderpriority").case_in([queries.URGENT, queries.HIGH])
    q = (scan("orders").select("o_orderkey", "o_orderpriority")
         .join(li, on=("o_orderkey", "l_orderkey"))
         .select("l_shipmode", high.alias("high_line"),
                 (1 - high).alias("low_line"))
         .group_by("l_shipmode")
         .agg(sum_("high_line").alias("high_line_count"),
              sum_("low_line").alias("low_line_count"),
              count_("high_line").alias("lines"))
         .collect("dup_key_join", shuffle_partitions=8))
    return optimizer.plan(q)


def plan_for(name: str):
    from repro_torch.engine import queries
    if name == "dup_key_join":
        return dup_key_join_plan()
    return queries.QUERY_BUILDERS[name]()


KEY_COLS = {"q1": ["l_returnflag", "l_linestatus"], "q6": [],
            "q12": ["l_shipmode"], "dup_key_join": ["l_shipmode"]}


def check_result(name, got, want) -> None:
    import numpy as np
    if list(got) != list(want) or got.num_rows != want.num_rows \
            or got.num_rows == 0:
        raise AssertionError(f"{name}: schema or row count differs: "
                             f"{list(got)}/{got.num_rows} vs "
                             f"{list(want)}/{want.num_rows}")
    keys = KEY_COLS[name]
    order_g = np.lexsort([got[k] for k in keys][::-1]) if keys else [0]
    order_w = np.lexsort([want[k] for k in keys][::-1]) if keys else [0]
    for c in want:
        g, w = np.asarray(got[c])[order_g], np.asarray(want[c])[order_w]
        if g.dtype != w.dtype:
            raise AssertionError(f"{name}.{c}: dtype {g.dtype} != {w.dtype}")
        if c in keys or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{name}.{c}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       err_msg=f"{name}.{c}")


class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its largest call in
    an untimed run (the launch count stays the wrapper's own); with
    ``by_shape``, also the first call of each distinct input shape, in
    ``shapes``."""

    def __init__(self, module, name, size, by_shape=False):
        self.module, self.name, self.size = module, name, size
        self.orig = getattr(module, name)
        self.args = None
        self.shapes = {} if by_shape else None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None or self.size(args) > self.size(self.args[0]):
            self.args = (tuple(a.clone() for a in args), dict(kwargs))
        if self.shapes is not None:
            key = tuple(tuple(a.shape) for a in args)
            if key not in self.shapes:
                self.shapes[key] = (tuple(a.clone() for a in args),
                                    dict(kwargs))
        return self.orig(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def _kernel_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_join as hj
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import segment_reduce as sr
    return {"probe": (hj, "PROBE_LAUNCHES"),
            "probe_range": (hj, "PROBE_RANGE_LAUNCHES"),
            "segment_reduce": (sr, "SEGMENT_REDUCE_LAUNCHES"),
            "flash_attention": (fa, "FLASH_ATTENTION_LAUNCHES"),
            "rglru_scan": (rg, "RGLRU_SCAN_LAUNCHES"),
            "rwkv6_scan": (rs, "RWKV6_SCAN_LAUNCHES"),
            "gmm": (mg, "GMM_LAUNCHES")}


def _route_counters():
    """Launches of a kernel's route, counted beside its kernel's own:
    flash attention's tensor-core route (bf16 at D = 64, 128, 256), the
    grouped matmul's (bf16 with D and F multiples of 8), the RWKV-6
    scan's (K = V = 64) and the RG-LRU scan's TMA route (W * 4 a multiple
    of 16 bytes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rs
    return {"flash_attention_tc": (fa, "FLASH_ATTENTION_TC_LAUNCHES"),
            "gmm_tc": (mg, "GMM_TC_LAUNCHES"),
            "rwkv6_scan_tc": (rs, "RWKV6_SCAN_TC_LAUNCHES"),
            "rglru_scan_tma": (rg, "RGLRU_SCAN_TMA_LAUNCHES")}


# The kernels whose every launch in ``serve`` must take their redesigned
# route (the tensor cores, or TMA for the RG-LRU scan), and the route's
# counter.
TC_ROUTES = {"flash_attention": "flash_attention_tc", "gmm": "gmm_tc",
             "rwkv6_scan": "rwkv6_scan_tc", "rglru_scan": "rglru_scan_tma"}


def launch_counts() -> dict:
    return {k: getattr(mod, attr)
            for k, (mod, attr) in _kernel_modules().items()}


def route_counts() -> dict:
    return {k: getattr(mod, attr)
            for k, (mod, attr) in _route_counters().items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_kernel_modules().values(),
                      *_route_counters().values()):
        setattr(mod, attr, 0)


def run_queries(store, keys):
    import torch
    from repro_torch.engine import compile as tc
    from repro_torch.engine.coordinator import Coordinator
    from repro_torch.kernels import hash_join as hj
    from repro_torch.kernels import segment_reduce as sr

    coords = {}
    for backend in ("torch", "numpy"):
        c = Coordinator(store, backend=backend, device=DEVICE)
        for t, k in keys.items():
            c.register_table(t, k)
        coords[backend] = c
    # The main path: every count at 0 just before, read just after.
    reset_launch_counts()
    for k in tc.FALLBACK_STATS:
        tc.FALLBACK_STATS[k] = 0
    results, walls = {}, {}
    for name in QUERIES:
        w = []
        for rep in range(2):          # cold (first use), then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = coords["torch"].execute(plan_for(name),
                                          query_id=f"{name}-torch-{rep}")
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t0)
        results[name], walls[name] = res.result, w
    # One more run of each query, untimed, keeps the kernels' inputs.
    recorders = {
        "probe": Recorder(hj, "sorted_probe", lambda a: a[1].numel()),
        "probe_range": Recorder(hj, "sorted_probe_range",
                                lambda a: a[1].numel()),
        "segment_reduce": Recorder(sr, "segment_reduce",
                                   lambda a: a[0].numel()),
    }
    try:
        for name in QUERIES:
            coords["torch"].execute(plan_for(name),
                                    query_id=f"{name}-torch-record")
        torch.cuda.synchronize()
    finally:
        for r in recorders.values():
            r.restore()
    launches = query_launches()
    fallbacks = dict(tc.FALLBACK_STATS)
    wants = {}
    for name in QUERIES:
        t0 = time.perf_counter()
        want = coords["numpy"].execute(plan_for(name),
                                       query_id=f"{name}-numpy").result
        numpy_s = time.perf_counter() - t0
        check_result(name, results[name], want)
        wants[name] = want
        log("query", name=name, rows=results[name].num_rows,
            torch_cold_s=walls[name][0], torch_warm_s=walls[name][1],
            numpy_s=numpy_s, matches_numpy=True)
    log("launches", **launches, fallbacks=fallbacks)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if any(fallbacks.values()):
        raise AssertionError(f"interpreted fallbacks ran: {fallbacks}")
    return launches, {k: r.args for k, r in recorders.items()}, \
        {name: w[1] for name, w in walls.items()}, wants


def query_launches() -> dict:
    return {k: n for k, n in launch_counts().items() if k in QUERY_KERNELS}


def require_launches(phase: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{phase}: {missing} never launched: "
                             f"{launches}")


def serve_queries(store, keys, wants, names=SERVING_QUERIES,
                  interleave=True, srv=None, **server_kw):
    """The multi-query serving path: a ``QueryServer`` on the card (a
    fresh one unless ``srv``) serves ``names`` from two tenants,
    submitted ``SERVING_GAP_S`` apart, each result held against the
    numpy backend's. Returns the server, its report, the host wall of
    ``serve()`` and the launches made inside it."""
    import torch
    from repro_torch.engine import compile as tc
    from repro_torch.serve.query_server import QueryRequest, QueryServer
    if srv is None:
        srv = QueryServer(store, backend="torch", device=DEVICE,
                          worker_budget=SERVING_BUDGET, **server_kw)
        for t, k in keys.items():
            srv.register_table(t, k)
    reqs = [QueryRequest(plan_for(name), tenant=f"tenant{i % 2}",
                         submit_t=SERVING_GAP_S * i)
            for i, name in enumerate(names)]
    tc.PLAN_CACHE.clear()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = srv.serve(reqs, interleave=interleave)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = query_launches()
    if report.failures:
        raise AssertionError(f"query_serving: {report.failures} failed")
    for name, served in zip(names, report.queries):
        check_result(name, served.result.result, wants[name])
    return srv, report, wall, launches


def run_query_serving(store, keys, wants):
    """Phase ``query_serving``: the queries served twice over on one
    shared pool, interleaved and then serially on a new server, with the
    compiled-plan cache counted; the interleaved run again under
    ``torch.profiler`` for the device's idle share; then a server with
    its result cache on replays the repeats with no kernel launch.
    Returns the launches of the two ``serve()`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    total = dict.fromkeys(QUERY_KERNELS, 0)
    walls = {}
    for mode, interleave in (("interleaved", True), ("serial", False)):
        _, rep, wall, launches = serve_queries(
            store, keys, wants, interleave=interleave, result_cache=False)
        require_launches(f"query_serving {mode}", launches, QUERY_KERNELS)
        if (rep.plan_cache_hits, rep.plan_cache_misses) != (4, 4):
            raise AssertionError(
                f"query_serving {mode}: plan cache {rep.plan_cache_hits} "
                f"hits, {rep.plan_cache_misses} misses (want 4, 4)")
        for k in total:
            total[k] += launches[k]
        walls[mode] = wall
        log("query_serving", mode=mode, host_wall_s=wall,
            makespan_s=rep.makespan_s, p50_latency_s=rep.p50_latency_s,
            p99_latency_s=rep.p99_latency_s,
            throughput_qps=rep.throughput_qps,
            plan_cache_hits=rep.plan_cache_hits,
            plan_cache_misses=rep.plan_cache_misses,
            admission=rep.admission, launches=launches,
            latencies_s=[s.latency_s for s in rep.queries],
            matches_numpy=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_queries(store, keys, wants, result_cache=False)
        torch.cuda.synchronize()
    summary = device_summary(prof, walls["interleaved"])
    summary.pop("top_device_kernels_s")
    log("query_serving_profile", mode="interleaved",
        host_wall_s=walls["interleaved"], **summary)
    # The result cache: the first four fill it, the four repeats replay.
    half = len(QUERIES)
    srv, first, _, _ = serve_queries(store, keys, wants,
                                     names=SERVING_QUERIES[:half])
    _, again, wall, launches = serve_queries(
        store, keys, wants, names=SERVING_QUERIES[half:], srv=srv)
    if first.result_cache_hits != 0 or again.result_cache_hits != half:
        raise AssertionError(
            f"query_serving: result cache replayed "
            f"{again.result_cache_hits} of {half} repeats")
    if any(launches.values()):
        raise AssertionError(f"query_serving: replayed results launched "
                             f"kernels: {launches}")
    log("query_serving", mode="result_cache", host_wall_s=wall,
        result_cache_hits=again.result_cache_hits, launches=launches,
        matches_numpy=True)
    return total


def run_adaptive(store, keys, wants):
    """Phase ``adaptive``: Q12 and the duplicate-key join on the
    adaptive coordinator and on the static one, both on the card, under
    the same seeded chaos (dropped shuffle writes, killed fragments,
    slowed ones) on the object store and the KV store, for each seed.
    Every result must be the fault-free numpy backend's and no query may
    fail. Returns the launches of the phase."""
    import dataclasses

    import torch
    from repro_torch.core.chaos import ChaosPolicy
    from repro_torch.engine.adaptive import (ADAPTIVE, STATIC,
                                             AdaptiveCoordinator)
    # The static coordinator re-runs whole stages: one re-run per killed
    # fragment of a stage, so it gets the ladder the reference's
    # ``fault_recovery`` bench gives it.
    static = dataclasses.replace(STATIC, max_recover_attempts=32)
    reset_launch_counts()
    t_phase = time.perf_counter()
    try:
        for seed in ADAPTIVE_SEEDS:
            for tag, policy in (("adaptive", ADAPTIVE),
                                ("static", static)):
                for name in ADAPTIVE_QUERIES:
                    chaos = ChaosPolicy(seed=seed, **CHAOS)
                    store.chaos = chaos     # tables loaded fault-free
                    coord = AdaptiveCoordinator(
                        store, policy=policy, mode="provisioned",
                        backend="torch", device=DEVICE, rng_seed=seed,
                        chaos=chaos)
                    coord.kv_store.chaos = chaos
                    for t, k in keys.items():
                        coord.register_table(t, k)
                    t0 = time.perf_counter()
                    res = coord.execute(plan_for(name),
                                        query_id=f"{name}-{tag}-{seed}")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    if res.failure is not None:
                        raise AssertionError(f"adaptive {name} {tag} "
                                             f"seed {seed}: {res.failure}")
                    check_result(name, res.result, wants[name])
                    log("adaptive", name=name, policy=tag, seed=seed,
                        host_wall_s=wall, runtime_s=res.runtime_s,
                        faas_cost_usd=res.faas_cost_usd,
                        replans=res.replans,
                        speculative_launched=res.speculative_launched,
                        speculative_won=res.speculative_won,
                        trace_lines=len(res.adaptive_trace),
                        faults=chaos.stats(), failure=res.failure,
                        matches_numpy=True)
    finally:
        store.chaos = None
    launches = query_launches()
    require_launches("adaptive", launches, ("probe", "probe_range"))
    log("adaptive_phase", seconds=time.perf_counter() - t_phase,
        launches=launches)
    return launches


def numpy_results(store, keys) -> dict:
    """Each query's result on the numpy backend."""
    from repro_torch.engine.coordinator import Coordinator
    c = Coordinator(store, backend="numpy")
    for t, k in keys.items():
        c.register_table(t, k)
    return {name: c.execute(plan_for(name), query_id=f"{name}-ref").result
            for name in QUERIES}


# Device kernel names of the port's own kernels, as the profiler lists
# them (``probe_range_kernel`` first: it also ends in ``_kernel``).
OWN_KERNELS = (("probe_range", "probe_range_kernel"),
               ("probe", "probe_kernel"),
               ("segment_reduce", "segment_reduce_fold"),
               ("flash_attention", "flash_attention_kernel"),
               ("flash_attention", "flash_attention_wgmma_kernel"),
               ("rglru_scan", "rglru_scan_tma_kernel"),
               ("rglru_scan", "rglru_scan_kernel"),
               ("rwkv6_scan", "rwkv6_scan_tc_kernel"),
               ("rwkv6_scan", "rwkv6_scan_kernel"),
               ("gmm", "gmm_bf16_kernel"),
               ("gmm", "gmm_wgmma_kernel"))


def own_kernel(key: str):
    for name, symbol in OWN_KERNELS:
        if symbol in key:
            return name
    return None


def device_summary(prof, wall_s: float) -> dict:
    """Device kernel and copy time of a ``torch.profiler`` run, each of
    the port's kernels' launches and own device time, and the device's
    idle share of ``wall_s``."""
    from torch.autograd import DeviceType
    kernel_us = copy_us = 0.0
    kernel_n = 0
    own = {kname: [0, 0.0] for kname, _ in OWN_KERNELS}
    top = []
    for evt in prof.key_averages():
        # Only the device's own events: a CPU operator's self device
        # time repeats the time of the kernels it launched.
        if evt.device_type != DeviceType.CUDA:
            continue
        if "Memcpy" in evt.key or "Memset" in evt.key:
            copy_us += evt.self_device_time_total
        else:
            kernel_us += evt.self_device_time_total
            kernel_n += evt.count
            top.append((evt.self_device_time_total / 1e6, evt.count,
                        evt.key[:80]))
            kname = own_kernel(evt.key)
            if kname is not None:
                own[kname][0] += evt.count
                own[kname][1] += evt.self_device_time_total / 1e6
    top.sort(reverse=True)
    return {"device_kernel_s": kernel_us / 1e6, "device_kernels": kernel_n,
            "device_copy_s": copy_us / 1e6,
            "own_kernels": {k: {"launches": n, "device_s": t}
                            for k, (n, t) in own.items() if n},
            "device_idle_share": 1.0 - (kernel_us + copy_us) / 1e6 / wall_s,
            "top_device_kernels_s": [list(t) for t in top[:6]]}


def profile_queries(store, keys, walls):
    """Where a warm query's time goes: device busy time from
    ``torch.profiler`` (kernels and copies) against the warm wall time,
    each of the port's kernels' own device time, and the host functions
    with the most self time under ``cProfile``."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine.coordinator import Coordinator
    c = Coordinator(store, backend="torch", device=DEVICE)
    for t, k in keys.items():
        c.register_table(t, k)
    for name in QUERIES:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            c.execute(plan_for(name), query_id=f"{name}-prof")
            torch.cuda.synchronize()
        pr = cProfile.Profile()
        pr.enable()
        c.execute(plan_for(name), query_id=f"{name}-cprof")
        torch.cuda.synchronize()
        pr.disable()
        st = pstats.Stats(pr)
        top = sorted(st.stats.items(), key=lambda kv: kv[1][2],
                     reverse=True)[:8]
        summary = device_summary(prof, walls[name])
        summary.pop("top_device_kernels_s")
        log("profile", name=name, warm_wall_s=walls[name], **summary,
            host_top_self_s=[[f"{pathlib.Path(f).name}:{ln}:{fn}", v[2]]
                             for (f, ln, fn), v in top])


# ---------------------------------------------------------------------------
# Kernel checks and timings
# ---------------------------------------------------------------------------

def time_spread(fn, batches: int = 5) -> list[float]:
    """Milliseconds per call of ``fn`` in each of ``batches`` CUDA-event
    timings, sorted. After warm-up; a batch holds up to 20 calls, fewer
    for a function that takes longer than half a millisecond."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    iters, per = 20, []
    for _ in range(batches):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / iters)
        iters = max(1, min(20, int(10.0 / max(per[-1], 1e-3))))
    return sorted(per)


def time_ms(fn) -> float:
    """Median of :func:`time_spread`."""
    per = time_spread(fn)
    return per[len(per) // 2]


def kernel_times(kern, plain, lib) -> dict:
    """The kernel's median with its spread, the plain version's and the
    library call's medians."""
    per = time_spread(kern)
    return {"ms": per[len(per) // 2], "ms_min": per[0], "ms_max": per[-1],
            "plain_ms": time_ms(plain), "library_ms": time_ms(lib)}


# Keys of a row of the ``kernels`` line.
ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_probes(recorded, launches):
    import torch
    from repro_torch.kernels import hash_join as hj
    out = []
    for kind in ("probe", "probe_range"):
        (build, keys), kw = recorded[kind]
        table = kw["table"]
        scalars = (table.bias, table.shift)
        n, s = keys.numel(), build.numel()
        if kind == "probe":
            kern = lambda: hj.sorted_probe(build, keys, table=table)  # noqa: E731
            plain = lambda: hj.sorted_probe_plain(build, keys, scalars,  # noqa: E731
                                                  table.starts)
            lib = lambda: torch.searchsorted(build, keys)  # noqa: E731
            out_bytes = 4 + 1
        else:
            kern = lambda: hj.sorted_probe_range(build, keys,  # noqa: E731
                                                 table=table)
            plain = lambda: hj.sorted_probe_range_plain(  # noqa: E731
                build, keys, scalars, table.starts)
            lib = lambda: (torch.searchsorted(build, keys),  # noqa: E731
                           torch.searchsorted(build, keys, right=True))
            out_bytes = 4 + 4 + 1
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{kind}: kernel != plain version")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
        row = {"name": kind, "route": "cuda",
               "source": "src/repro_torch/csrc/hash_join.cu",
               "replaces": ("src/repro/kernels/hash_join.py:93"
                            if kind == "probe"
                            else "src/repro/kernels/hash_join.py:151"),
               "launches": launches[kind], "max_abs_err": float(err),
               "bound_ms": bound_ms((4 + out_bytes) * n),
               "bound_by": "bytes", **kernel_times(kern, plain, lib)}
        log("kernel", **row, n=n, build=s, matched=int(got[-1].sum()))
        out.append({k: row[k] for k in ROW_KEYS})
    return out


def segment_host_device_us(kern, calls: int = 200) -> dict:
    """Where a wrapper call's time goes: host µs a call (``perf_counter``
    over ``calls`` calls enqueued back to back, then one wait), and the
    device µs a call of each kernel and copy it ran (``torch.profiler``
    over ``calls`` more)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        kern()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        kern()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kern()
        torch.cuda.synchronize()
    device = {evt.key[:60]: evt.self_device_time_total / calls
              for evt in prof.key_averages()
              if evt.device_type == DeviceType.CUDA}
    return {"host_us_per_call": host_s / calls * 1e6,
            "device_us_per_call": device}


def check_segment_reduce(recorded, launches):
    """The reduction as the main path calls it, through the groups' host
    row offsets, and through ids (derived on the card), each bit-equal to
    the plain version; in every mode at Q1's shape and at few, many and
    one segment(s) (one 6M-row segment takes three passes in two
    launches). The wrapper must not wait for the card before it returns,
    and the derivation must reject a bad layout."""
    import numpy as np
    import torch
    from repro_torch.kernels import segment_reduce as sr
    (vals,), kw = recorded["segment_reduce"]
    offsets, mode = np.asarray(kw["offsets"]), kw.get("mode", "sum")

    def one(vals, offsets, mode):
        S = len(offsets) - 1
        counts = torch.as_tensor(np.diff(offsets), device=vals.device)
        ids = torch.repeat_interleave(
            torch.arange(S, dtype=torch.int32, device=vals.device), counts)
        kern = lambda: sr.segment_reduce(  # noqa: E731
            vals, offsets=offsets, mode=mode)
        by_ids = lambda: sr.segment_reduce(  # noqa: E731
            vals, ids, num_segments=S, mode=mode)
        plain = lambda: sr.segment_reduce_plain(  # noqa: E731
            vals, ids, S, mode)
        got, got_ids, want = kern(), by_ids(), plain()
        derived = sr.segment_offsets(ids, S)
        if not np.array_equal(derived, offsets):
            raise AssertionError("segment_offsets on the card != offsets")
        exact = np.stack([
            np.add.reduceat(v, offsets[:-1]) if mode == "sum" else
            np.diff(offsets).astype(np.float64) if mode == "count" else
            (np.minimum if mode == "min" else np.maximum).reduceat(
                v, offsets[:-1])
            for v in vals.double().cpu().numpy()])
        if not (torch.equal(got, want) and torch.equal(got_ids, want)):
            raise AssertionError(f"segment_reduce {mode}: kernel != plain")
        g = got.double().cpu().numpy()
        if mode in ("min", "max"):
            np.testing.assert_array_equal(g, exact.astype(np.float32))
        else:
            np.testing.assert_allclose(g, exact, rtol=RTOL)
        c, n = vals.shape
        vt = vals.t().contiguous()
        lib = (lambda: torch.segment_reduce(  # noqa: E731
            vt, "sum" if mode == "count" else mode,
            lengths=counts, axis=0))
        # Bytes the function must move: the valid rows' values once
        # (none in count mode, which reads no values), the offsets, one
        # float32 result per (column, segment).
        value_bytes = 0 if mode == "count" else 4 * c * int(offsets[-1])
        per_ids = time_spread(by_ids)
        launches0 = sr.SEGMENT_REDUCE_LAUNCHES
        kern()
        per_call = sr.SEGMENT_REDUCE_LAUNCHES - launches0
        return {"max_abs_err": float((got - want).abs().max()),
                "max_rel_err_f64": float((np.abs(g - exact)
                                          / np.abs(exact)).max()),
                "bound_ms": bound_ms(8 * (S + 1) + value_bytes + 4 * c * S),
                "bound_by": "bytes", **kernel_times(kern, plain, lib),
                "ids_ms": per_ids[len(per_ids) // 2], "ids_ms_min": per_ids[0],
                "ids_ms_max": per_ids[-1],
                "passes": len(sr.reduction_passes(offsets)),
                "launches_per_call": per_call}

    main = one(vals, offsets, mode)
    kern = lambda: sr.segment_reduce(  # noqa: E731
        vals, offsets=offsets, mode=mode)
    # No wait for the card inside the call: synchronising operations
    # raise in this mode.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kern()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    split = segment_host_device_us(kern)
    row = {"name": "segment_reduce", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_reduce.cu",
           "replaces": "src/repro/kernels/segment_reduce.py:43",
           "launches": launches["segment_reduce"], **main}
    log("kernel", **row, columns=vals.shape[0], n=vals.shape[1],
        segments=len(offsets) - 1, mode=mode, entry="offsets",
        syncs_before_result=0,
        offsets_derivations=sr.SEGMENT_OFFSETS_LAUNCHES, **split)
    bad = torch.tensor([0, 2, 1], dtype=torch.int32, device=vals.device)
    try:
        sr.segment_offsets(bad, 3)
    except ValueError:
        pass
    else:
        raise AssertionError("segment_offsets took descending ids")
    # Q1's stack of five sum columns at the query's row count, against
    # few, many and one segment(s), and segments of under 1024 rows (one
    # pass), in every mode.
    n = vals.shape[1]
    rng = np.random.default_rng(0)
    q1 = torch.as_tensor(np.round(rng.uniform(1.0, 1000.0, (5, n)), 2),
                         dtype=torch.float32, device=vals.device)
    for S in (4, 1024, 1, 8192):
        offs = np.searchsorted(np.sort(rng.integers(0, S, n)),
                               np.arange(S + 1)).astype(np.int64)
        for m in ("sum", "count", "min", "max"):
            log("kernel_sweep", name="segment_reduce", columns=5, n=n,
                segments=S, mode=m, **one(q1, offs, m))
    return [{k: row[k] for k in ROW_KEYS}]


# ---------------------------------------------------------------------------
# LLM serving: RecurrentGemma-2B through ServingEngine
# ---------------------------------------------------------------------------

class Timed:
    """Wraps a step function: host seconds of each call, the device
    synchronised on both sides."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, []

    def __call__(self, *args, **kwargs):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def serve_requests(vocab: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SERVE_SEED)
    lengths = rng.integers(SERVE_MIN_PROMPT, SERVE_PROMPT + 1,
                           SERVE_REQUESTS)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=SERVE_NEW_TOKENS)
            for i, n in enumerate(lengths)]


def run_serving(arch: str):
    """The serving main path of ``arch``: build the engine on its kernel
    route, answer the requests, read the launch counts of ``serve``
    alone."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServingEngine
    cfg = ARCHS[arch]
    impl, kernels = SERVINGS[arch]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN,
                        seed=SERVE_SEED, impl=impl, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kinds = [layer.kind for layer in eng.model.layers]
    log("serve_init", arch=cfg.name, seconds=init_s,
        parameters=tfm.param_count(eng.model),
        parameter_bytes=sum(p.numel() * p.element_size()
                            for p in eng.model.parameters()),
        dtype=str(cfg.activation_dtype), layers=len(kinds),
        layer_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        impl=impl)
    reqs = serve_requests(cfg.vocab_size)
    prefill, decode = Timed(eng.prefill), Timed(eng.decode)
    eng.prefill, eng.decode = prefill, decode
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()                      # the main path: counts at 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()                 # ... read just after
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated()
    eng.prefill, eng.decode = prefill.fn, decode.fn
    for r in done:
        c = r.completion
        if c is None or c.shape != (SERVE_NEW_TOKENS,) or c.min() < 0 \
                or c.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch} request {r.request_id}: bad "
                                 f"completion {c}")
    if sorted(r.request_id for r in done) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"{arch}: not every request was answered")
    batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    dec = sorted(decode.seconds)
    new_tokens = sum(len(r.completion) for r in done)
    log("serve_requests", arch=arch, requests=SERVE_REQUESTS,
        batches=batches, prompt_tokens=[len(r.prompt) for r in reqs],
        padded_prompt_tokens=SERVE_PROMPT, new_tokens=new_tokens,
        wall_s=wall, latency_s=[r.latency_s for r in done])
    log("serve_prefill", arch=arch, seconds_per_batch=prefill.seconds,
        prefill_tokens_per_s=[SERVE_BATCH * SERVE_PROMPT / t
                              for t in prefill.seconds])
    log("serve_decode", arch=arch, steps=len(dec),
        step_ms_median=dec[len(dec) // 2] * 1e3, step_ms_min=dec[0] * 1e3,
        step_ms_max=dec[-1] * 1e3,
        step_ms_p90=dec[int(0.9 * (len(dec) - 1))] * 1e3)
    log("serve_throughput", arch=arch, new_tokens_per_s=new_tokens / wall,
        requests_per_s=SERVE_REQUESTS / wall)
    log("serve_memory", arch=arch, max_memory_allocated=peak,
        max_memory_allocated_gib=peak / 2**30)
    log("serve_launches", arch=arch, **launches, **routes)
    log("serve_cost", arch=arch, **eng.cost_report(wall, len(done)))
    want = {k: kinds.count(kind) * per * batches
            for k, (kind, per) in kernels.items()}
    for k, n in want.items():
        if launches[k] == 0 or launches[k] != n:
            raise AssertionError(f"{arch}: {k} launched {launches[k]} times "
                                 f"in serve, expected {n}")
    if any(launches[k] for k in launches if k not in want):
        raise AssertionError(f"{arch}: other kernels launched in serve: "
                             f"{launches}")
    for k in want:
        if k in TC_ROUTES and routes[TC_ROUTES[k]] != launches[k]:
            raise AssertionError(f"{arch}: {routes[TC_ROUTES[k]]} of "
                                 f"{launches[k]} {k} launches took the "
                                 f"route {TC_ROUTES[k]}")
    first = np.asarray([r.completion[0] for r in done[:SERVE_BATCH]])
    return eng, reqs, {**launches, **routes}, first


def _recorders(arch: str) -> dict:
    """Recorders of the inputs of ``arch``'s kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rs
    first = lambda a: a[0].numel()  # noqa: E731
    made = {"flash_attention": lambda: Recorder(fa, "flash_attention", first),
            "rglru_scan": lambda: Recorder(rg, "rglru_scan", first),
            "rwkv6_scan": lambda: Recorder(rs, "rwkv6_scan", first),
            "gmm": lambda: Recorder(mg, "gmm", first, by_shape=True)}
    return {k: made[k]() for k in SERVINGS[arch][1]}


class RouteLog:
    """Records the top-k expert choices of every MoE layer's router; with
    ``replay``, makes each layer choose the experts recorded there (its
    gates are its own router's probabilities at those experts)."""

    def __init__(self, replay=None):
        from repro_torch.models import moe
        self.module, self.orig, self.idx = moe, moe._route, []
        self.replay = list(replay) if replay is not None else None
        moe._route = self

    def __call__(self, params, x2d, mo, norm_topk):
        import torch
        if self.replay is None:
            gates, idx, aux = self.orig(params, x2d, mo, norm_topk)
        else:
            _, _, aux = self.orig(params, x2d, mo, norm_topk)
            idx = self.replay.pop(0)
            probs = torch.softmax(x2d.float() @ params["w_router"].float(),
                                  dim=-1)
            gates = probs.gather(-1, idx)
            if norm_topk:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        self.idx.append(idx)
        return gates, idx, aux

    def restore(self):
        self.module._route = self.orig

    def differing(self, other) -> list[int]:
        """Per layer, the (token, choice) pairs whose sorted top-k sets
        differ from ``other``'s."""
        return [int((a.sort(-1).values != b.sort(-1).values).sum())
                for a, b in zip(self.idx, other.idx)]


def prefill_logits(eng, toks, cfg=None, impl=None, replay=None,
                   model=None):
    """The first batch's last-token logits of one prefill of ``model``
    (the engine's by default) on ``impl`` (the model's kernel route by
    default); with ``replay``, the MoE layers take the recorded expert
    choices."""
    from repro_torch.launch.steps import make_prefill_step
    cfg = cfg or eng.cfg
    step = make_prefill_step(cfg, cache_len=SERVE_MAX_LEN,
                             impl=impl or SERVINGS[eng.cfg.name][0])
    routes = RouteLog(replay) if replay is not None else None
    try:
        return step(eng.model if model is None else model,
                    {"tokens": toks})[0]
    finally:
        if routes is not None:
            routes.restore()


def check_serving_reference(eng, reqs, first_tokens):
    """The first batch's prefill again on the kernel route (keeping each
    kernel's inputs) and on the reference route: last-token logits within
    the model's ``LOGIT_TOL``, and the same first greedy token wherever
    the reference's top-1/top-2 gap exceeds twice the largest difference.
    For an MoE model, how many top-k expert choices the routes differ in.
    Returns the recorded kernel inputs, the tokens, and the failed checks
    (which ``main`` raises after the remaining phases)."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_prefill_step
    arch = eng.cfg.name
    tol = LOGIT_TOL[arch]
    toks = eng._batch_prompts(reqs[:SERVE_BATCH])
    routes = {"kernel": RouteLog()} if eng.cfg.moe else {}
    recorders = _recorders(arch)
    try:
        kern_logits, _ = eng.prefill(eng.model, {"tokens": toks})
        torch.cuda.synchronize()
    finally:
        for r in recorders.values():
            r.restore()
        for r in routes.values():
            r.restore()
    ref_step = make_prefill_step(eng.cfg, cache_len=SERVE_MAX_LEN,
                                 impl="reference")
    if eng.cfg.moe:
        routes["reference"] = RouteLog()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ref_logits, _ = ref_step(eng.model, {"tokens": toks})
        torch.cuda.synchronize()
    finally:
        if "reference" in routes:
            routes["reference"].restore()
    ref_s = time.perf_counter() - t0
    diff = float((kern_logits - ref_logits).abs().max())
    top2 = ref_logits.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    tok_k = kern_logits.argmax(-1).cpu().numpy()
    tok_r = ref_logits.argmax(-1).cpu().numpy()
    decided = gap > 2 * diff
    extra = {}
    if routes:
        differ = routes["kernel"].differing(routes["reference"])
        extra = {"moe_layers": len(differ),
                 "expert_choices_per_layer": int(
                     routes["kernel"].idx[0].numel()),
                 "expert_choices_differing": sum(differ),
                 "expert_choices_differing_per_layer": differ}
        if sum(differ):
            # A flipped choice moves the logits by more than rounding: hold
            # the reference route to the kernel route's choices instead.
            ref_logits = prefill_logits(eng, toks, impl="reference",
                                        replay=routes["kernel"].idx)
            diff = float((kern_logits - ref_logits).abs().max())
            top2 = ref_logits.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            tok_r = ref_logits.argmax(-1).cpu().numpy()
            decided = gap > 2 * diff
            extra["same_experts_max_abs_logit_diff"] = diff
    log("serve_reference", arch=arch, max_abs_logit_diff=diff,
        tolerance=tol, logit_std=float(ref_logits.std()),
        first_token_kernel=tok_k.tolist(),
        first_token_reference=tok_r.tolist(),
        first_token_served=first_tokens.tolist(),
        top1_top2_gap=gap.tolist(), decided=decided.tolist(),
        reference_prefill_s=ref_s, **extra)
    if not (torch.isfinite(kern_logits).all()
            and torch.isfinite(ref_logits).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    if kern_logits.shape != (SERVE_BATCH, eng.cfg.vocab_size):
        raise AssertionError(f"{arch}: logits shape "
                             f"{tuple(kern_logits.shape)}")
    log_controls(eng, toks, kern_logits, ref_logits,
                 routes["kernel"].idx if routes else None)
    # Read at the end of the run, after every phase has logged.
    failures = []
    if not diff <= tol:
        failures.append(f"{arch}: kernel vs reference logits differ by "
                        f"{diff} > {tol}")
    if np.any(decided & (tok_k != tok_r)):
        failures.append(f"{arch}: the first greedy token differs where the "
                        "reference's margin decides it")
    if arch in F32_LOGIT_TOL:
        failures += check_float32_logits(eng, toks)
    return {k: r.args if r.shapes is None else r.shapes
            for k, r in recorders.items()}, toks, failures


def check_float32_logits(eng, toks) -> list[str]:
    """The first batch's prefill again with the model widened to float32
    (the same weights) on the kernel route (the float32 kernels) and the
    reference route: last-token logits within the model's
    ``F32_LOGIT_TOL``, and every planted fault of ``log_controls``, run
    in float32 too, beyond it. Returns the failed checks."""
    import copy
    import dataclasses
    import torch
    arch = eng.cfg.name
    tol = F32_LOGIT_TOL[arch]
    cfg = dataclasses.replace(eng.cfg, dtype="float32")
    model = copy.deepcopy(eng.model).float()
    kern = prefill_logits(eng, toks, cfg, model=model)
    ref = prefill_logits(eng, toks, cfg, "reference", model=model)
    diff = float((kern - ref).abs().max())
    log("serve_reference_float32", arch=arch, max_abs_logit_diff=diff,
        tolerance=tol, logit_std=float(ref.std()))
    readings = log_controls(eng, toks, kern, ref, cfg=cfg, model=model,
                            tol=tol)
    del model, kern, ref
    torch.cuda.empty_cache()
    failures = []
    if not diff <= tol:
        failures.append(f"{arch}: float32 kernel vs reference logits "
                        f"differ by {diff} > {tol}")
    unseen = {name: r["vs_reference"] for name, r in readings.items()
              if not name.startswith("sound_") and r["vs_reference"] <= tol}
    if unseen:
        failures.append(f"{arch}: the float32 logit check missed planted "
                        f"faults {unseen}")
    return failures


class replaced:
    """Within the block, ``module.name`` is ``wrap(original)``."""

    def __init__(self, module, name, wrap):
        self.module, self.name, self.wrap = module, name, wrap

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.wrap(self.orig))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def log_controls(eng, toks, kern_logits, ref_logits, experts=None,
                 cfg=None, model=None, tol=None) -> dict:
    """What the logit check sees: the first batch's prefill (of ``model``
    under ``cfg``, the engine's by default) with a planted fault, or on
    another sound route (names starting ``sound_``, which only round
    differently), each held against both routes; returns the readings.
    RecurrentGemma-2B: the window edge one key wider, the window dropped,
    the RG-LRU decays rounded to bf16. RWKV-6: the reference route with
    32-step chunks (sound), the scan's decays rounded to bf16, log_w
    doubled. DeepSeekMoE: the flash-attention route (sound), and expert
    0's output of every grouped matmul zeroed, each also with the kernel
    route's expert choices (``experts``) replayed."""
    import dataclasses
    import torch
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rs
    cfg = cfg or eng.cfg
    prefill = lambda c=None, impl=None, replay=None: prefill_logits(  # noqa: E731
        eng, toks, c or cfg, impl, replay, model)
    bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    out = {}
    if cfg.name == "recurrentgemma-2b":
        out["window_plus_one"] = prefill(dataclasses.replace(
            cfg, window=cfg.window + 1))
        out["no_window"] = prefill(dataclasses.replace(cfg, window=0))
        with replaced(rg, "rglru_scan", lambda f: lambda la, b, h0: f(
                bf16(la), b, h0)):
            out["bf16_decays"] = prefill()
    elif cfg.name == "rwkv6-1.6b":
        out["sound_reference_chunk_32"] = prefill(dataclasses.replace(
            cfg, recurrent=dataclasses.replace(cfg.recurrent, chunk=32)),
            "reference")
        with replaced(rs, "rwkv6_scan", lambda f: lambda r, k, v, lw, u, s0,
                      **kw: f(r, k, v, bf16(lw), u, s0, **kw)):
            out["bf16_decays"] = prefill()
        with replaced(rs, "rwkv6_scan", lambda f: lambda r, k, v, lw, u, s0,
                      **kw: f(r, k, v, 2 * lw, u, s0, **kw)):
            out["log_w_doubled"] = prefill()
    elif cfg.name == "deepseek-moe-16b":
        out["sound_flash_attention_route"] = prefill(impl="flash")
        out["sound_flash_attention_route_same_experts"] = prefill(
            impl="flash", replay=experts)

        def zero_expert_0(f):
            def gmm(x, w):
                y = f(x, w)
                y[0] = 0
                return y
            return gmm
        with replaced(mg, "gmm", zero_expert_0):
            out["expert_0_zeroed"] = prefill()
            out["expert_0_zeroed_same_experts"] = prefill(replay=experts)
    readings = {name: {"vs_reference": float((x - ref_logits).abs().max()),
                       "vs_kernel_route": float((x - kern_logits).abs().max())}
                for name, x in out.items()}
    log("serve_controls", arch=cfg.name, dtype=cfg.dtype,
        tolerance=LOGIT_TOL[cfg.name] if tol is None else tol, **readings)
    return readings


def profile_serving(eng, toks):
    """One prefill and one decode step under ``torch.profiler``: device
    idle share and each kernel's own device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = eng.prefill(eng.model, {"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log("serve_profile", arch=eng.cfg.name, step="prefill", wall_s=wall,
        **device_summary(prof, wall))
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    eng.decode(eng.model, nxt, caches, SERVE_PROMPT)       # warm
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.decode(eng.model, nxt, caches, SERVE_PROMPT + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log("serve_profile", arch=eng.cfg.name, step="decode", wall_s=wall,
        **device_summary(prof, wall))


def within(got, want, tol) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol*|want|
    everywhere (and both are finite)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()
            and (err <= tol + tol * w.abs()).all()):
        raise AssertionError(f"kernel vs plain: max |diff| "
                             f"{float(err.max())} beyond tol {tol}")
    return float(err.max())


def band_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs inside the causal / window band."""
    total = 0
    for qp in range(sq):
        hi = min(skv, qp + 1) if causal else skv
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def check_flash(recorded, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    (q, k, v), kw = recorded["flash_attention"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    bf16 = dict(dtype=torch.bfloat16, device=DEVICE, generator=gen)

    def model_shape(shape):
        (mb, ms, mh, md), mhkv = shape
        return (torch.randn((mb, ms, mh, md), **bf16),
                torch.randn((mb, ms, mhkv, md), **bf16),
                torch.randn((mb, ms, mhkv, md), **bf16), True, 0)

    cases = [("serve", q, k, v, kw.get("causal", True), kw.get("window", 0)),
             ("internlm2_shape", *model_shape(INTERNLM2_ATTN)),
             ("musicgen_shape", *model_shape(MUSICGEN_ATTN))]
    rows = []
    for case, q, k, v, causal, window in cases:
        b, sq, h, d = q.shape
        skv = k.shape[1]
        kern = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                          window=window)
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q, k, v, causal=causal, window=window)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window:
            qp = torch.arange(sq, device=DEVICE)[:, None]
            kp = torch.arange(skv, device=DEVICE)[None, :]
            band = (kp <= qp) & (kp > qp - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        tc0 = fa.FLASH_ATTENTION_TC_LAUNCHES
        got = kern()
        if fa.FLASH_ATTENTION_TC_LAUNCHES != tc0 + 1:
            raise AssertionError(f"flash attention {case}: bf16 at D = {d} "
                                 "did not take the tensor-core route")
        want = plain()
        torch.cuda.synchronize()
        err = within(got, want, BF16_TOL)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        tight = check_flash_f32(q, k, v, got, causal, window)
        pairs = band_pairs(sq, skv, causal, window)
        flops = 4.0 * b * h * d * pairs
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) \
            * q.element_size()
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, bound_ms(nbytes)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
               "replaces": "src/repro/kernels/flash_attention.py:22",
               "launches": launches["flash_attention"], "max_abs_err": err,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               **kernel_times(kern, plain, lib)}
        log("kernel" if case == "serve" else "kernel_sweep", **row,
            case=case, shape=[b, sq, h, d], kv_heads=k.shape[2],
            causal=causal, window=window, band_pairs=pairs,
            flops=flops, bytes=nbytes, library_max_abs_err=lib_err,
            kernel_route=fa._route(q.dtype, d),
            tflops_per_s=flops / row["ms"] / 1e9, **tight)
        if case == "serve":
            rows.append({key: row[key] for key in ROW_KEYS})
    return rows


def check_flash_f32(q, k, v, got, causal, window) -> dict:
    """The kernel in float32 on q, k, v widened (exactly) to float32,
    against the plain version in float32, and the bf16 result ``got``
    against that float32 result; for a window, what the same comparison
    reads when the window edge is one key off."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    qf, kf, vf = q.float(), k.float(), v.float()
    want = fa.flash_attention_plain(qf, kf, vf, causal=causal, window=window)
    f32 = fa.flash_attention(qf, kf, vf, causal=causal, window=window)
    f32_err = float((f32 - want).abs().max())
    del f32
    err = (got.float() - want).abs()
    bf16_err = float(err.max())
    bf16_excess = float((err - BF16_ROUND * want.abs()).max())
    del err
    out = {"f32_max_abs_err": f32_err, "f32_tol": F32_ATTN_TOL,
           "bf16_vs_f32_max_abs_err": bf16_err,
           "bf16_vs_f32_excess_over_rounding": bf16_excess,
           "output_rms": float(want.square().mean().sqrt())}
    if window:
        off = fa.flash_attention_plain(qf, kf, vf, causal=causal,
                                       window=window + 1)
        out["control_window_plus_one_max_abs_diff"] = float(
            (off - want).abs().max())
        del off
    torch.cuda.synchronize()
    if not (f32_err <= F32_ATTN_TOL and bf16_excess <= F32_ATTN_TOL):
        raise AssertionError(f"flash attention against float32: {out}")
    return out


def rglru_truth(log_a, b_in, h0):
    """The RG-LRU recurrence stepped in float64, and the same recurrence
    on absolute values: for each h, the size of the terms it sums.
    Returns (h_all, h_last, mag_all, mag_last)."""
    import torch
    a, bb = torch.exp(log_a.double()), b_in.double()
    h, m = h0.double(), h0.double().abs()
    out, mag = torch.empty_like(a), torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bb[:, t]
        m = a[:, t] * m + bb[:, t].abs()
        out[:, t], mag[:, t] = h, m
    return out, h, mag, m


def check_rglru(recorded, launches):
    """The RG-LRU scan against its plain version (the step oracle) within
    ``SCAN_TOL``, every case on the TMA route: at the serving shape (and
    there also on the seq route, timed beside it), at a strong decay
    (log_a = -40, h0 = 1e6), at near-one decays (log_a in [-1e-4, 0], h0
    near 0: each h sums some 4,096 terms), where both are also held
    against the recurrence stepped in float64 and a planted fault (the
    plain version with the first step of every stage dropped) must fail
    both checks, at a ragged shape and at one batch row."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    (log_a, b_in, h0), _ = recorded["rglru_scan"]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    f32 = dict(dtype=torch.float32, device=DEVICE, generator=gen)
    shape = log_a.shape
    cases = [("serve", log_a, b_in, h0),
             ("strong_decay", torch.full_like(log_a, -40.0),
              torch.randn(shape, **f32), torch.full_like(h0, 1e6)),
             ("near_one", torch.rand(shape, **f32) * -1e-4,
              torch.randn(shape, **f32), torch.randn(h0.shape, **f32) * 1e-3),
             ("ragged", -torch.exp(torch.randn(RGLRU_RAGGED, **f32)),
              torch.randn(RGLRU_RAGGED, **f32),
              torch.randn((RGLRU_RAGGED[0], RGLRU_RAGGED[2]), **f32)),
             ("b1", log_a[:1].contiguous(), b_in[:1].contiguous(),
              h0[:1].contiguous())]
    rows = []
    for case, la, bb, hh in cases:
        b, s, w = la.shape
        kern = lambda: rg.rglru_scan(la, bb, hh)  # noqa: E731
        plain = lambda: rg.rglru_scan_plain(la, bb, hh)  # noqa: E731
        n0 = rg.RGLRU_SCAN_TMA_LAUNCHES
        (g_all, g_last), (w_all, w_last) = kern(), plain()
        torch.cuda.synchronize()
        if rg.RGLRU_SCAN_TMA_LAUNCHES != n0 + 1:
            raise AssertionError(f"rglru_scan: the {case} case did not take "
                                 "the TMA route")
        err = max(within(g_all, w_all, SCAN_TOL),
                  within(g_last, w_last, SCAN_TOL))
        extra = {"bit_equal": bool(torch.equal(g_all, w_all)
                                   and torch.equal(g_last, w_last))}
        if case == "near_one":
            extra.update(check_rglru_near_one(rg, la, bb, hh, g_all, g_last,
                                              w_all, w_last))
        del g_all, g_last
        if case == "serve":
            with replaced(rg, "_route", lambda f: lambda *a: "seq"):
                q_all, q_last = kern()
                torch.cuda.synchronize()
                if rg.RGLRU_SCAN_TMA_LAUNCHES != n0 + 1:
                    raise AssertionError("rglru_scan: the seq route took the "
                                         "TMA kernel")
                extra["seq_route_max_abs_err"] = max(
                    within(q_all, w_all, SCAN_TOL),
                    within(q_last, w_last, SCAN_TOL))
                del q_all, q_last
                seq_per = time_spread(kern)
            extra.update(seq_route_ms=seq_per[len(seq_per) // 2],
                         seq_route_ms_min=seq_per[0],
                         seq_route_ms_max=seq_per[-1])
        del w_all, w_last
        per = time_spread(kern)
        row = {"name": "rglru_scan", "route": "cuda",
               "source": "src/repro_torch/csrc/rglru_scan_tma.cu",
               "replaces": "src/repro/kernels/rglru_scan.py:21",
               "launches": launches["rglru_scan"], "max_abs_err": err,
               "ms": per[len(per) // 2], "ms_min": per[0],
               "ms_max": per[-1], "plain_ms": time_ms(plain),
               "bound_ms": bound_ms(4 * (3 * b * s * w + 2 * b * w)),
               "bound_by": "bytes", "library_ms": None}
        log("kernel" if case == "serve" else "kernel_sweep", **row,
            case=case, shape=[b, s, w], kernel_route=rg._route(s, w),
            tma_launches=launches["rglru_scan_tma"],
            plan=rg._plan(b, s, w, sms=rg._sms(la.device.index))._asdict(),
            log_a_range=[float(la.min()), float(la.max())], **extra)
        if case == "serve":
            rows.append({key: row[key] for key in ROW_KEYS})
    return rows


def check_rglru_near_one(rg, la, bb, hh, g_all, g_last, w_all, w_last):
    """At near-one decays: the kernel (g) and the plain version (w) each
    against the recurrence stepped in float64 within ``SCAN_TOL`` of the
    value plus ``SCAN_TOL`` of the summed terms' size (float32 rounds each
    term by 2^-24 of its size), and a planted fault that must fail both
    that check and the check against the plain version: the plain version
    with the first step of every stage of the TMA ring (log_a = 0, b = 0
    there) dropped."""
    t_all, t_last, m_all, m_last = rglru_truth(la, bb, hh)
    out = {}
    for who, (x_all, x_last) in (("kernel", (g_all, g_last)),
                                 ("plain", (w_all, w_last))):
        out[f"{who}_vs_float64_max_abs_err"] = max(
            within_scan(x_all, t_all, m_all, SCAN_TOL, SCAN_TOL,
                        "rglru_scan"),
            within_scan(x_last, t_last, m_last, SCAN_TOL, SCAN_TOL,
                        "rglru_scan"))
    la_f, bb_f = la.clone(), bb.clone()
    la_f[:, ::rg.STEPS] = 0.0
    bb_f[:, ::rg.STEPS] = 0.0
    f_all, _ = rg.rglru_scan_plain(la_f, bb_f, hh)
    if not (fails_check(lambda: within(f_all, w_all, SCAN_TOL))
            and fails_check(lambda: within_scan(
                f_all, t_all, m_all, SCAN_TOL, SCAN_TOL, "rglru_scan"))):
        raise AssertionError("rglru_scan: the near-one checks do not see the "
                             "steps at stage boundaries dropped")
    out.update(planted_stage_boundary_max_abs_diff=float(
        (f_all - w_all).abs().max()), planted_seen=True,
        output_max=float(t_all.abs().max()), term_size_max=float(m_all.max()))
    return out


def fails_check(fn) -> bool:
    """Whether ``fn`` (a ``within`` check) raises."""
    try:
        fn()
    except AssertionError:
        return True
    return False


def rwkv6_truth(r, k, v, log_w, u, s0):
    """The WKV recurrence stepped in float64, and the same recurrence on
    absolute values: for each output and final state entry, the size of
    the terms it sums. Returns (o, s_final, o_mag, s_mag)."""
    import torch
    rd, kd, vd = r.double(), k.double(), v.double()
    w = torch.exp(log_w.double())
    uu = u.double()[None, :, :, None]
    s, m = s0.double(), s0.double().abs()
    out, mag = [], []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kd[:, t], vd[:, t])
        out.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], s + uu * kv))
        mag.append(torch.einsum("bhk,bhkv->bhv", rd[:, t].abs(),
                                m + (uu * kv).abs()))
        s = s * w[:, t, ..., None] + kv
        m = m * w[:, t, ..., None] + kv.abs()
    return torch.stack(out, 1), s, torch.stack(mag, 1), m


def within_scan(got, want, mag, rel, tol=RWKV_TOL,
                what="rwkv6_scan") -> float:
    """Max |got - want|; raises unless |got - want| <= rel*|want| +
    tol*mag everywhere (and both are finite). A scan output sums terms up
    to twice its own size and more where they cancel, and float32 errors
    scale with the terms, so the absolute part of the bound scales with
    ``mag``, the size of the terms (``rwkv6_truth``, ``rglru_truth``)."""
    import torch
    g, w = got.double(), want.double()
    err = (g - w).abs()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()
            and (err <= rel * w.abs() + tol * mag).all()):
        worst = int((err - rel * w.abs() - tol * mag).argmax())
        raise AssertionError(
            f"{what}: max |diff| {float(err.max())}; worst at value "
            f"{float(w.flatten()[worst])}, terms of size "
            f"{float(mag.flatten()[worst])}, beyond {rel}*|value| + "
            f"{tol}*size")
    return float(err.max())


def check_rwkv6(recorded, launches):
    """The RWKV-6 scan at the serving shape against its plain version
    (the chunked oracle), and both, as float32 kernels too, against the
    recurrence stepped in float64; then at a strong decay (log_w = -6, a
    decay mass of 384 per 64 steps) against the step oracle, where the
    same check must see a planted fault (the bonus u dropped); then at a
    ragged length. Errors are bounded by a relative part and a part
    scaled by the size of the summed terms (``within_scan``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    (r, k, v, lw, u, s0), kw = recorded["rwkv6_scan"]
    b, s, h, kd = r.shape
    vd = v.shape[3]
    kern = lambda: rs.rwkv6_scan(r, k, v, lw, u, s0)  # noqa: E731
    plain = lambda: rs.rwkv6_scan_plain(r, k, v, lw, u, s0, **kw)  # noqa: E731
    tc0 = rs.RWKV6_SCAN_TC_LAUNCHES
    (g_o, g_s), (w_o, w_s) = kern(), plain()
    t_o, t_s, o_mag, s_mag = rwkv6_truth(r, k, v, lw, u, s0)
    o_mag_serve, s_mag_serve = o_mag, s_mag
    torch.cuda.synchronize()
    err = within_scan(g_o, w_o, o_mag, BF16_TOL)
    state_err = within_scan(g_s, w_s, s_mag, 0.0)
    # Against float64 truth: the bf16 outputs within one rounding, the
    # float32 outputs and states within the scaled part alone.
    truth = {"kernel_bf16": within_scan(g_o, t_o, o_mag, BF16_ROUND),
             "plain_bf16": within_scan(w_o, t_o, o_mag, BF16_ROUND),
             "kernel_state": within_scan(g_s, t_s, s_mag, 0.0),
             "plain_state": within_scan(w_s, t_s, s_mag, 0.0)}
    rf, kf, vf = r.float(), k.float(), v.float()
    f_o, f_s = rs.rwkv6_scan(rf, kf, vf, lw, u, s0)
    p_o, p_s = rs.rwkv6_scan_plain(rf, kf, vf, lw, u, s0, **kw)
    truth["kernel_f32"] = within_scan(f_o, t_o, o_mag, 0.0)
    truth["plain_f32"] = within_scan(p_o, t_o, o_mag, 0.0)
    size = o_mag.clamp_min(1e-300)
    truth["kernel_f32_over_size"] = float(((f_o - t_o).abs() / size).max())
    truth["plain_f32_over_size"] = float(((p_o - t_o).abs() / size).max())
    value_max, size_max = float(t_o.abs().max()), float(o_mag.max())
    del rf, kf, vf, f_o, f_s, p_o, p_s, t_o, t_s, o_mag, s_mag, size
    # Strong decay, random u: where the factorized TPU form overflows.
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    f32 = dict(dtype=torch.float32, device=DEVICE, generator=gen)
    sr, sk, sv = (torch.randn(r.shape, **f32) * 0.5 for _ in range(3))
    slw = torch.full(lw.shape, -6.0, dtype=torch.float32, device=DEVICE)
    su = torch.randn(u.shape, **f32) * 0.3
    ss0 = torch.randn(s0.shape, **f32) * 0.1
    st_o, st_s = rs.rwkv6_scan(sr, sk, sv, slw, su, ss0)
    st_wo, st_ws = ref.rwkv6_step_ref(sr, sk, sv, slw, su, ss0)
    _, _, st_mag, st_smag = rwkv6_truth(sr, sk, sv, slw, su, ss0)
    torch.cuda.synchronize()
    strong_err = max(within_scan(st_o, st_wo, st_mag, RWKV_TOL),
                     within_scan(st_s, st_ws, st_smag, RWKV_TOL))
    no_u, _ = rs.rwkv6_scan(sr, sk, sv, slw, torch.zeros_like(su), ss0)
    planted = float((no_u - st_wo).abs().max())
    if not fails_check(lambda: within_scan(no_u, st_wo, st_mag, RWKV_TOL)):
        raise AssertionError("rwkv6_scan: the check missed the planted "
                             f"fault (u dropped, max |diff| {planted})")
    del sr, sk, sv, slw, st_o, st_s, st_wo, st_ws, st_mag, st_smag, no_u
    # A ragged length: no whole number of 64-step chunks.
    rr, rk, rv = (torch.randn((2, 1000, 3, kd), **f32) for _ in range(3))
    rlw = -torch.exp(torch.randn((2, 1000, 3, kd), **f32) - 2.0)
    ru, rs0 = su[:3].contiguous(), ss0[:2, :3].contiguous()
    ro, rst = rs.rwkv6_scan(rr, rk, rv, rlw, ru, rs0)
    rwo, rws = ref.rwkv6_step_ref(rr, rk, rv, rlw, ru, rs0)
    _, _, r_mag, r_smag = rwkv6_truth(rr, rk, rv, rlw, ru, rs0)
    ragged_err = max(within_scan(ro, rwo, r_mag, RWKV_TOL),
                     within_scan(rst, rws, r_smag, RWKV_TOL))
    # Extreme decay: a fifth of the steps near log_w = -60, the rest near
    # -1e-3, mixed within each chunk; no exp(-incl) form survives a step.
    xr, xk, xv = (torch.randn((2, 1000, 3, kd), **f32) for _ in range(3))
    big = torch.rand((2, 1000, 3, kd), **f32) < 0.2
    xlw = torch.where(big, -60.0 + torch.randn(big.shape, **f32),
                      -1e-3 * torch.rand(big.shape, **f32))
    xo, xst = rs.rwkv6_scan(xr, xk, xv, xlw, ru, rs0)
    xwo, xws = ref.rwkv6_step_ref(xr, xk, xv, xlw, ru, rs0)
    _, _, x_mag, x_smag = rwkv6_truth(xr, xk, xv, xlw, ru, rs0)
    extreme_err = max(within_scan(xo, xwo, x_mag, RWKV_TOL),
                      within_scan(xst, xws, x_smag, RWKV_TOL))
    # Every call above ran on the tensor-core route (K = V = 64): the
    # serving call, the float32 one, the strong decay with its planted
    # fault, the ragged length and the extreme decay.
    if rs.RWKV6_SCAN_TC_LAUNCHES - tc0 != 6:
        raise AssertionError(f"rwkv6_scan: {rs.RWKV6_SCAN_TC_LAUNCHES - tc0} "
                             "of 6 calls took the tensor-core route")
    del xr, xk, xv, xlw, xo, xst, xwo, xws, x_mag, x_smag, big
    # The earlier kernel, stepped one token at a time, through _route's
    # other branch: held to the same checks at the serving shape and
    # timed in the same run.
    with replaced(rs, "_route", lambda f: lambda *a: "seq"):
        q_o, q_s = kern()
        torch.cuda.synchronize()
        if rs.RWKV6_SCAN_TC_LAUNCHES - tc0 != 6:
            raise AssertionError("rwkv6_scan: the seq route took the "
                                 "tensor-core kernel")
        seq_err = max(within_scan(q_o, w_o, o_mag_serve, BF16_TOL),
                      within_scan(q_s, w_s, s_mag_serve, 0.0))
        seq_per = time_spread(kern)
    del q_o, q_s
    per = time_spread(kern)
    nbytes = (r.numel() + k.numel() + v.numel() + g_o.numel()) \
        * r.element_size() + 4 * (lw.numel() + u.numel() + 2 * s0.numel())
    # Operations of the cheapest exact form, the chunk-parallel one with
    # pairwise decays: per step and head, r.S and the k v^T update as
    # matmuls over the float32 state on the tensor cores (4*K*V at the
    # TF32 rate) and the pairwise terms within a chunk of RWKV_CHUNK steps
    # on the CUDA cores (2*RWKV_CHUNK*(K+V) at the float32 rate).
    tc_flops = b * h * s * 4 * kd * vd
    cc_flops = b * h * s * 2 * RWKV_CHUNK * (kd + vd)
    flops = tc_flops + cc_flops
    t_ops = (tc_flops / TF32_FLOPS_PER_S + cc_flops / F32_FLOPS_PER_S) * 1e3
    t_bytes = bound_ms(nbytes)
    # The seq kernel's own sequential form: 5*K*V + 3*K + 2*V per step
    # and head, all on the CUDA cores.
    design_ms = b * h * s * (5 * kd * vd + 3 * kd + 2 * vd) \
        / F32_FLOPS_PER_S * 1e3
    row = {"name": "rwkv6_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/rwkv6_scan_tc.cu",
           "replaces": "src/repro/kernels/rwkv6_scan.py:27",
           "launches": launches["rwkv6_scan"], "max_abs_err": err,
           "ms": per[len(per) // 2], "ms_min": per[0], "ms_max": per[-1],
           "plain_ms": time_ms(plain), "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None}
    # The tensor-core kernel's own products: per chunk of 64 steps and
    # head, R S, A V and K^T V (64x64x64 each, A V about 5/8 of it under
    # the diagonal), six 16x16x64 sub-chunk products and four 8x8x64 half
    # products, each as three products of split parts (two where bf16 v
    # is exact), in bf16 for bf16 inputs and TF32 for float32.
    chunks = b * h * (-(-s // 64))
    mm = 2 * 64 ** 3
    bf16 = r.dtype == torch.bfloat16
    tc_design = chunks * (3 * mm + 3 * 6 * 2 * 16 * 16 * 64
                          + 3 * 4 * 2 * 8 * 8 * 64
                          + (2 if bf16 else 3) * (mm * 5 // 8 + mm))
    tc_rate = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S
    log("kernel", **row, shape=[b, s, h, kd, vd], dtype=str(r.dtype),
        kernel_route=rs._route(r.dtype, kd, vd),
        tc_launches=launches["rwkv6_scan_tc"],
        seq_route_ms=seq_per[len(seq_per) // 2], seq_route_ms_min=seq_per[0],
        seq_route_ms_max=seq_per[-1], seq_route_max_abs_err=seq_err,
        tc_form_flops=tc_design, tc_form_ops_ms=tc_design / tc_rate * 1e3,
        extreme_decay_max_abs_err=extreme_err,
        bound_ops_ms=t_ops, bound_bytes_ms=t_bytes, flops=flops,
        sequential_form_ops_ms=design_ms, bytes=nbytes, state_max_abs_err=state_err, tol=RWKV_TOL,
        vs_float64_max_abs_err=truth, output_max=value_max,
        term_size_max=size_max, strong_decay_max_abs_err=strong_err,
        planted_u_dropped_max_abs_diff=planted, planted_seen=True,
        ragged_max_abs_err=ragged_err,
        log_w_range=[float(lw.min()), float(lw.max())])
    return [{key: row[key] for key in ROW_KEYS}]


def column_blocks(err, width: int = 64) -> list[float]:
    """The largest of ``err`` (E, C, F) in each ``width``-column block of
    the output, left to right."""
    import torch.nn.functional as F
    cols = err.amax(dim=(0, 1))
    pad = -cols.numel() % width
    return F.pad(cols, (0, pad), value=float("-inf")).view(-1, width) \
        .amax(dim=1).tolist()


def check_gmm(recorded, launches):
    """The grouped matmul at each shape the serving path gave it (gate/up,
    then down), on the tensor-core route, against its plain version and
    ``torch.bmm``, with the largest error in each 64-column block of the
    output; in float32 against the float32 plain version, with the bf16
    result within one rounding of that. Two planted faults must fail the
    check: one expert's output zeroed, and columns 64-127 of every 128
    zeroed (a wrong leading byte offset in the B descriptor corrupts every
    swizzle atom of a tile after its first). At the gate/up shape the
    ``mma.sync`` route, the earlier kernel, is held to the same check and
    timed."""
    import torch
    from repro_torch.kernels import moe_gmm as mg
    rows = []
    calls = sorted(recorded["gmm"].values(), key=lambda a: -a[0][0].shape[2])
    for n, ((x, w), _) in enumerate(calls):
        e, c, d = x.shape
        f = w.shape[2]
        kern = lambda: mg.gmm(x, w)  # noqa: E731
        plain = lambda: mg.gmm_plain(x, w)  # noqa: E731
        lib = lambda: torch.bmm(x, w)  # noqa: E731
        tc0 = mg.GMM_TC_LAUNCHES
        got = kern()
        if mg.GMM_TC_LAUNCHES != tc0 + 1:
            raise AssertionError(f"gmm {[e, c, d, f]}: bf16 did not take the "
                                 "tensor-core route")
        want = plain()
        torch.cuda.synchronize()
        err = within(got, want, BF16_TOL)
        blocks = column_blocks((got.float() - want.float()).abs())
        # Float32: the kernel against the plain version, and the bf16
        # result against that within one rounding; the float32 part of
        # each bound scales with the size of the summed terms, |x| @ |w|.
        want32 = mg.gmm_plain(x.float(), w.float())
        size = mg.gmm_plain(x.float().abs(), w.float().abs())
        got32 = mg.gmm(x.float(), w.float())
        torch.cuda.synchronize()
        f32_excess = float(((got32 - want32).abs()
                            - GMM_F32_TOL * size).max())
        f32_err = float((got32 - want32).abs().max())
        del got32
        bf16_over = (got.float() - want32).abs() \
            - BF16_ROUND * want32.abs() - GMM_F32_TOL * size
        bf16_excess = float(bf16_over.max())       # the check: every output
        # The log: outputs that sum any term (an empty capacity row's read
        # 0 and would hide the margin of the rest).
        bf16_blocks = column_blocks(torch.where(size > 0, bf16_over,
                                                float("-inf")))
        del size, bf16_over
        if not (f32_excess <= 0 and bf16_excess <= 0):
            raise AssertionError(f"gmm against float32: excess over the "
                                 f"bound {f32_excess} (float32 kernel), "
                                 f"{bf16_excess} (bf16 kernel)")
        busiest = int(want32.abs().amax(dim=(1, 2)).argmax())
        del want32
        planted = {}
        bad = got.clone()
        bad[busiest] = 0
        planted["expert_zeroed"] = float((bad.float() - want.float())
                                         .abs().max())
        if not fails_check(lambda: within(bad, want, BF16_TOL)):
            raise AssertionError(f"gmm: the check missed the planted fault "
                                 f"(expert {busiest} zeroed)")
        bad = got.clone()
        bad[..., torch.arange(f, device=got.device) % 128 >= 64] = 0
        planted["tile_columns_64_127_zeroed"] = float(
            (bad.float() - want.float()).abs().max())
        if not fails_check(lambda: within(bad, want, BF16_TOL)):
            raise AssertionError("gmm: the check missed the planted fault "
                                 "(columns 64-127 of every tile zeroed)")
        del bad
        earlier = {}
        if n == 0:
            # The mma.sync kernel, through _route's other bf16 branch.
            with replaced(mg, "_route", lambda r: lambda *a: "mma"):
                tc0 = mg.GMM_TC_LAUNCHES
                got_mma = kern()
                torch.cuda.synchronize()
                if mg.GMM_TC_LAUNCHES != tc0:
                    raise AssertionError("gmm: the mma route took the "
                                         "tensor-core kernel")
                per = time_spread(kern)
                earlier = {"mma_route_max_abs_err": within(got_mma, want,
                                                           BF16_TOL),
                           "mma_route_ms": per[len(per) // 2],
                           "mma_route_ms_min": per[0],
                           "mma_route_ms_max": per[-1]}
                del got_mma
        flops = 2.0 * e * c * d * f
        nbytes = (x.numel() + w.numel() + got.numel()) * x.element_size()
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, bound_ms(nbytes)
        row = {"name": "gmm", "route": "cuda",
               "source": "src/repro_torch/csrc/moe_gmm_wgmma.cu",
               "replaces": "src/repro/kernels/moe_gmm.py:17",
               "launches": launches["gmm"], "max_abs_err": err,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               **kernel_times(kern, plain, lib)}
        if earlier:
            earlier["mma_route_tflops_per_s"] = \
                flops / earlier["mma_route_ms"] / 1e9
        log("kernel" if n == 0 else "kernel_sweep", **row,
            shape=[e, c, d, f], dtype=str(x.dtype),
            kernel_route=mg._route(x.dtype, d, f), flops=flops,
            bytes=nbytes, bound_bytes_ms=t_bytes,
            tflops_per_s=flops / row["ms"] / 1e9,
            library_tflops_per_s=flops / row["library_ms"] / 1e9,
            column_block_max_abs_err=blocks,
            column_block_bf16_vs_f32_excess=bf16_blocks,
            f32_max_abs_err=f32_err,
            f32_tol=GMM_F32_TOL, f32_excess_over_bound=f32_excess,
            bf16_vs_f32_excess_over_bound=bf16_excess,
            planted_expert_zeroed=busiest,
            planted_max_abs_diff=planted, planted_seen=True, **earlier,
            empty_slots=int((x.abs().amax(dim=2) == 0).sum()))
        if n == 0:
            rows.append({key: row[key] for key in ROW_KEYS})
    return rows


MODEL_CHECKS = {
    "recurrentgemma-2b": lambda rec, n: check_flash(rec, n)
    + check_rglru(rec, n),
    "rwkv6-1.6b": check_rwkv6,
    "deepseek-moe-16b": check_gmm,
}


# The redesigned libraries and the tensor-core instruction each must
# hold: HGMMA (``wgmma``), HMMA (``mma.sync``), or None (the TMA-fed
# RG-LRU scan, which has none to count).
TC_LIBS = {"flash_attention_wgmma": "HGMMA", "moe_gmm_wgmma": "HGMMA",
           "rwkv6_scan_tc": "HMMA", "rglru_scan_tma": None}


def log_wgmma_builds(report) -> None:
    """Each redesigned library as built: ptxas' report (registers,
    shared memory, spills) and, where the toolkit has ``cuobjdump``, the
    count of its tensor-core instructions, HGMMA and HMMA; the one
    ``TC_LIBS`` names must not be 0, and ptxas' report must show no
    spilled bytes."""
    from repro_torch.kernels import build as kbuild
    tool = kbuild.cuda_tool("cuobjdump")
    for name, needed in TC_LIBS.items():
        text = report.get(name, {}).get("log", "")
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "Used" in ln or "spill" in ln or "C75" in ln]
        spilled = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", text))
        counts = {"HGMMA": None, "HMMA": None}
        if tool is not None:
            sass = subprocess.run(
                [tool, "-sass", str(kbuild.library_path(name))],
                capture_output=True, text=True, timeout=300,
                check=True).stdout
            counts = {op: sass.count(op) for op in counts}
        log("build_wgmma", library=name, ptxas=ptxas,
            hgmma_instructions=counts["HGMMA"],
            hmma_instructions=counts["HMMA"], spilled_bytes=spilled)
        if needed is not None and counts[needed] == 0:
            raise AssertionError(f"the tensor-core library {name} holds no "
                                 f"{needed} instruction")
        if spilled:
            raise AssertionError(f"ptxas spilled {spilled} bytes in {name}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.engine import datagen
    from repro_torch.kernels import build as kbuild
    # The port's numbers are compared in full float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report = kbuild.build_all()
    regs = [ln.strip() for r in report.values() for ln in r["log"].splitlines()
            if "registers" in ln]
    log("build", seconds=time.perf_counter() - t0,
        built=sorted(report), ptxas=regs)
    log_wgmma_builds(report)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True
                         ).stdout.strip().splitlines()[0]
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), nvidia_smi=smi)

    kernels, failures = [], []
    if {"queries", "query_serving", "adaptive"} & set(PHASES):
        t0 = time.perf_counter()
        store = ObjectStore()
        keys = {"lineitem": datagen.load_table(store, "lineitem",
                                               LINEITEM_ROWS, 1),
                "orders": datagen.load_table(store, "orders", ORDERS_ROWS,
                                             1)}
        log("load", seconds=time.perf_counter() - t0,
            lineitem_rows=LINEITEM_ROWS, orders_rows=ORDERS_ROWS,
            stored_mib=store.total_bytes() / 2**20)
        launches = dict.fromkeys(QUERY_KERNELS, 0)
        recorded = wants = None
        if "queries" in PHASES:
            launches, recorded, warm_walls, wants = run_queries(store,
                                                                keys)
            profile_queries(store, keys, warm_walls)
        if wants is None:
            wants = numpy_results(store, keys)
        # Each path's launches are counted from 0 just before it; the
        # kernel rows carry their sum.
        if "query_serving" in PHASES:
            for k, n in run_query_serving(store, keys, wants).items():
                launches[k] += n
        if "adaptive" in PHASES:
            for k, n in run_adaptive(store, keys, wants).items():
                launches[k] += n
        if recorded is not None:
            kernels += check_probes(recorded, launches) \
                + check_segment_reduce(recorded, launches)
        del store, keys, recorded, wants
    if "serve" in PHASES:
        for arch in SERVE_ARCHS:
            eng, reqs, launches, first = run_serving(arch)
            recorded, toks, failed = check_serving_reference(eng, reqs,
                                                             first)
            failures += failed
            profile_serving(eng, toks)
            del eng, toks
            torch.cuda.empty_cache()
            kernels += MODEL_CHECKS[arch](recorded, launches)
            del recorded
            torch.cuda.empty_cache()

    if failures:
        raise AssertionError("; ".join(failures))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
