#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the query engine, LLM
serving, training, distribution (4 ranks on the one card), the paper's
benchmarks and the examples.

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
   every 128 of it zeroed);
10. train — (a) ``Trainer`` on RecurrentGemma-2B at full width and depth
   (3,549,934,080 parameters, bf16, ``impl="reference"``, ``remat=
   "block"``, 4 microbatches of 2 x 2,048 tokens, 4 steps at the
   launcher's schedule, a checkpoint at the last step): step 1's batch
   first runs through ``forward_train`` on a float32 copy of the initial
   weights; step 1's loss must lie within 2^-7 times that run's mean
   largest |logit| of its loss, every loss be finite, three
   leaves' step-1 gradients (the final norm, a middle ``rec`` layer's
   ``gate_a``, a middle ``local`` layer's ``wq``) have cosine >= 0.99
   against float32's, every update of those leaves equal AdamW
   recomputed in float64 on the host within one bf16 ulp plus float32
   rounding, and step 1's inputs rerun through the port's
   ``update_leaf`` in float32 equal it within float32 rounding; planted
   faults must fail (a layer's gradient
   zeroed; the bias correction dropped; weight decay on the final norm,
   a vector, which a bf16 step cannot show, so in float32). No port
   kernel may launch (training runs the reference route). Step time,
   tokens/s, the ``mfu`` share, peak device memory, the checkpoint's
   save and restore, one profiled step (idle share, device time by
   kernel class) and ``cost_report``. (b) One (rec, rec, local) unit at
   full width, 512 tokens a sequence, 4 steps, checkpoints every 2,
   under ``torch.use_deterministic_algorithms(True)`` (this sub-phase
   only; ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts): a run
   preempted at step 3 and resumed from step 2 must end with a
   checkpoint byte-equal to an uninterrupted run's.
11. distributed — 4 ranks on the one card (``launch.mesh.spawn``,
   backend gloo; the collectives' payloads through device mailboxes,
   ``transport="cuda_ipc"``, as gloo moves CUDA tensors at about 0.4
   GB/s), mesh (data 2, model 2), after the parent built the kernels.
   (d1) One ``moe`` layer of DeepSeekMoE-16B at full width, bf16, on the
   expert-parallel path with the grouped matmul: the all-to-all path at x
   (4, 4,096, 2,048) and the psum path at x (4, 1, 2,048), default
   capacity, against the single-device layer applied to each shard's
   tokens in turn with the kernel off (rank 0), within 2^-6 of the size
   of each output's summed terms; every ``gmm`` launch on the
   tensor-core route; the kernel at the EP shape against its plain
   version, timed. (d2) Two sharded train steps of DeepSeekMoE-16B (its
   dense layer and one ``moe`` layer, capacity factor 16, 8 x 256
   tokens) and of RecurrentGemma-2B's (rec, rec, local) unit (8 x 512
   tokens) against the one-process step on the same weights and batch
   (DeepSeekMoE's with the EP path's per-shard routing): losses within
   2^-7 of the mean largest |logit|, step 1's gradient cosines >= 0.99
   (step 2's logged: its weights already differ by rounding), every
   update of three or four leaves within ``check_updates``' allowances;
   each rank's parameter bytes those the rules give; DeepSeekMoE's
   checkpoint saved from (2, 2) restored onto one device and onto a
   (4, 1) mesh, both saved again byte-equal. (d3) DeepSeekMoE-16B served
   on the mesh at full width, its depth cut only as far as the reckoned
   peak of the 4 ranks needs to leave 10% of the card free: 4 requests of
   1,024-4,096 tokens in one batch, 16 new tokens, identical
   completions on every rank, ``cost_report`` with 4 chips; then 2
   ``moe`` layers, 1,024-token prompts, capacity 16: the first-token
   logits within ``LOGIT_TOL`` of the one-process engine's on the same
   weights and the same top-k expert choices (where near-ties flipped,
   the one-process prefill replays the mesh's), and the same first token
   wherever the top-1/top-2 gap exceeds twice the difference. (d4) The
   same ranks as (pod 2, data 2): ``compressed_psum`` over ``"pod"`` of
   gradient leaves of the RecurrentGemma unit's shapes, the reference
   test's checks (one-step error < 0.02, a nonzero error state, the
   9-step mean closer), 1 byte an element on the wire. (d5) One NCCL
   rank on the card: an EP layer call and a ``compressed_psum``.
12. paper — (run right after the adaptive phase, on its store)
   ``repro_torch.bench.paper_figures`` and ``paper_queries`` at the
   reference's sizes, Table 6 on ``Coordinator(backend="torch")`` on the
   card, so the planner reads the card's ``BENCH_engine_torch.json``;
   then Table 6 again on the SF1 tables of phase 2 (6,000,000
   ``lineitem`` rows, one paper worker's partition, and 1,500,000
   ``orders`` rows). Every Q6 and Q12 result of Table 6 is held against
   the numpy backend's on the same store; the probe and the segmented
   reduction must launch in each Table 6 run. Each row is printed with
   its ``EXPECT`` band, whether it lies inside, and, for Table 6, the
   paper's value (Q6 +10%, Q12 +6% slowdown; peak-to-average nodes 2.21,
   2.43); a row outside its band is a finding, not a failure.
13. examples — the six ``repro_torch.examples`` at their defaults on the
   card: the query examples' results held against the numpy backend
   (``concurrent_serving_quickstart``'s 16 served queries, the result
   cache's replay and invalidation), ``quickstart``'s 30 steps (every
   loss finite, the last within 0.05 of ln(vocab), the floor of its
   uniform synthetic tokens, 3 checkpoints, and the last checkpoint's
   weights moved by training: ``top.ln_f``, which only gradients reach,
   changed, and no decayed leaf changed along -w alone),
   ``elastic_training`` preempted at step 12 and resumed from step 10 to
   step 20, ``serverless_serving``'s 10 requests of 8 tokens; the
   segmented reduction and flash attention must launch. Flash attention
   is held against its plain version on every input shape
   ``serverless_serving`` gave it (float32 at head dim 16: the CUDA-core
   route, ``csrc/flash_attention.cu``), and that route gets its own row
   of the kernels line.

Ends with the card's name and power limit, a ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``. Any mismatch or exception exits
non-zero without the ``ok`` line. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import time

# cuBLAS reads this when CUDA starts; the deterministic resume of the
# train phase needs it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = pathlib.Path(__file__).resolve().parent
LINEITEM_ROWS = 6_000_000
ORDERS_ROWS = 1_500_000
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
RTOL = 1e-6
QUERIES = ("q1", "q6", "q12", "dup_key_join")
PHASES = ("queries", "query_serving", "adaptive", "paper", "serve",
          "train", "distributed", "examples")
# The phases that need the SF1 tables.
QUERY_PHASES = ("queries", "query_serving", "adaptive", "paper")
# The paper phase: Table 6's rows beside the paper's published values
# (Q6 +10% and Q12 +6% slowdown, peak-to-average nodes 2.21 and 2.43).
PAPER_TABLE6 = {"table6/q6_slowdown": 1.10, "table6/q12_slowdown": 1.06,
                "table6/q6_peak_avg_nodes": 2.21,
                "table6/q12_peak_avg_nodes": 2.43}
# The kernels Table 6's queries must launch (Q12's probe, the group-bys'
# segmented reduction); the range probe is recorded where it launches.
PAPER_KERNELS = ("probe", "segment_reduce")
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
# The train phase: (a) RecurrentGemma-2B at full width and depth, 8
# sequences of 2,048 tokens a step (the config's 4 microbatches), at the
# launcher's learning rate, which moves a bf16 weight of the model's
# size (about 0.02) by several ulps a step, so the update check sees it;
# (b) one (rec, rec, local) unit at full width for the bit-exact resume.
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_SEED = 2048, 8, 4, 0
TRAIN_LR = 1e-3
GRAD_COSINE = 0.99    # the step's gradients against float32's, per leaf
RESUME_LAYERS, RESUME_SEQ, RESUME_STEPS = 3, 512, 4
RESUME_EVERY, RESUME_PREEMPT_AT = 2, 3
# The distributed phase: 4 ranks on the one card, (data 2, model 2).
DIST_WORLD, DIST_MESH, DIST_ARCH = 4, (2, 2), "deepseek-moe-16b"
DIST_TIMEOUT = 900
# gloo moves a CUDA tensor at about 0.3 GB/s a rank (4 ranks on an H100
# host, torch 2.11; scripts/collective_bandwidth.py): the ranks'
# collectives go through device mailboxes.
DIST_TRANSPORT = "cuda_ipc"
EP_BATCH, EP_SEQ, EP_SEED = 4, 4096, 11
# (d1): the EP layer (grouped matmul on the card) against the oracle
# (einsum, kernel off) on the same tokens: each of the three products
# rounds its bf16 result once on each side, and an input rounded
# differently moves the next product by its terms' size times that
# rounding; so 2^-6 (two bf16 roundings, 2^-7 each) of the size of the
# summed terms of each output (the combine's gate-weighted |h| @
# |w_down|, and the shared experts'), plus 2^-24 for outputs of no terms.
EP_TOL, EP_ABS = 2.0 ** -6, 2.0 ** -24
# (d2): layers and tokens a sequence; 8 sequences, 2 microbatches.
DIST_TRAIN = {"deepseek-moe-16b": (2, 256), "recurrentgemma-2b": (3, 512)}
DIST_TRAIN_BATCH, DIST_TRAIN_MICRO, DIST_TRAIN_STEPS = 8, 2, 2
# The model whose checkpoint is restored onto one device and onto (4, 1):
# its experts change their layout over "model" (cut: the RecurrentGemma
# unit's, 9.4 GB, another minute of the phase).
DIST_CKPT_ARCH = "deepseek-moe-16b"
# (d3)
DIST_SERVE_REQUESTS, DIST_SERVE_NEW = 4, 16
DIST_PARITY_MOE_LAYERS, DIST_PARITY_PROMPT = 2, 1024
# (d4): leaves above this many elements (the unit's 256000 x 2560
# embedding: its float32 partial and temporaries take about 20 GB a
# rank) are left out.
DIST_COMPRESS_MAX_ELEMENTS = 100_000_000


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


def check_result(name, got, want, keys=None) -> None:
    """``got`` against the numpy backend's ``want`` by the contract of
    ``docs/BACKENDS.md``: keys (``KEY_COLS[name]`` unless given), dtypes
    and integers exactly, floats within ``RTOL``."""
    import numpy as np
    if list(got) != list(want) or got.num_rows != want.num_rows \
            or got.num_rows == 0:
        raise AssertionError(f"{name}: schema or row count differs: "
                             f"{list(got)}/{got.num_rows} vs "
                             f"{list(want)}/{want.num_rows}")
    keys = KEY_COLS[name] if keys is None else keys
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
# The paper's benchmarks and the examples
# ---------------------------------------------------------------------------

def log_rows(phase: str, rows, expect) -> list[str]:
    """Log each benchmark row with its band and whether it lies inside
    (beside the paper's value for Table 6's); return the rows outside."""
    outside = []
    for name, us, derived in rows:
        band = expect.get(name)
        inside = band is None or band[0] <= derived <= band[1]
        if not inside:
            outside.append(name)
        log(phase, name=name, us_per_call=us, derived=derived,
            band=band, inside=inside, paper=PAPER_TABLE6.get(name))
    return outside


def table6_on_card(store, keys, size: str) -> dict:
    """Table 6's queries on ``store`` with the torch backend on the card
    (the launch counts at 0 just before, read just after), each result
    held against the numpy backend's on the same store; logs its rows.
    Returns the launches and the rows outside their bands."""
    import torch
    from repro_torch.bench import paper_queries as pq
    from repro_torch.engine import queries
    from repro_torch.engine.coordinator import Coordinator
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = pq.table6_runs(store, keys, backend="torch", device=DEVICE)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6
    launches = query_launches()
    ref = Coordinator(store, backend="numpy")
    for t, k in keys.items():
        ref.register_table(t, k)
    want6 = ref.execute(queries.q6_plan(), query_id="t6-numpy").result
    want12 = ref.execute(queries.q12_plan(shuffle_partitions=16),
                         query_id="t12-numpy").result
    for mode, (r6, r12) in runs.items():
        check_result("q6", r6.result, want6)
        check_result("q12", r12.result, want12)
        log("paper_table6_run", size=size, mode=mode,
            q6_runtime_s=r6.runtime_s, q12_runtime_s=r12.runtime_s,
            q6_peak_workers=r6.peak_workers,
            q12_peak_workers=r12.peak_workers, matches_numpy=True)
    require_launches(f"paper Table 6 ({size})", launches, PAPER_KERNELS)
    log("paper_launches", size=size, wall_s=us / 1e6, **launches)
    outside = log_rows(f"paper_table6_{size}", pq.table6_rows(runs, us),
                       pq.EXPECT)
    return {"launches": launches, "outside": outside}


def run_paper(store, keys) -> dict:
    """Phase ``paper``: ``paper_figures`` and ``paper_queries`` at the
    reference's sizes (Table 6 on the card), then Table 6 again on the
    SF1 tables of the query phases. A row outside its band is logged, a
    wrong result or a missing launch fails. Returns the launches."""
    from repro_torch.bench import paper_figures, paper_queries as pq
    outside = []
    for fn in paper_figures.ALL:
        outside += log_rows("paper_figures", fn(), paper_figures.EXPECT)
    for fn in (pq.fig14_burst_scan, pq.fig15_shuffle_warm,
               pq.tpu_cost_extension):
        outside += log_rows("paper_queries", fn(), pq.EXPECT)
    launches = dict.fromkeys(QUERY_KERNELS, 0)
    small_store, small_keys = pq._setup()
    for st, ks, size in ((small_store, small_keys, "reference"),
                         (store, keys, "sf1")):
        t6 = table6_on_card(st, ks, size)
        outside += [f"{size}:{name}" for name in t6["outside"]]
        for k, n in t6["launches"].items():
            launches[k] += n
    log("paper", launches=launches, rows_outside_bands=outside)
    return launches


# The uniform-token entropy floor: the quickstart's synthetic tokens are
# drawn uniformly (data/pipeline.py), so no model's expected loss falls
# below ln(vocab); a trained model's sits within this of it.
QUICKSTART_LOSS_SLACK = 0.05
# Only gradients move ``top.ln_f`` (weight decay reaches matrices only):
# over 100 times float32's rounding of a weight near 1 (6e-8), under a
# tenth of one Adam step at the peak rate (1e-3).
QUICKSTART_MOVED = 1e-5
# A matrix's change from weight decay alone points along -w (cosine 1);
# Adam's normalised steps on the gradients turn it away (0.01-0.13 in a
# CPU run of 30 steps; the norm scales, which shrink as they train, are
# left out).
QUICKSTART_DECAY_COSINE = 0.5


def quickstart_moved(qs) -> dict:
    """How the quickstart's last checkpoint differs from its seeded
    initial weights: ``top.ln_f``'s largest change, and the largest
    cosine between a matrix's change and -w. Raises where training did
    not move the weights (a skipped update, zero gradients)."""
    import torch
    from repro_torch.checkpoint import object_store_ckpt as ckpt
    trainer = qs["trainer"]
    first, _ = trainer.init_state()
    last, _ = ckpt.restore_checkpoint(qs["store"], trainer.ckpt_prefix,
                                      trainer.init_state()[0],
                                      step=qs["steps"])
    ln_f, cosine = 0.0, {}
    for (name, w0), (_, w1) in zip(first.named_parameters(),
                                   last.named_parameters()):
        delta = (w1.float() - w0.float()).flatten()
        if name == "top.ln_f":
            ln_f = float(delta.abs().max())
        elif w0.ndim > 1:
            cosine[name] = float(torch.nn.functional.cosine_similarity(
                delta, -w0.float().flatten(), dim=0))
    out = {"ln_f_max_abs_change": ln_f,
           "max_decay_cosine": max(cosine.values()),
           "matrices": len(cosine)}
    if not (ln_f > QUICKSTART_MOVED
            and out["max_decay_cosine"] < QUICKSTART_DECAY_COSINE):
        raise AssertionError(f"examples: quickstart's weights did not "
                             f"train: {out}")
    return out


def check_flash_examples(rec, fma_launches: int) -> list:
    """Flash attention on every input shape ``serverless_serving``'s
    steps gave it (float32 at head dim 16: the CUDA-core route), against
    the plain version within F32_ATTN_TOL (BF16_TOL for bf16); with the
    CUDA-core route's row of the kernels line, timed on the largest call's
    inputs, where that route launched."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    errs = {}
    for (q, k, v), kw in rec.shapes.values():
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = F32_ATTN_TOL if q.dtype == torch.float32 else BF16_TOL
        errs[str(tuple(q.shape))] = within(got, want, tol)
    if not fma_launches:
        return []
    (q, k, v), kw = rec.args
    causal, window = kw.get("causal", True), kw.get("window", 0)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if fa._route(q.dtype, d) != "fma":
        raise AssertionError(f"serverless_serving's largest flash call "
                             f"{tuple(q.shape)} {q.dtype}: not the "
                             "CUDA-core route's")
    kern = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                      window=window)
    plain = lambda: fa.flash_attention_plain(  # noqa: E731
        q, k, v, causal=causal, window=window)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = {"is_causal": causal}
    if window:
        qp = torch.arange(sq, device=DEVICE)[:, None]
        kp = torch.arange(skv, device=DEVICE)[None, :]
        mask = {"attn_mask": (kp <= qp) & (kp > qp - window)}
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=True, **mask)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = within(got, want, F32_ATTN_TOL)
    pairs = band_pairs(sq, skv, causal, window)
    flops = 4.0 * b * h * d * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) \
        * q.element_size()
    t_ops, t_bytes = flops / F32_FLOPS_PER_S * 1e3, bound_ms(nbytes)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:22",
           "launches": fma_launches, "max_abs_err": err,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           **kernel_times(kern, plain, lib)}
    log("kernel", **row, case="serverless_serving", shape=[b, sq, h, d],
        kv_heads=k.shape[2], dtype=str(q.dtype), causal=causal,
        window=window, kernel_route="fma", f32_tol=F32_ATTN_TOL,
        max_abs_err_by_shape=errs)
    return [{key: row[key] for key in ROW_KEYS}]


def run_examples() -> tuple:
    """Phase ``examples``: each of the six examples' ``main()`` at its
    defaults on the card (the launch counts at 0 just before, read just
    after); the query examples' results held against the numpy backend;
    the training examples' outcomes checked; flash attention held against
    its plain version on ``serverless_serving``'s inputs. Returns the
    launches (flash attention's: the tensor-core route's) and the
    CUDA-core flash route's row of the kernels line."""
    import math
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.engine import Coordinator, datagen, queries
    from repro_torch.examples import (concurrent_serving_quickstart,
                                      cost_planner, elastic_training,
                                      logical_api_quickstart, quickstart,
                                      serverless_serving)
    from repro_torch.kernels import flash_attention as fa
    reset_launch_counts()
    t0 = time.perf_counter()
    cost_planner.main([])
    walls = {"cost_planner": time.perf_counter() - t0}

    t0 = time.perf_counter()
    lq = logical_api_quickstart.main([])
    walls["logical_api_quickstart"] = time.perf_counter() - t0
    check_result("revenue_by_shipmode", lq["torch"].result,
                 lq["numpy"].result, keys=["l_shipmode"])
    ref = Coordinator(lq["store"], backend="numpy")
    ref.register_table("lineitem", lq["hashed_keys"])
    check_result("revenue_by_order", lq["elided"].result,
                 ref.run(lq["per_order"], query_id="elided-numpy").result,
                 keys=["l_orderkey"])

    t0 = time.perf_counter()
    cs = concurrent_serving_quickstart.main([])
    walls["concurrent_serving_quickstart"] = time.perf_counter() - t0
    ref = Coordinator(cs["store"], backend="numpy")
    for t, k in cs["tables"].items():
        ref.register_table(t, k)
    base = datagen.DATE_1994_01_01
    for mode in ("serial", "interleaved"):
        report = cs[mode]
        if report.failures or len(report.queries) != \
                concurrent_serving_quickstart.N_QUERIES:
            raise AssertionError(f"examples: {mode} serving failed")
        for i, served in enumerate(report.queries):
            want = ref.run(queries.q12_logical(year_lo=base + 30 * i),
                           query_id=f"cs-{mode}-{i}").result
            check_result("q12", served.result.result, want)
    if cs["replay"].result_cache_hits != 1 or \
            cs["rerun"].result_cache_hits != 0:
        raise AssertionError("examples: the result cache did not replay "
                             "and then invalidate")

    t0 = time.perf_counter()
    qs = quickstart.main([])
    walls["quickstart"] = time.perf_counter() - t0
    losses = [m["loss"] for m in qs["metrics"]]
    floor = math.log(ARCHS["internlm2-1.8b"].reduced().vocab_size)
    if qs["status"] != "done" or len(losses) != 6 or \
            not all(math.isfinite(x) for x in losses) or \
            abs(losses[-1] - floor) > QUICKSTART_LOSS_SLACK or \
            len(qs["manifests"]) != 6:
        raise AssertionError(f"examples: quickstart {qs['status']}, "
                             f"losses {losses} (floor {floor}), "
                             f"manifests {qs['manifests']}")
    moved = quickstart_moved(qs)

    t0 = time.perf_counter()
    el = elastic_training.main([])
    walls["elastic_training"] = time.perf_counter() - t0
    steps = [m["step"] for m in el["phase2"]["metrics"]]
    if el["phase1"]["resumable_from"] != 10 or \
            el["phase2"]["status"] != "done" or steps != [12, 14, 16, 18,
                                                          20]:
        raise AssertionError(f"examples: elastic_training did not resume "
                             f"from step 10 and complete: {el}")

    rec = Recorder(fa, "flash_attention", lambda a: a[0].numel(),
                   by_shape=True)
    try:
        t0 = time.perf_counter()
        sv = serverless_serving.main([])
        walls["serverless_serving"] = time.perf_counter() - t0
    finally:
        rec.restore()
    torch.cuda.synchronize()
    launches, routes = launch_counts(), route_counts()
    done = sv["done"]
    if sorted(r.request_id for r in done) != list(range(10)) or any(
            r.completion.shape != (8,) or r.completion.max()
            >= sv["vocab_size"] or r.completion.min() < 0 for r in done):
        raise AssertionError("examples: serverless_serving did not answer "
                             "10 requests of 8 tokens")
    # The logical Q12's join tail derives an integer column from a
    # column it reads, which the device would narrow to int32: it runs
    # interpreted, as the reference's jit does, so the probe may not
    # launch here (recorded).
    require_launches("examples", launches, ("segment_reduce",
                                            "flash_attention"))
    fma = launches["flash_attention"] - routes["flash_attention_tc"]
    launches["flash_attention"] -= fma
    log("examples", walls_s=walls, launches=launches,
        flash_attention_fma_launches=fma, quickstart_losses=losses,
        quickstart_entropy_floor=floor, quickstart_moved=moved,
        elastic_phase2_steps=steps, elastic_ranks=el["ranks"],
        serving_cost=sv["cost"])
    return launches, check_flash_examples(rec, fma)


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


# ---------------------------------------------------------------------------
# Training: RecurrentGemma-2B through Trainer
# ---------------------------------------------------------------------------

def train_configs():
    """(a)'s and (b)'s model configs, and the optimizer config: the
    launcher's schedule for TRAIN_STEPS steps (warmup a tenth of the
    steps, at least one)."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.train import optimizer as opt_mod
    cfg = ARCHS[TRAIN_ARCH]
    return (cfg, dataclasses.replace(cfg, num_layers=RESUME_LAYERS),
            opt_mod.AdamWConfig(lr=TRAIN_LR,
                                warmup_steps=max(TRAIN_STEPS // 10, 1),
                                total_steps=TRAIN_STEPS))


def train_leaves(kinds) -> tuple:
    """The final norm, the recurrence gate of the first ``rec`` layer
    and the query projection of the first ``local`` layer from the
    middle of the stack on."""
    mid = len(kinds) // 2
    rec = next(i for i in range(mid, len(kinds)) if kinds[i] == "rec")
    local = next(i for i in range(mid, len(kinds)) if kinds[i] == "local")
    return ("top.ln_f", f"layers.{rec}.rgl.gate_a",
            f"layers.{local}.attn.wq")


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def float32_step_reference(trainer, cfg, leaves):
    """Step 1's batch through ``forward_train`` on a float32 copy of the
    initial weights (drawn again from the trainer's seed): the mean of
    the microbatch losses, the gradients of ``leaves`` averaged over the
    microbatches as the train step averages them, and the mean over
    tokens of each token's largest |logit| (for the loss tolerance)."""
    import dataclasses
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    model, opt = trainer.init_state()
    del opt
    params = tfm.param_count(model)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.float()
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(False)
    wanted = [named[n].requires_grad_(True) for n in leaves]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in trainer.pipeline.batch_at(0).items()}
    grads = [torch.zeros_like(p) for p in wanted]
    losses, logit_max = [], []

    def record_max(f):
        def lm_head(model, cfg, x, *rest):
            logits = f(model, cfg, x, *rest)
            with torch.no_grad():
                logit_max.append(float(torch.maximum(
                    logits.amax(-1), -logits.amin(-1)).mean()))
            return logits
        return lm_head

    mbs = steps._split_microbatches(batch, cfg.microbatches)
    with replaced(tfm, "_lm_head", record_max):
        for mb in mbs:
            loss, _ = tfm.forward_train(model, cfg32, mb)
            for g, d in zip(grads, torch.autograd.grad(loss, wanted)):
                g.add_(d)
            losses.append(float(loss.detach()))
    del model, named, wanted
    torch.cuda.empty_cache()
    return {"loss": sum(losses) / len(losses), "losses": losses,
            "grads": [g / len(mbs) for g in grads],
            "logit_max_mean": sum(logit_max) / len(logit_max),
            "parameters": params}


def adamw_f64(p, g, m, v, *, step, grad_norm, cfg, decay,
              bias_correction=True):
    """``apply_updates``' arithmetic for one leaf in float64 on the host
    (numpy): (new p, m, v) and the size of the terms each sums."""
    import math
    import numpy as np
    p, g, m, v = (np.asarray(t.detach().double().cpu()) for t in (p, g, m, v))
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    progress = min(max((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0),
                   1.0)
    lr = cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                          * 0.5 * (1 + math.cos(math.pi * progress)))
    scale = min(1.0, cfg.grad_clip / max(grad_norm, 1e-9)) \
        if cfg.grad_clip else 1.0
    b1c = 1 - cfg.b1 ** step if bias_correction else 1.0
    b2c = 1 - cfg.b2 ** step if bias_correction else 1.0
    g = g * scale
    m_new = m * cfg.b1 + g * (1 - cfg.b1)
    v_new = v * cfg.b2 + g * g * (1 - cfg.b2)
    delta = (m_new / b1c) / (np.sqrt(v_new / b2c) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p
    return ((p - lr * delta, np.abs(p) + np.abs(lr * delta)),
            (m_new, np.abs(m * cfg.b1) + np.abs(g * (1 - cfg.b1))),
            (v_new, np.abs(v * cfg.b2) + g * g * (1 - cfg.b2)))


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits; no finer than the
    spacing of bfloat16's subnormals)."""
    import numpy as np
    _, e = np.frexp(np.abs(x))
    return np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -133)


def update_error(got, want, inputs):
    """Largest |got - want| over its allowance: 16 float32 roundings of
    the size of the terms the result sums (the card computes in float32,
    with b1, b2 and the bias corrections themselves rounded to float32:
    up to 4 roundings each, 14 along p's update), plus, for a bfloat16
    result, one bfloat16 ulp of ``want`` (the card rounds its float32
    value once, and float64 may round it across the edge; where the
    terms cancel, the float32 part is the larger). A result passes at 1
    or below. Returns (error, the worst element's ``inputs`` (p, g, m,
    v), got and want)."""
    import numpy as np
    import torch
    ref, terms = want
    g = np.asarray(got.detach().double().cpu()).ravel()
    ref, terms = ref.ravel(), terms.ravel()
    allow = 16 * 2.0 ** -24 * terms + 2.0 ** -149
    if got.dtype == torch.bfloat16:
        allow = allow + bf16_ulp(ref)
    ratio = np.abs(g - ref) / allow
    i = int(np.argmax(ratio))
    return float(ratio[i]), {
        "index": i, "got": float(g[i]), "want": float(ref[i]),
        **{k: float(t.detach().reshape(-1)[i]) for k, t in zip("pgmv",
                                                               inputs)}}


def check_updates(records, cfg, decays) -> dict:
    """Each recorded update of the named leaves (bfloat16 parameters and
    moments, every step) against ``adamw_f64``; then step 1's inputs
    through the port's ``update_leaf`` in float32 on the card, where the
    planted faults (bias correction dropped; weight decay on the final
    norm) must fail."""
    import torch
    from repro_torch.train import optimizer as opt_mod
    worst = {}
    for rec in records:
        for name, (p, g, m, v) in rec["before"].items():
            want = adamw_f64(p, g, m, v, step=rec["step"],
                             grad_norm=rec["grad_norm"], cfg=cfg,
                             decay=decays[name])
            for got, w, what in zip(rec["after"][name], want,
                                    ("p", "mu", "nu")):
                key = f"{name}.{what}"
                err, where = update_error(got, w, rec["before"][name])
                if err >= worst.get(key, (0.0,))[0]:
                    worst[key] = (err, {"step": rec["step"], **where})
    first = records[0]
    step = torch.tensor(first["step"], dtype=torch.int32, device=DEVICE)
    gnorm = torch.tensor(first["grad_norm"], dtype=torch.float32,
                         device=DEVICE)
    lr = opt_mod.schedule(step, cfg)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c, b2c = 1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float()
    faults = {"sound": {}, "bias_correction_dropped": {},
              "decay_on_vectors": {}}

    def run(name, dtype, fault):
        p, g, m, v = (t.to(dtype) if i != 1 else t
                      for i, t in enumerate(first["before"][name]))
        p, m, v = p.clone(), m.clone(), v.clone()
        one = torch.ones((), device=DEVICE)
        opt_mod.update_leaf(
            p, g, m, v, lr=lr, scale=scale,
            b1c=one if fault == "bias_correction_dropped" else b1c,
            b2c=one if fault == "bias_correction_dropped" else b2c,
            decay=decays[name] or fault == "decay_on_vectors", cfg=cfg)
        want = adamw_f64(*first["before"][name], step=first["step"],
                         grad_norm=first["grad_norm"], cfg=cfg,
                         decay=decays[name])
        return max(update_error(got, w, first["before"][name])[0]
                   for got, w in zip((p, m, v), want))

    for fault in faults:
        for name in first["before"]:
            faults[fault][name] = {
                "float32": run(name, torch.float32, fault),
                "bfloat16": run(name, torch.bfloat16, fault)}
    return {"worst": worst, "step1_rerun": faults}


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den else 0.0


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, marks in (("gemm", ("gemm", "nvjet", "xmma", "cutlass",
                                 "cublas")),
                       ("softmax", ("softmax",)),
                       ("reduce", ("reduce", "norm")),
                       ("index", ("index", "scatter", "gather", "embedding")),
                       ("copy/cat", ("cat", "copy")),
                       ("elementwise", ("elementwise", "vectorized",
                                        "unrolled"))):
        if any(m in n for m in marks):
            return cls
    return "other"


def profile_train_step(step_fn, model, opt_state, batch, card):
    """One train step under ``torch.profiler``: the device's idle share
    of its wall and its device time by kernel class."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        cls = by_class.setdefault(kernel_class(evt.key), [0, 0.0])
        cls[0] += evt.count
        cls[1] += evt.self_device_time_total / 1e6
    summary = device_summary(prof, wall)
    log("train_profile", card=card, wall_s=wall,
        loss=float(metrics["loss"]), **summary,
        device_s_by_class=dict(sorted(
            ((k, {"kernels": n, "device_s": t})
             for k, (n, t) in by_class.items()),
            key=lambda kv: -kv[1]["device_s"])))
    return opt_state


def train_flops(cfg, params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one step: 6 per matmul parameter per token (the
    embedding table is a lookup and counts none) plus the attention
    term, 3 x 4 x H x Dh per attended (query, key) pair of each local
    layer (forward and backward; the recomputed forward not counted)."""
    kinds = cfg.layer_kinds()
    w = min(cfg.window or seq, seq)
    pairs = sum(min(q + 1, w) for q in range(seq)) * (tokens // seq)
    attn = 12 * cfg.num_heads * cfg.head_dim * pairs * kinds.count("local")
    return 6.0 * (params - cfg.vocab_size * cfg.d_model) * tokens + attn


def run_train(card: str) -> None:
    """(a): ``Trainer`` on RecurrentGemma-2B at full width and depth,
    bf16, ``impl="reference"``, ``remat="block"``, 4 microbatches of 2 x
    2048 tokens, TRAIN_STEPS steps, a checkpoint at the last step; the
    loss, gradient and optimizer checks with their planted faults; the
    checkpoint restored and one more step profiled."""
    import math
    import torch
    from repro_torch.checkpoint import object_store_ckpt as ckpt
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, _, opt_cfg = train_configs()
    if cfg.remat != "block" or cfg.microbatches != 4:
        raise AssertionError(f"{cfg.name}: remat {cfg.remat!r}, "
                             f"{cfg.microbatches} microbatches")
    store = ObjectStore()
    trainer = Trainer(cfg, store, DataConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=TRAIN_SEED),
        opt_cfg, TrainerConfig(total_steps=TRAIN_STEPS,
                               checkpoint_every=TRAIN_STEPS,
                               seed=TRAIN_SEED, log_every=1),
        device=DEVICE)
    leaves = train_leaves(tfm.layer_kinds(cfg))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    t0 = time.perf_counter()
    ref = float32_step_reference(trainer, cfg, leaves)
    log("train_float32_reference", card=card, arch=cfg.name,
        seconds=time.perf_counter() - t0, parameters=ref["parameters"],
        loss=ref["loss"], microbatch_losses=ref["losses"],
        logit_max_mean=ref["logit_max_mean"], leaves=list(leaves))

    records = []

    def recording(f):
        def apply_updates(params, grads, state, ocfg):
            named = opt_mod.named_tensors(params)
            before = {n: tuple(t.detach().clone() for t in (
                named[n], grads[n], state.mu[n], state.nu[n]))
                for n in leaves}
            out = f(params, grads, state, ocfg)
            records.append({
                "step": int(out[1].step), "grad_norm":
                float(out[2]["grad_norm"]), "before": before,
                "after": {n: tuple(t.detach().clone() for t in (
                    named[n], out[1].mu[n], out[1].nu[n]))
                    for n in leaves}})
            return out
        return apply_updates

    steps = Timed(trainer.step_fn)
    trainer.step_fn = steps
    save_s = []
    checkpoint = trainer._checkpoint

    def timed_checkpoint(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        checkpoint(*args)
        save_s.append(time.perf_counter() - t)
    trainer._checkpoint = timed_checkpoint

    state_bytes = 6 * ref["parameters"]       # bf16 weights, mu, nu
    avail = host_available_bytes()
    # The store keeps the checkpoint, and saving copies one leaf at a
    # time (the largest, the LM head, 1.3 GB) twice more.
    use_trainer = avail >= state_bytes * 1.25
    log("train_host_memory", card=card, available_bytes=avail,
        checkpoint_bytes=state_bytes, path="Trainer.run" if use_trainer
        else "make_train_step (the host cannot hold the checkpoint)")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with replaced(opt_mod, "apply_updates", recording):
        t0 = time.perf_counter()
        if use_trainer:
            out = trainer.run()
        else:
            model, opt_state = trainer.init_state()
            for step in range(TRAIN_STEPS):
                batch = {k: torch.from_numpy(v).to(DEVICE) for k, v
                         in trainer.pipeline.batch_at(step).items()}
                opt_state, m = trainer.step_fn(model, opt_state, batch)
                trainer.metrics_log.append(
                    {"step": step + 1, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
            del model, opt_state
            out = {"status": "done", "metrics": trainer.metrics_log,
                   "cost": trainer.cost_report(time.perf_counter() - t0)}
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    if out["status"] != "done" or any(launches.values()):
        raise AssertionError(f"train: {out['status']}, kernel launches "
                             f"{launches} (impl='reference' runs none)")
    losses = [m["loss"] for m in out["metrics"]]
    later = sorted(steps.seconds[1:])
    median = later[len(later) // 2]
    flops = train_flops(cfg, ref["parameters"], tokens, TRAIN_SEQ)
    log("train_steps", card=card, arch=cfg.name, steps=TRAIN_STEPS,
        tokens_per_step=tokens, microbatches=cfg.microbatches,
        step_s=steps.seconds, step_s_median_2_to_4=median,
        step_s_min_2_to_4=later[0], step_s_max_2_to_4=later[-1],
        tokens_per_s=tokens / median, losses=losses,
        grad_norms=[m["grad_norm"] for m in out["metrics"]], wall_s=wall)
    log("train_mfu", card=card, model_flops_per_step=flops,
        mfu=flops / median / BF16_FLOPS_PER_S,
        peak_flops_per_s=BF16_FLOPS_PER_S)
    log("train_memory", card=card, max_memory_allocated=peak,
        max_memory_allocated_gib=peak / 2**30)
    log("train_cost", card=card, **out["cost"])

    # Loss: the bf16 step's loss against float32 on the same batch. A
    # token's loss is logsumexp - gold logit; rounding the bf16 LM head's
    # logits (half an ulp, 2^-9 of each) moves it by at most 2^-9 (max|l|
    # + |l_gold|) <= 2^-8 max|l|; the layers below round their bf16
    # activations as well, which the tolerance allows once more: 2^-7
    # times the mean over tokens of the largest |logit|, from this run.
    loss_tol = 2.0 ** -7 * ref["logit_max_mean"]
    loss_err = abs(losses[0] - ref["loss"])
    # Gradients: the step's (float32 sums of bf16 microbatch gradients)
    # against float32's; a planted fault zeroes one layer's gradient.
    first = records[0]
    cos = {n: cosine(first["before"][n][1], g)
           for n, g in zip(leaves, ref["grads"])}
    zeroed = cosine(torch.zeros_like(first["before"][leaves[1]][1]),
                    ref["grads"][1])
    decays = {n: opt_mod.decays(n, first["before"][n][0]) for n in leaves}
    upd = check_updates(records, opt_cfg, decays)
    log("train_checks", card=card, loss_step1=losses[0],
        loss_float32=ref["loss"], loss_error=loss_err, loss_tol=loss_tol,
        gradient_cosine=cos, gradient_cosine_min=GRAD_COSINE,
        planted_zeroed_layer_cosine=zeroed,
        update_error_over_allowance=upd["worst"],
        step1_rerun_error_over_allowance=upd["step1_rerun"])
    failed = []
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"losses {losses}")
    if not loss_err <= loss_tol:
        failed.append(f"step-1 loss {losses[0]} vs float32 {ref['loss']}")
    failed += [f"gradient cosine of {n}: {c}" for n, c in cos.items()
               if not c >= GRAD_COSINE]
    if zeroed >= GRAD_COSINE:
        failed.append("a zeroed layer gradient passes the gradient check")
    failed += [f"update of {k}: {e} allowances at {where}" for k, (e, where)
               in upd["worst"].items() if not e <= 1.0]
    rerun = upd["step1_rerun"]
    failed += [f"float32 update of {n}: {e['float32']} allowances"
               for n, e in rerun["sound"].items() if not e["float32"] <= 1]
    for fault in ("bias_correction_dropped", "decay_on_vectors"):
        if not any(e["float32"] > 1 for e in rerun[fault].values()):
            failed.append(f"the planted fault {fault} passes the update "
                          "check")
    if failed:
        raise AssertionError("train: " + "; ".join(failed))
    del records, first, ref

    # The checkpoint, restored onto the card, and one more step profiled.
    if use_trainer:
        reads = store.stats.read_bytes
        model, opt_state = trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, step = ckpt.restore_checkpoint(store, "ckpt", model,
                                              device=DEVICE)
        opt_state, _ = ckpt.restore_checkpoint(store, "ckpt-opt", opt_state,
                                               device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        log("train_checkpoint", card=card, step=step, save_s=save_s,
            saved_bytes=store.stats.write_bytes, stored_bytes=
            store.total_bytes(), objects=len(store.list("ckpt")),
            restore_s=restore_s,
            restored_bytes=store.stats.read_bytes - reads)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
                 trainer.pipeline.batch_at(TRAIN_STEPS).items()}
        profile_train_step(steps.fn, model, opt_state, batch, card)
        del model, opt_state, batch
    del trainer, store
    torch.cuda.empty_cache()


def run_resume(card: str) -> None:
    """(b): bit-exact resume at full width, one (rec, rec, local) unit,
    under ``torch.use_deterministic_algorithms(True)`` (this sub-phase
    only): an uninterrupted run of RESUME_STEPS steps against one
    preempted at step RESUME_PREEMPT_AT and resumed from the checkpoint
    of step RESUME_EVERY; their final checkpoints (parameters, moments,
    step) must be byte-equal."""
    import torch
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Preempted, Trainer, TrainerConfig
    _, cfg, opt_cfg = train_configs()
    data = DataConfig(seq_len=RESUME_SEQ, global_batch=TRAIN_BATCH,
                      seed=TRAIN_SEED)
    tcfg = TrainerConfig(total_steps=RESUME_STEPS,
                         checkpoint_every=RESUME_EVERY, seed=TRAIN_SEED,
                         log_every=1)

    def bomb(step):
        if step == RESUME_PREEMPT_AT:
            raise Preempted()

    whole, resumed = ObjectStore(), ObjectStore()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        out = Trainer(cfg, whole, data, opt_cfg, tcfg, device=DEVICE).run()
        cut = Trainer(cfg, resumed, data, opt_cfg, tcfg,
                      preemption_hook=bomb, device=DEVICE).run()
        out2 = Trainer(cfg, resumed, data, opt_cfg, tcfg,
                       device=DEVICE).run()
    finally:
        torch.use_deterministic_algorithms(False)
    wall = time.perf_counter() - t0
    base = f"step-{RESUME_STEPS:08d}"
    keys = [k for p in ("ckpt", "ckpt-opt")
            for k in whole.list(f"{p}/{base}/")]
    differ = [k for k in keys if whole.get(k) != resumed.get(k)]
    log("train_resume", card=card, layers=cfg.num_layers,
        seq_len=RESUME_SEQ, steps=RESUME_STEPS,
        checkpoint_every=RESUME_EVERY, preempted=cut,
        losses=[m["loss"] for m in out["metrics"]],
        resumed_losses=[m["loss"] for m in out2["metrics"]],
        objects_compared=len(keys), objects_differing=len(differ),
        wall_s=wall)
    if cut["status"] != "preempted" or \
            cut["resumable_from"] != RESUME_EVERY:
        raise AssertionError(f"train_resume: preemption gave {cut}")
    if out2["status"] != "done" or not keys or differ:
        raise AssertionError(f"train_resume: {len(differ)} of {len(keys)} "
                             f"checkpoint objects differ: {differ[:4]}")
    del whole, resumed
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Distribution: 4 ranks on the one card
# ---------------------------------------------------------------------------

def _dist_setup():
    """What every rank of the distributed phase sets up first."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.distributed.get_rank()


def _gmm_counts() -> dict:
    from repro_torch.kernels import moe_gmm as mg
    return {"gmm": mg.GMM_LAUNCHES, "gmm_tc": mg.GMM_TC_LAUNCHES}


def _reset_gmm() -> None:
    from repro_torch.kernels import moe_gmm as mg
    mg.GMM_LAUNCHES = mg.GMM_TC_LAUNCHES = 0


def _host(t):
    return t.detach().cpu()


def dist_moe_params(cfg, mesh, seed: int, keep_whole: bool):
    """One ``moe`` layer's weights in bf16 from ``seed``, distributed by
    the rules; the whole tree too where ``keep_whole``."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import split_tree
    from repro_torch.launch import mesh as mesh_mod
    gen = torch.Generator(device=mesh_mod.local_device()).manual_seed(seed)
    values, axes = split_tree(moe_mod.init_moe(gen, cfg))
    values = tfm._cast(values, torch.bfloat16)
    sharded = tfm.distribute(values, axes, mesh)
    return sharded, (values if keep_whole else None)


def ep_oracle(whole, x, cfg, dp: int, tp: int):
    """(d1)'s oracle on one process: the single-device layer on each
    shard's tokens in turn, kernel off (the per-shard capacity of EP, so
    the same drops); the size of the summed terms of each output (the
    combine's gate-weighted |h| @ |w_down| and the shared experts'); the
    drops per shard; the aux loss (the shards' mean)."""
    import torch
    from repro_torch.models import moe as moe_mod
    mo = cfg.moe
    wg, wu, wd = whole["w_gate"], whole["w_up"], whole["w_down"]
    b, s, d = x.shape
    ys, sizes, drops, auxes = [], [], [], []
    for xs in x.split(b // dp, 0):
        parts = xs.split(s // tp, 1) if s % tp == 0 else [xs]
        row_y, row_size = [], []
        for xm in parts:
            bl, sl, _ = xm.shape
            x2d = xm.reshape(bl * sl, d)
            gates, idx, aux = moe_mod._route(whole, x2d, mo, mo.norm_topk)
            cap = moe_mod._capacity(bl * sl, mo)
            xb, slot, keep = moe_mod._dispatch(x2d, gates, idx, cap,
                                               mo.num_experts)
            gate = torch.einsum("ecd,edf->ecf", xb, wg)
            up = torch.einsum("ecd,edf->ecf", xb, wu)
            h = gate * torch.sigmoid(gate) * up
            yb = torch.einsum("ecf,efd->ecd", h, wd)
            terms = torch.einsum("ecf,efd->ecd", h.float().abs(),
                                 wd.float().abs())
            row_y.append(moe_mod._combine(yb, slot, keep, gates, x.dtype)
                         .reshape(bl, sl, d))
            row_size.append(moe_mod._combine(terms, slot, keep, gates,
                                             torch.float32)
                            .reshape(bl, sl, d))
            drops.append(int((~keep).sum()))
            auxes += [float(aux)] * (1 if s % tp == 0 else tp)
            del gate, up, h, yb, terms, xb
        ys.append(torch.cat(row_y, 1))
        sizes.append(torch.cat(row_size, 1))
    y, size = torch.cat(ys, 0), torch.cat(sizes, 0)
    sp = whole["shared"]
    gate = torch.einsum("bsd,df->bsf", x, sp["w_gate"])
    up = torch.einsum("bsd,df->bsf", x, sp["w_up"])
    h = gate * torch.sigmoid(gate) * up
    y = y + torch.einsum("bsf,fd->bsd", h, sp["w_down"])
    size = size + torch.einsum("bsf,fd->bsd", h.float().abs(),
                               sp["w_down"].float().abs())
    return y, size, drops, sum(auxes) / len(auxes)


def dist_ep(mesh, rank: int) -> dict:
    """(d1): one ``moe`` layer of DeepSeekMoE-16B at full width, bf16, on
    the all-to-all path (x (4, 4096, 2048)) and the psum path (x (4, 1,
    2048)), ``use_kernel=True``, the default capacity factor; rank 0 holds
    the gathered output to the oracle and checks the grouped matmul at
    the EP shape."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import shard_map as sm
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    cfg = ARCHS[DIST_ARCH]
    dev = mesh_mod.local_device()
    dp, tp = sm.dp_size(mesh), sm.axis_size(mesh, "model")
    params, whole = dist_moe_params(cfg, mesh, EP_SEED, rank == 0)
    out = {"local_param_bytes": sum(
        t.to_local().numel() * t.element_size() for t in
        _dtensors(params))}
    for path, seq in (("all_to_all", EP_SEQ), ("psum", 1)):
        gen = torch.Generator(device=dev).manual_seed(EP_SEED + seq)
        x = torch.randn((EP_BATCH, seq, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        xl = sm.local_shard(x, (sm.dp_axes(mesh), None, None), mesh)
        with torch.inference_mode():
            moe_mod.moe_layer(params, xl, cfg, mesh=mesh, use_kernel=True)
            torch.cuda.synchronize()
            torch.distributed.barrier()
            _reset_gmm()                       # the path: counts at 0
            t0 = time.perf_counter()
            y, aux = moe_mod.moe_layer(params, xl, cfg, mesh=mesh,
                                       use_kernel=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = _gmm_counts()           # ... read just after
            sm.reset_comm()
            with sm.timing():
                moe_mod.moe_layer(params, xl, cfg, mesh=mesh,
                                  use_kernel=True)
            comm = {k: dict(v) for k, v in sm.COMM.items()}
            y_all = sm.gather(y, 0, mesh, "data")
        rec = {"seconds": seconds, "launches": launches, "comm": comm,
               "aux": float(aux)}
        if rank == 0:
            with torch.inference_mode():
                want, size, drops, aux_want = ep_oracle(whole, x, cfg, dp,
                                                        tp)
            err = (y_all.float() - want.float()).abs()
            ratio = err / (EP_TOL * size + EP_ABS)
            rec.update(max_abs_err=float(err.max()),
                       worst_over_bound=float(ratio.max()),
                       finite=bool(torch.isfinite(y_all).all()),
                       drops_per_shard=drops, aux_oracle=aux_want,
                       shape=list(y_all.shape))
            del want, size, err, ratio
        out[path] = rec
        if path == "all_to_all" and rank == 0:
            out["gmm_ep"] = ep_gmm_check(params, xl, cfg, mesh)
        elif path == "all_to_all":
            ep_gmm_check(params, xl, cfg, mesh)
        del x, xl, y, y_all
    del params, whole
    torch.cuda.empty_cache()
    return out


def _dtensors(tree):
    from torch.distributed.tensor import DTensor
    for v in tree.values():
        if isinstance(v, dict):
            yield from _dtensors(v)
        elif isinstance(v, DTensor):
            yield v


def ep_gmm_check(params, xl, cfg, mesh):
    """The grouped matmul at the EP shape (E/tp experts, tp*C rows): its
    first call of the all-to-all path recorded, then the kernel against
    its plain version on those inputs (rank 0 times it; the others only
    take part in the recorded layer call)."""
    import torch
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.models import moe as moe_mod
    seen = []

    def record(f):
        def gmm(x, w):
            if not seen:
                seen.append((x.clone(), w.clone()))
            return f(x, w)
        return gmm
    with replaced(mg, "gmm", record), torch.inference_mode():
        moe_mod.moe_layer(params, xl, cfg, mesh=mesh, use_kernel=True)
    torch.cuda.synchronize()
    if torch.distributed.get_rank() != 0:
        torch.distributed.barrier()
        return None
    x, w = seen[0]
    e, c, d = x.shape
    f = w.shape[2]
    tc0 = mg.GMM_TC_LAUNCHES
    got = mg.gmm(x, w)
    if mg.GMM_TC_LAUNCHES != tc0 + 1:
        raise AssertionError("gmm at the EP shape did not take the "
                             "tensor-core route")
    want = mg.gmm_plain(x, w)
    torch.cuda.synchronize()
    err = within(got, want, BF16_TOL)
    flops = 2.0 * e * c * d * f
    nbytes = (x.numel() + w.numel() + got.numel()) * x.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, bound_ms(nbytes)
    row = {"shape": [e, c, d, f], "max_abs_err": err,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           **kernel_times(lambda: mg.gmm(x, w), lambda: mg.gmm_plain(x, w),
                          lambda: torch.bmm(x, w)),
           "route": mg._route(x.dtype, d, f),
           "empty_slots": int((x.abs().amax(dim=2) == 0).sum())}
    row["tflops_per_s"] = flops / row["ms"] / 1e9
    torch.distributed.barrier()
    return row


def _train_cfg(arch: str):
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    layers, _ = DIST_TRAIN[arch]
    cfg = dataclasses.replace(ARCHS[arch], num_layers=layers,
                              microbatches=DIST_TRAIN_MICRO)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def _train_opt():
    from repro_torch.train import optimizer as opt_mod
    return opt_mod.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                               total_steps=DIST_TRAIN_STEPS)


def _train_batch(cfg, step: int, device):
    import numpy as np
    import torch
    _, seq = DIST_TRAIN[cfg.name]
    rng = np.random.default_rng(1000 + step)
    toks = rng.integers(0, cfg.vocab_size, (DIST_TRAIN_BATCH, seq + 1))
    toks = torch.from_numpy(toks.astype(np.int32)).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train_leaves(cfg) -> tuple:
    """The leaves whose updates are checked, and those whose gradients
    alone are (the routed experts' 184M-element ``w_gate``: an update
    check in float64 on the host would take minutes)."""
    if cfg.moe:
        return (("top.ln_f", "layers.1.ffn.w_router", "layers.1.attn.wq"),
                ("layers.1.ffn.w_gate",))
    return ("top.ln_f", "layers.0.rgl.gate_a", "layers.2.attn.wq"), ()


def _update_recorder(records, leaves, whole):
    """Wraps ``apply_updates``: each step's (p, g, m, v) before and (p,
    mu, nu) after of the update leaves, and the gradients of the
    gradient leaves, whole on the host (``whole`` gathers a sharded leaf:
    every rank calls it)."""
    updated, grad_only = leaves

    def wrap(f):
        def apply_updates(params, grads, state, cfg):
            named = dict(params.named_parameters())
            before = {n: tuple(_host(whole(t)) for t in (
                named[n], grads[n], state.mu[n], state.nu[n]))
                for n in updated}
            extra = {n: _host(whole(grads[n])) for n in grad_only}
            out = f(params, grads, state, cfg)
            records.append({
                "step": int(out[1].step), "grad_norm": float(
                    out[2]["grad_norm"]), "before": before, "grads": extra,
                "after": {n: tuple(_host(whole(t)) for t in (
                    named[n], out[1].mu[n], out[1].nu[n]))
                    for n in updated}})
            return out
        return apply_updates
    return wrap


def _whole(t):
    from torch.distributed.tensor import DTensor
    from repro_torch.core import shard_map as sm
    if isinstance(t, DTensor):
        return sm.gather_full(t.to_local().detach(), sm.spec_of(t),
                              t.device_mesh)
    return t.detach()


def train_on(cfg, mesh, device, leaves, moe_layer=None):
    """DIST_TRAIN_STEPS steps of ``make_train_step`` from the seeded
    weights (on ``mesh``, or one device): (losses, grad norms, step
    seconds, update records, model, opt state)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    model = tfm.init_model(cfg, gen, dtype=cfg.activation_dtype, mesh=mesh)
    opt_cfg = _train_opt()
    opt = opt_mod.init_opt_state(model, opt_cfg)
    step = Timed(steps.make_train_step(cfg, opt_cfg, mesh=mesh))
    records, metrics = [], []
    with replaced(opt_mod, "apply_updates",
                  _update_recorder(records, leaves, _whole)):
        if moe_layer is not None:
            with replaced(moe_mod, "moe_layer", lambda f: moe_layer):
                for i in range(DIST_TRAIN_STEPS):
                    opt, m = step(model, opt, _train_batch(cfg, i, device))
                    metrics.append((float(m["loss"]),
                                    float(m["grad_norm"])))
        else:
            for i in range(DIST_TRAIN_STEPS):
                opt, m = step(model, opt, _train_batch(cfg, i, device))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, step.seconds, records, model, opt


def _ckpt_objects(store) -> dict:
    return {k: bytes(store.get(k)) for k in store.list("")}


def dist_train(mesh, rank: int) -> dict:
    """(d2) on the ranks: each model's two sharded steps, then its
    checkpoint saved from (2, 2) and restored onto one device (rank 0)
    and onto a (4, 1) mesh, each saved again for a byte comparison."""
    import torch
    from repro_torch.checkpoint import object_store_ckpt as ckpt
    from repro_torch.core import shard_map as sm
    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    dev = mesh_mod.local_device()
    m41 = mesh_mod.make_local_mesh(4, 1, device_type=DEVICE)
    out = {}
    for arch in DIST_TRAIN:
        t_arch = time.perf_counter()
        cfg = _train_cfg(arch)
        leaves = _train_leaves(cfg)
        sm.reset_comm()
        torch.cuda.reset_peak_memory_stats()
        metrics, seconds, records, model, opt = train_on(cfg, mesh, dev,
                                                         leaves)
        comm = {k: dict(v) for k, v in sm.COMM.items()}
        local = sum(p.to_local().numel() * p.element_size()
                    for p in model.parameters())
        shapes, placements = steps.model_shardings(cfg, mesh)
        rules = 0
        for name, shape in shapes.items():
            n = 1
            for s_ in shape:
                n *= s_
            for size, pl in zip(mesh.shape, placements[name]):
                n //= size if pl.is_shard() else 1
            rules += n * cfg.activation_dtype.itemsize
        rec = {"metrics": metrics, "seconds": seconds, "comm": comm,
               "local_param_bytes": local, "rules_param_bytes": rules,
               "peak": torch.cuda.max_memory_allocated()}
        if arch != DIST_CKPT_ARCH:
            del model, opt
            torch.cuda.empty_cache()
            if rank == 0:
                rec["records"] = records
            rec["phase_s"] = time.perf_counter() - t_arch
            out[arch] = rec
            continue
        store = ObjectStore()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(store, "ckpt", DIST_TRAIN_STEPS, model)
        ckpt.save_checkpoint(store, "ckpt-opt", DIST_TRAIN_STEPS, opt)
        rec["save_s"] = time.perf_counter() - t0
        del model, opt
        torch.cuda.empty_cache()
        # Onto a (4, 1) mesh: restored and saved again.
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
        like = tfm.init_model(cfg, gen, dtype=cfg.activation_dtype, mesh=m41)
        like_opt = opt_mod.init_opt_state(like, _train_opt())
        t0 = time.perf_counter()
        m_r, _ = ckpt.restore_checkpoint(store, "ckpt", like, mesh=m41)
        o_r, _ = ckpt.restore_checkpoint(store, "ckpt-opt", like_opt,
                                         mesh=m41)
        rec["restore_41_s"] = time.perf_counter() - t0
        again = ObjectStore()
        ckpt.save_checkpoint(again, "ckpt", DIST_TRAIN_STEPS, m_r)
        ckpt.save_checkpoint(again, "ckpt-opt", DIST_TRAIN_STEPS, o_r)
        del like, like_opt, m_r, o_r
        torch.cuda.empty_cache()
        if rank == 0:
            saved = _ckpt_objects(store)
            rec["restore_41_equal"] = _ckpt_objects(again) == saved
            # Onto one device (this rank alone: no collective).
            gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 2)
            like = tfm.init_model(cfg, gen, dtype=cfg.activation_dtype)
            like_opt = opt_mod.init_opt_state(like, _train_opt())
            t0 = time.perf_counter()
            m1, _ = ckpt.restore_checkpoint(store, "ckpt", like)
            o1, _ = ckpt.restore_checkpoint(store, "ckpt-opt", like_opt)
            rec["restore_one_s"] = time.perf_counter() - t0
            one = ObjectStore()
            ckpt.save_checkpoint(one, "ckpt", DIST_TRAIN_STEPS, m1)
            ckpt.save_checkpoint(one, "ckpt-opt", DIST_TRAIN_STEPS, o1)
            rec["restore_one_equal"] = _ckpt_objects(one) == saved
            rec["checkpoint_bytes"] = sum(len(v) for v in saved.values())
            rec["records"] = records
            del like, like_opt, m1, o1, one, saved
        del store, again, records
        torch.cuda.empty_cache()
        torch.distributed.barrier()
        rec["phase_s"] = time.perf_counter() - t_arch
        out[arch] = rec
    return out


def dist_serve(mesh, rank: int, serve_layers: int) -> dict:
    """(d3) on the ranks: DeepSeekMoE-16B on the mesh at full width and
    depth (the reckoned cut, if any), 4 requests of 1,024-4,096 tokens in
    one batch, 16 new tokens; then 2 ``moe`` layers, 1,024-token prompts,
    capacity 16: the first prefill's logits (all rows) and the top-k
    expert choices of each token for the parent's comparison."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import shard_map as sm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import ServingEngine
    out = {}
    cfg = dataclasses.replace(ARCHS[DIST_ARCH], num_layers=serve_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, DIST_SERVE_REQUESTS, SERVE_PROMPT,
                        SERVE_PROMPT + DIST_SERVE_NEW, seed=SERVE_SEED,
                        impl="flash_moe", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    local = sum(p.to_local().numel() * p.element_size()
                for p in eng.model.parameters())
    reqs = dist_requests(cfg.vocab_size)
    prefill, decode = Timed(eng.prefill), Timed(eng.decode)
    eng.prefill, eng.decode = prefill, decode
    torch.distributed.barrier()
    _reset_gmm()                                  # the path: counts at 0
    sm.reset_comm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["full"] = {
        "layers": cfg.num_layers, "init_s": init_s, "wall_s": wall,
        "launches": _gmm_counts(),                # ... read just after
        "prefill_s": prefill.seconds, "decode_s": decode.seconds,
        "comm": {k: dict(v) for k, v in sm.COMM.items()},
        "peak": torch.cuda.max_memory_allocated(),
        "local_param_bytes": local,
        "completions": [r.completion.tolist() for r in done],
        "cost": eng.cost_report(wall, len(done))}
    del eng, done
    torch.cuda.empty_cache()

    # Parity: 2 moe layers, 1,024-token prompts, capacity 16.
    pcfg = parity_cfg()
    eng = ServingEngine(pcfg, DIST_SERVE_REQUESTS, DIST_PARITY_PROMPT,
                        DIST_PARITY_PROMPT + DIST_SERVE_NEW,
                        seed=SERVE_SEED, impl="flash_moe", mesh=mesh)
    reqs = parity_requests(pcfg.vocab_size)
    toks = eng._batch_prompts(reqs)
    choices = []

    def record(f):
        def route(params, x2d, mo, norm_topk):
            gates, idx, aux = f(params, x2d, mo, norm_topk)
            choices.append(_host(idx))
            return gates, idx, aux
        return route
    with replaced(moe_mod, "_route", record):
        logits, _ = eng.prefill(eng.model, {"tokens": toks})
    with torch.inference_mode():
        logits = sm.gather(logits, 0, mesh, "data")
    done = eng.serve(reqs)
    out["parity"] = {"logits": _host(logits.float()), "choices": choices,
                     "completions": [r.completion.tolist() for r in done]}
    del eng
    torch.cuda.empty_cache()
    return out


def dist_requests(vocab: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SERVE_SEED)
    lengths = rng.integers(SERVE_MIN_PROMPT, SERVE_PROMPT + 1,
                           DIST_SERVE_REQUESTS)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=DIST_SERVE_NEW)
            for i, n in enumerate(lengths)]


def parity_cfg():
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS[DIST_ARCH]
    return dataclasses.replace(
        cfg, num_layers=1 + DIST_PARITY_MOE_LAYERS,
        moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def parity_requests(vocab: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SERVE_SEED)
    return [Request(i, rng.integers(0, vocab, DIST_PARITY_PROMPT)
                    .astype(np.int32), max_new_tokens=DIST_SERVE_NEW)
            for i in range(DIST_SERVE_REQUESTS)]


def dist_compress(rank: int) -> dict:
    """(d4): the same 4 ranks as (pod 2, data 2); gradient leaves of the
    RecurrentGemma unit's shapes, one at a time, each pod's partial drawn
    from its own seed: the reference test's checks and the int8 wire."""
    import math
    import torch
    from repro_torch.core import shard_map as sm
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train import grad_compression as gc
    mesh = mesh_mod.make_local_mesh(2, 1, pod=2, device_type=DEVICE)
    dev = mesh_mod.local_device()
    pod = sm.axis_index(mesh, "pod")
    shapes = tfm.param_shapes(_train_cfg("recurrentgemma-2b"))
    skipped = {n: s for n, s in shapes.items()
               if math.prod(s) > DIST_COMPRESS_MAX_ELEMENTS}
    shapes = {n: s for n, s in shapes.items() if n not in skipped}
    worst = {"rel": 0.0, "rel9_over_rel": 0.0}
    wire = elems = 0
    err_min = float("inf")
    t0 = time.perf_counter()
    for i, (name, shape) in enumerate(sorted(shapes.items())):
        gen = torch.Generator(device=dev).manual_seed(7000 + 2 * i + pod)
        local = torch.randn((1,) + tuple(shape), generator=gen, device=dev)
        spec = ("pod",) + (None,) * len(shape)
        g = {"g": sm.make_dtensor(local, spec, mesh, (2,) + tuple(shape))}
        want = sm.all_reduce(local[0], mesh, "pod") / 2
        e = {"g": sm.make_dtensor(torch.zeros_like(local), spec, mesh,
                                  (2,) + tuple(shape))}
        sm.reset_comm()
        o, e = gc.compressed_psum(g, e, mesh, axis="pod")
        elems += local[0].numel()
        got = o["g"].to_local()
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        err_min = min(err_min, float(e["g"].to_local().abs().max()))
        acc = got.clone()
        for _ in range(8):
            o, e = gc.compressed_psum(g, e, mesh, axis="pod")
            acc += o["g"].to_local()
        wire += sm.COMM["all_gather"]["bytes"]
        rel9 = float((acc / 9 - want).abs().max()) / scale
        worst["rel"] = max(worst["rel"], rel)
        worst["rel9_over_rel"] = max(worst["rel9_over_rel"], rel9 / rel)
        del local, g, e, o, got, acc, want
    torch.cuda.synchronize()
    return {"leaves": len(shapes), "skipped": skipped,
            "elements": elems, "wire_bytes": wire,
            "seconds": time.perf_counter() - t0, "error_state_min_max":
            err_min, **worst}


def dist_rank_main(serve_layers: int) -> dict:
    """One rank of the distributed phase: (d1)-(d4) on the (2, 2) mesh
    (and the (4, 1) and (2, 2) pod re-meshes of the same ranks);
    ``serve_layers`` is (d3)'s reckoned depth."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    rank = _dist_setup()
    mesh = mesh_mod.make_local_mesh(*DIST_MESH, device_type=DEVICE)
    out = {"device": str(mesh_mod.local_device()),
           "device_name": torch.cuda.get_device_name(0)}
    from repro_torch.core import shard_map as sm
    out["mailbox"] = sm.MAILBOX_BYTES if sm.mailboxes_open() else 0
    t0 = time.perf_counter()
    out["ep"] = dist_ep(mesh, rank)
    out["ep"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train"] = dist_train(mesh, rank)
    out["train_phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = dist_serve(mesh, rank, serve_layers)
    out["serve_phase_s"] = time.perf_counter() - t0
    out["compress"] = dist_compress(rank)
    return out


def nccl_rank_main() -> dict:
    """(d5): one NCCL rank on the card, a (1, 1) mesh: one EP layer call
    (the 1-rank axes make the port's collectives no-ops, so an all-reduce
    on the world group exercises NCCL itself) and one compressed_psum."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import shard_map as sm
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import grad_compression as gc
    _dist_setup()
    mesh = mesh_mod.make_local_mesh(1, 1, device_type=DEVICE)
    dev = mesh_mod.local_device()
    cfg = ARCHS[DIST_ARCH]
    params, whole = dist_moe_params(cfg, mesh, EP_SEED, True)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 64, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    _reset_gmm()                              # the path: counts at 0
    with torch.inference_mode():
        y, _ = moe_mod.moe_layer(params, x, cfg, mesh=mesh, use_kernel=True)
    launches = _gmm_counts()                  # ... read just after
    with torch.inference_mode():
        want, _ = moe_mod.moe_layer(whole, x, cfg, use_kernel=True)
    pmesh = mesh_mod.make_local_mesh(1, 1, pod=1, device_type=DEVICE)
    g = {"g": torch.randn((1, 64, 64), generator=gen, device=dev)}
    o, e = gc.compressed_psum(g, {"g": torch.zeros_like(g["g"])}, pmesh)
    rel = float((o["g"].to_local() - g["g"][0]).abs().max()
                / g["g"].abs().max())
    probe = torch.ones(4, device=dev)
    torch.distributed.all_reduce(probe)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    return {"backend": torch.distributed.get_backend(),
            "device": str(dev), "launches": launches,
            "ep_equal": bool(torch.equal(y, want)),
            "compress_rel": rel, "all_reduce": probe.tolist()}


def dist_plan(card: str) -> dict:
    """(d3)'s depth, reckoned before the run: each rank's weights by the
    rules, its largest gathered layer, its prefill's activations (three
    float32 (B/dp, H, S, S) score tensors of the reference attention,
    the KV caches, the MoE buffers, hidden states) and 1 GiB of CUDA
    context and allocator slack, times the ranks, plus the parent's
    context; ``moe`` layers are cut until the peak leaves 10% of the card
    free."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import steps
    from repro_torch.core.shard_map import MAILBOX_BYTES as MAILBOX
    total = torch.cuda.get_device_properties(0).total_memory
    cfg = ARCHS[DIST_ARCH]
    data, model = DIST_MESH
    dp, world = data, data * model

    class _Mesh:
        axis_names = ("data", "model")

        class devices:
            shape = DIST_MESH

    def rank_bytes(c) -> dict:
        shapes, placements = steps.model_shardings(c, _Mesh())
        local = gathered_layer = 0
        per_layer: dict = {}
        for name, shape in shapes.items():
            n = 1
            for s_ in shape:
                n *= s_
            full = n * 2
            for size, pl in zip(DIST_MESH, placements[name]):
                n //= size if pl.is_shard() else 1
            local += n * 2
            if name.startswith("layers."):
                key = name.split(".")[1]
                expert = ".ffn.w_" in name and "shared" not in name \
                    and "router" not in name and c.moe is not None
                per_layer[key] = per_layer.get(key, 0) + (
                    full // model if expert else full)
        gathered_layer = max(per_layer.values())
        bl, s = DIST_SERVE_REQUESTS // dp, SERVE_PROMPT
        scores = 3 * bl * c.num_heads * s * s * 4
        kv = 2 * bl * (s + DIST_SERVE_NEW) * c.num_kv_heads * c.head_dim \
            * 2 * c.num_layers
        cap = -(-c.moe.top_k * bl * (s // model) * c.moe.capacity_factor
                // c.moe.num_experts)
        moe_buf = 6 * c.moe.num_experts * int(cap) * c.d_model * 2
        hidden = 10 * bl * s * c.d_model * 4
        act = scores + kv + moe_buf + hidden
        return {"weights": local, "gathered_layer": gathered_layer,
                "activations": act,
                "rank_peak": local + gathered_layer + act + 2 ** 30
                + (MAILBOX if DIST_TRANSPORT else 0)}

    layers = cfg.num_layers
    while True:
        c = dataclasses.replace(cfg, num_layers=layers)
        est = rank_bytes(c)
        peak = world * est["rank_peak"] + 2 ** 30
        if peak <= 0.9 * total or layers <= 2:
            break
        layers -= 1
    plan = {"serve_layers": layers, "cut_moe_layers": cfg.num_layers - layers,
            "reckoned_peak_bytes": peak, "card_bytes": total,
            "per_rank": est}
    log("distributed_plan", card=card, mesh=list(DIST_MESH), ranks=world,
        backend="gloo", **plan, published_layers=cfg.num_layers,
        spare=1 - peak / total)
    if peak > 0.9 * total:
        raise AssertionError(f"distributed: {peak} bytes reckoned for "
                             f"{world} ranks on a {total}-byte card")
    return plan


def _shard_choices(choices, world, model):
    """The ranks' recorded top-k choices of each layer, in the global
    token order (B, S, k): rank r = (data d, model m) routed rows of
    batch shard d and sequence slice m."""
    import torch
    layers = len(choices[0])
    out = []
    for li in range(layers):
        rows = []
        for d in range(world // model):
            parts = [choices[d * model + m][li] for m in range(model)]
            rows.append(torch.cat([p.reshape(-1, DIST_PARITY_PROMPT // model,
                                             p.shape[-1]) for p in parts],
                                  1))
        out.append(torch.cat(rows, 0))
    return out


def check_dist_ep(res, card) -> dict:
    """(d1) in the parent: every rank's path times, launches, bytes; rank
    0's comparison with the oracle."""
    launches = {"gmm": 0, "gmm_tc": 0}
    for path in ("all_to_all", "psum"):
        r0 = res[0]["ep"][path]
        a2a = [r["ep"][path]["comm"].get("all_to_all", {}) for r in res]
        log("distributed_ep", card=card, path=path,
            x_shape=[EP_BATCH, EP_SEQ if path == "all_to_all" else 1,
                     r0["shape"][-1]],
            seconds_per_rank=[r["ep"][path]["seconds"] for r in res],
            all_to_all_bytes_per_rank=[a.get("bytes", 0) for a in a2a],
            all_to_all_calls=a2a[0].get("calls", 0),
            comm_rank0=r0["comm"], drops_per_shard=r0["drops_per_shard"],
            max_abs_err=r0["max_abs_err"],
            worst_over_bound=r0["worst_over_bound"], tol=EP_TOL,
            tol_abs=EP_ABS, aux=r0["aux"], aux_oracle=r0["aux_oracle"],
            gmm_launches_per_rank=[r["ep"][path]["launches"] for r in res])
        if not (r0["finite"] and r0["worst_over_bound"] <= 1.0):
            raise AssertionError(f"distributed EP ({path}): "
                                 f"{r0['worst_over_bound']} of the bound")
        if abs(r0["aux"] - r0["aux_oracle"]) > 1e-4 * abs(r0["aux_oracle"]):
            raise AssertionError(f"distributed EP ({path}): aux "
                                 f"{r0['aux']} vs {r0['aux_oracle']}")
        if path == "all_to_all" and a2a[0].get("calls") != 2:
            raise AssertionError("distributed EP: the all-to-all path made "
                                 f"{a2a[0].get('calls')} exchanges")
        for r in res:
            n = r["ep"][path]["launches"]
            if n["gmm"] != 3 or n["gmm_tc"] != n["gmm"]:
                raise AssertionError(f"distributed EP ({path}): gmm "
                                     f"launches {n} (3, all tc, expected)")
            launches["gmm"] += n["gmm"]
            launches["gmm_tc"] += n["gmm_tc"]
    row = res[0]["ep"]["gmm_ep"]
    log("kernel_ep", card=card, name="gmm", **row)
    return launches


def check_dist_train(res, card) -> None:
    """(d2) in the parent: the one-process steps of each model on the same
    weights and batches (DeepSeekMoE with the EP path's per-shard
    routing), against rank 0's records."""
    import math
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    data, model = DIST_MESH
    failed = []
    for arch in DIST_TRAIN:
        cfg = _train_cfg(arch)
        leaves = _train_leaves(cfg)
        mesh_rec = res[0]["train"][arch]
        logit_max = []

        def record_max(f):
            def lm_head(m, c, x, *rest):
                logits = f(m, c, x, *rest)
                with torch.no_grad():
                    logit_max.append(float(torch.maximum(
                        logits.amax(-1), -logits.amin(-1)).mean()))
                return logits
            return lm_head
        layer = moe_mod.per_shard_layer(data, model) if cfg.moe else None
        with replaced(tfm, "_lm_head", record_max):
            metrics, seconds, records, m1, o1 = train_on(
                cfg, None, DEVICE, leaves, moe_layer=layer)
        del m1, o1
        torch.cuda.empty_cache()
        loss_tol = 2.0 ** -7 * sum(logit_max) / len(logit_max)
        got = mesh_rec["metrics"]
        loss_err = [abs(a[0] - b[0]) for a, b in zip(got, metrics)]
        cos = {}
        for step, (ra, rb) in enumerate(zip(mesh_rec["records"], records)):
            for n in leaves[0]:
                cos[f"{n}@{step + 1}"] = cosine(ra["before"][n][1],
                                                rb["before"][n][1])
            for n in leaves[1]:
                cos[f"{n}@{step + 1}"] = cosine(ra["grads"][n],
                                                rb["grads"][n])
        decays = {n: opt_mod.decays(n, mesh_rec["records"][0]["before"][n][0])
                  for n in leaves[0]}
        on_card = [{**r, "before": {n: tuple(t.to(DEVICE) for t in v)
                                    for n, v in r["before"].items()},
                    "after": {n: tuple(t.to(DEVICE) for t in v)
                              for n, v in r["after"].items()}}
                   for r in mesh_rec["records"]]
        upd = check_updates(on_card, _train_opt(), decays)
        del on_card
        log("distributed_train", card=card, arch=arch, mesh=list(DIST_MESH),
            layers=cfg.num_layers, tokens=[DIST_TRAIN_BATCH,
                                           DIST_TRAIN[arch][1]],
            microbatches=cfg.microbatches,
            losses=[m[0] for m in got], losses_one_device=[m[0] for m in
                                                           metrics],
            loss_error=loss_err, loss_tol=loss_tol,
            grad_norms=[m[1] for m in got],
            grad_norms_one_device=[m[1] for m in metrics],
            step_s_per_rank=[r["train"][arch]["seconds"] for r in res],
            step_s_one_device=seconds, gradient_cosine=cos,
            gradient_cosine_min=GRAD_COSINE,
            update_error_over_allowance=upd["worst"],
            comm_rank0=mesh_rec["comm"],
            param_bytes_per_rank=[r["train"][arch]["local_param_bytes"]
                                  for r in res],
            param_bytes_by_rules=mesh_rec["rules_param_bytes"],
            peak_per_rank=[r["train"][arch]["peak"] for r in res])
        if arch == DIST_CKPT_ARCH:
            log("distributed_checkpoint", card=card, arch=arch,
                bytes=mesh_rec["checkpoint_bytes"],
                save_s=mesh_rec["save_s"],
                restore_mesh_4x1_s=mesh_rec["restore_41_s"],
                restore_one_device_s=mesh_rec["restore_one_s"],
                train_phase_s=mesh_rec["phase_s"],
                restore_mesh_4x1_byte_equal=mesh_rec["restore_41_equal"],
                restore_one_device_byte_equal=mesh_rec[
                    "restore_one_equal"])
        if not all(math.isfinite(m[0]) for m in got):
            failed.append(f"{arch}: losses {got}")
        failed += [f"{arch}: step {i + 1} loss off by {e}" for i, e in
                   enumerate(loss_err) if not e <= loss_tol]
        # Step 1 holds both sides' gradients at the same weights; step 2's
        # weights already differ by the two steps' rounding (logged).
        failed += [f"{arch}: gradient cosine of {n}: {c}"
                   for n, c in cos.items()
                   if n.endswith("@1") and not c >= GRAD_COSINE]
        failed += [f"{arch}: update of {k}: {e} allowances" for k, (e, _)
                   in upd["worst"].items() if not e <= 1.0]
        if arch == DIST_CKPT_ARCH and not (
                mesh_rec["restore_41_equal"]
                and mesh_rec["restore_one_equal"]):
            failed.append(f"{arch}: a restored checkpoint is not "
                          "byte-equal")
        for r in res:
            if r["train"][arch]["local_param_bytes"] != \
                    mesh_rec["rules_param_bytes"]:
                failed.append(f"{arch}: a rank holds "
                              f"{r['train'][arch]['local_param_bytes']} "
                              "parameter bytes, not the rules'")
        del records
    if failed:
        raise AssertionError("distributed train: " + "; ".join(failed))


def check_dist_serve(res, card, plan) -> dict:
    """(d3) in the parent: identical completions on every rank, the
    numbers, then the one-process engine's first-token logits and top-k
    choices on the same weights against the mesh's."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import ServingEngine
    full = [r["serve"]["full"] for r in res]
    f0 = full[0]
    dec = sorted(f0["decode_s"])
    comm = {}
    for r in full:
        for k, v in r["comm"].items():
            comm.setdefault(k, []).append(v["bytes"])
    log("distributed_serve", card=card, arch=DIST_ARCH,
        layers=f0["layers"], cut_moe_layers=plan["cut_moe_layers"],
        requests=DIST_SERVE_REQUESTS, new_tokens=DIST_SERVE_NEW,
        init_s=f0["init_s"], wall_s=[r["wall_s"] for r in full],
        prefill_s=f0["prefill_s"], decode_steps=len(dec),
        decode_ms_median=dec[len(dec) // 2] * 1e3,
        decode_ms_min=dec[0] * 1e3, decode_ms_max=dec[-1] * 1e3,
        peak_per_rank=[r["peak"] for r in full],
        param_bytes_per_rank=[r["local_param_bytes"] for r in full],
        collective_bytes_per_rank=comm, cost=f0["cost"],
        gmm_launches_per_rank=[r["launches"] for r in full])
    launches = {"gmm": 0, "gmm_tc": 0}
    moe_layers = f0["layers"] - 1
    for r in full:
        if r["completions"] != f0["completions"]:
            raise AssertionError("distributed serve: ranks differ in their "
                                 "completions")
        n = r["launches"]
        # 3 a moe layer in the one prefill (decode runs the reference
        # route, as in the reference's ``forward_decode``).
        want = 3 * moe_layers
        if n["gmm"] != want or n["gmm_tc"] != n["gmm"]:
            raise AssertionError(f"distributed serve: gmm launches {n}, "
                                 f"{want} on the tc route expected")
        launches["gmm"] += n["gmm"]
        launches["gmm_tc"] += n["gmm_tc"]
    if f0["cost"]["chips"] != DIST_WORLD:
        raise AssertionError(f"distributed serve: cost_report chips "
                             f"{f0['cost']['chips']}")
    for c in f0["completions"]:
        if len(c) != DIST_SERVE_NEW:
            raise AssertionError(f"distributed serve: completion {c}")

    # The one-process engine on the same weights.
    pcfg = parity_cfg()
    eng = ServingEngine(pcfg, DIST_SERVE_REQUESTS, DIST_PARITY_PROMPT,
                        DIST_PARITY_PROMPT + DIST_SERVE_NEW,
                        seed=SERVE_SEED, impl="flash_moe", device=DEVICE)
    reqs = parity_requests(pcfg.vocab_size)
    toks = eng._batch_prompts(reqs)
    choices = []

    def record(f):
        def route(params, x2d, mo, norm_topk):
            gates, idx, aux = f(params, x2d, mo, norm_topk)
            choices.append(_host(idx))
            return gates, idx, aux
        return route
    with replaced(moe_mod, "_route", record):
        logits, _ = eng.prefill(eng.model, {"tokens": toks})
    one = [r.completion.tolist() for r in eng.serve(reqs)]
    logits = _host(logits.float())

    def eng_prefill(cfg, toks):
        return eng.prefill(eng.model, {"tokens": toks})
    par = res[0]["serve"]["parity"]
    mesh_choices = _shard_choices([r["serve"]["parity"]["choices"]
                                   for r in res], DIST_WORLD, DIST_MESH[1])
    differ = 0
    for a, b in zip(mesh_choices, choices):
        b = b.reshape(a.shape)
        differ += int((a.sort(-1).values != b.sort(-1).values)
                      .any(-1).sum())
    err = float((par["logits"] - logits).abs().max())
    same = {}
    if differ:
        # A flipped near-tie moves the logits by more than rounding: hold
        # the one-process engine to the mesh's choices instead.
        replay = RouteLog([c.reshape(-1, c.shape[-1]).to(DEVICE)
                           for c in mesh_choices])
        try:
            again, _ = eng_prefill(pcfg, toks)
        finally:
            replay.restore()
        logits = _host(again.float())
        same = {"same_experts_max_abs_diff": float(
            (par["logits"] - logits).abs().max())}
    diff = same.get("same_experts_max_abs_diff", err)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decided = gap > 2 * diff
    tok_mesh, tok_one = par["logits"].argmax(-1), logits.argmax(-1)
    tol = LOGIT_TOL[DIST_ARCH]
    log("distributed_serve_parity", card=card, moe_layers=pcfg.num_layers - 1,
        prompt=DIST_PARITY_PROMPT, capacity_factor=pcfg.moe.capacity_factor,
        first_token_logit_max_abs_diff=err, tol=tol,
        tokens_differing_in_expert_choice=differ,
        expert_choices=sum(int(c[..., 0].numel()) for c in mesh_choices),
        **same, first_token_mesh=tok_mesh.tolist(),
        first_token_one_process=tok_one.tolist(),
        top1_top2_gap=gap.tolist(), decided=decided.tolist(),
        completions_equal=par["completions"] == one)
    if not diff <= tol or bool((decided & (tok_mesh != tok_one)).any()):
        raise AssertionError(f"distributed serve parity: logits off by "
                             f"{diff} (tol {tol}) on the same expert "
                             f"choices, first tokens {tok_mesh.tolist()} vs "
                             f"{tok_one.tolist()}")
    del eng
    torch.cuda.empty_cache()
    return launches


def check_dist_compress(res, card) -> None:
    c = [r["compress"] for r in res]
    log("distributed_compressed_psum", card=card, mesh=[2, 2],
        axes=["pod", "data"], **c[0],
        wire_bytes_per_rank=[x["wire_bytes"] for x in c],
        bytes_per_element=c[0]["wire_bytes"] / c[0]["elements"] / 9)
    for x in c:
        if not (x["rel"] < 0.02 and x["error_state_min_max"] > 0
                and x["rel9_over_rel"] < 1.0):
            raise AssertionError(f"compressed_psum: {x}")
        # 9 calls a leaf, one int8 byte an element to the one peer.
        if x["wire_bytes"] != 9 * x["elements"]:
            raise AssertionError(f"compressed_psum: {x['wire_bytes']} wire "
                                 f"bytes for {x['elements']} elements")


def run_distributed(card: str) -> dict:
    """The distributed phase: 4 ranks on the card through gloo ((d1)-(d4)),
    then one NCCL rank ((d5)); returns the grouped matmul's launches on
    its paths."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    torch.cuda.empty_cache()
    plan = dist_plan(card)
    t0 = time.perf_counter()
    res = mesh_mod.spawn(dist_rank_main, DIST_WORLD, plan["serve_layers"],
                         backend="gloo", device=DEVICE,
                         timeout=DIST_TIMEOUT, transport=DIST_TRANSPORT)
    log("distributed_ranks", card=card, seconds=time.perf_counter() - t0,
        backend="gloo", transport=DIST_TRANSPORT,
        mailbox_bytes_per_rank=[r["mailbox"] for r in res],
        devices=[r["device"] for r in res],
        ep_s=res[0]["ep"]["phase_s"], train_s=res[0]["train_phase_s"],
        serve_s=res[0]["serve_phase_s"],
        ep_param_bytes_per_rank=[r["ep"]["local_param_bytes"] for r in res])
    if any(not r["device"].startswith(DEVICE) for r in res):
        raise AssertionError(f"distributed: a rank ran on "
                             f"{[r['device'] for r in res]}")
    launches = check_dist_ep(res, card)
    check_dist_compress(res, card)
    t0 = time.perf_counter()
    check_dist_train(res, card)
    t1 = time.perf_counter()
    for k, n in check_dist_serve(res, card, plan).items():
        launches[k] += n
    log("distributed_parent", card=card, train_check_s=t1 - t0,
        serve_check_s=time.perf_counter() - t1)
    del res
    t0 = time.perf_counter()
    (nccl,) = mesh_mod.spawn(nccl_rank_main, 1, backend="nccl",
                             device="cuda", timeout=300)
    log("distributed_nccl", card=card, seconds=time.perf_counter() - t0,
        **nccl)
    if not (nccl["backend"] == "nccl" and nccl["ep_equal"]
            and nccl["compress_rel"] < 0.02 and nccl["all_reduce"] ==
            [1.0] * 4 and nccl["launches"]["gmm"] == 3
            and nccl["launches"]["gmm_tc"] == 3):
        raise AssertionError(f"distributed nccl: {nccl}")
    launches["gmm"] += nccl["launches"]["gmm"]
    launches["gmm_tc"] += nccl["launches"]["gmm_tc"]
    return launches


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

    started = time.perf_counter()
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
    if set(QUERY_PHASES) & set(PHASES):
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
        if wants is None and {"query_serving", "adaptive"} & set(PHASES):
            wants = numpy_results(store, keys)
        # Each path's launches are counted from 0 just before it; the
        # kernel rows carry their sum.
        if "query_serving" in PHASES:
            for k, n in run_query_serving(store, keys, wants).items():
                launches[k] += n
        if "adaptive" in PHASES:
            for k, n in run_adaptive(store, keys, wants).items():
                launches[k] += n
        if "paper" in PHASES:
            for k, n in run_paper(store, keys).items():
                launches[k] += n
        if recorded is not None:
            kernels += check_probes(recorded, launches) \
                + check_segment_reduce(recorded, launches)
        del store, keys, recorded, wants
        log("elapsed", after="query phases",
            seconds=time.perf_counter() - started)
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
        log("elapsed", after="serve", seconds=time.perf_counter() - started)
    if "train" in PHASES:
        run_train(smi)
        run_resume(smi)
        log("elapsed", after="train", seconds=time.perf_counter() - started)
    if "distributed" in PHASES:
        dist = run_distributed(smi)
        for row in kernels:
            if row["name"] == "gmm":
                row["launches"] += dist["gmm"]
        log("elapsed", after="distributed",
            seconds=time.perf_counter() - started)
    if "examples" in PHASES:
        example_launches, example_rows = run_examples()
        for row in kernels:
            row["launches"] += example_launches[row["name"]]
        kernels += example_rows
        log("elapsed", after="examples",
            seconds=time.perf_counter() - started)

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
