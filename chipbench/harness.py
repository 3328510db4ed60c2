"""One run of one cell: set-up, the measured window, the traced batches,
the comparison, and the result line.

The system under test is the port's serving engine,
``repro_torch.serve.engine.ServingEngine``, driven through ``serve()`` in
a closed loop of one client: each batch of the cell's requests is handed
to ``serve()`` when the previous one has returned. The engine's two step
callables are wrapped (``StepProbe``) to time them and to keep each step's
highest logits for the comparison; nothing else of the program is
touched.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from chipbench import check
from chipbench import trace as trace_mod
from chipbench.manifest import Cell, reader
from chipbench.peaks import peaks
from chipbench.traffic import Traffic
from chipbench.weights import Weights

# Top-level module names that no run may load: JAX and the JAX package
# this port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Batches served before the window (set-up), and under the profiler after
# it in a ``--trace 1`` run.
WARMUP_BATCHES = 1
TRACE_BATCHES = 3


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among the module ``names``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def arch_config(arch: dict):
    """The engine's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    fields = dict(arch)
    if fields.get("moe") is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    for key in ("block_pattern", "mrope_sections"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return ArchConfig(**fields)


class StepProbe:
    """A step callable of the engine, timed on the host clock between two
    synchronisations, inside a ``chipbench.<kind>`` span; it keeps each
    call's seconds, its token input and its ``check.TOP`` highest logits
    until ``take()``."""

    def __init__(self, fn: Callable, kind: str, sync: Callable):
        self.fn, self.span, self.sync = fn, f"chipbench.{kind}", sync
        self.seconds, self.inputs, self.tops = [], [], []

    def take(self):
        """(seconds, token inputs, top logits) of the calls since the last
        ``take``."""
        got = (self.seconds, self.inputs, self.tops)
        self.seconds, self.inputs, self.tops = [], [], []
        return got

    def __call__(self, model, batch, *args):
        with record_function(self.span):
            self.sync()
            t0 = time.perf_counter()
            logits, caches = self.fn(model, batch, *args)
            self.sync()
            self.seconds.append(time.perf_counter() - t0)
        if isinstance(batch, torch.Tensor):
            self.inputs.append(batch[:, 0].clone())
        self.tops.append(torch.topk(logits, check.TOP, dim=-1))
        return logits, caches


@dataclasses.dataclass
class Batch:
    index: int
    wall: float                  # hand to serve() .. returned, synchronised
    ok: list                     # each request came back with its tokens
    served: np.ndarray           # (B, T) served tokens
    decode_in: np.ndarray        # (B, T) tokens fed to the decode steps
    top_vals: torch.Tensor       # (B, 1 + T, TOP) prefill, then each step
    top_idx: torch.Tensor
    prefill_s: list
    decode_s: list


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    arch: dict
    traffic: Traffic
    reference: object
    setup_s: float
    window_s: float
    batches: list
    peak_bytes: int
    peaks: Optional[dict]
    trace: Optional[trace_mod.Trace] = None


def _serve_batch(engine, traffic: Traffic, stream: str, i: int, probes,
                 sync) -> Batch:
    from repro_torch.serve.engine import Request
    prompts = traffic.prompts(stream, i)
    reqs = [Request(i * traffic.batch + r, p,
                    max_new_tokens=traffic.new_tokens)
            for r, p in enumerate(prompts)]
    with record_function("chipbench.batch"):
        t0 = time.perf_counter()
        done = engine.serve(reqs)
        sync()
        wall = time.perf_counter() - t0
    (p_s, _, p_top), (d_s, d_in, d_top) = probes[0].take(), probes[1].take()
    t = traffic.new_tokens
    ok = [len(done) == len(reqs) and r.completion is not None
          and len(r.completion) == t for r in reqs]
    served = np.stack([np.asarray(r.completion)[:t] if good
                       else np.full(t, -1) for r, good in zip(reqs, ok)])
    tops = p_top + d_top
    return Batch(i, wall, ok, served,
                 torch.stack(d_in, 1).cpu().numpy() if d_in else
                 np.zeros((len(reqs), 0), np.int64),
                 torch.stack([v.values for v in tops], 1),
                 torch.stack([v.indices for v in tops], 1), p_s, d_s)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float, log=None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    from repro_torch.serve.engine import ServingEngine
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ref = cell.reference()
    arch = cell.config["arch"]
    traffic = Traffic(cell.traffic, arch["vocab_size"], seed)
    weights = Weights(ref.weight_groups(arch), seed, dev,
                      getattr(torch, arch["dtype"]))

    engine = ServingEngine(
        arch_config(arch), traffic.batch, traffic.prompt_len,
        traffic.prompt_len + traffic.new_tokens, seed=seed % 2**63,
        impl=cell.config["impl"], device=dev)
    weights.load_into(engine.model)
    probes = (StepProbe(engine.prefill, "prefill", sync),
              StepProbe(engine.decode, "decode", sync))
    engine.prefill, engine.decode = probes
    for i in range(WARMUP_BATCHES):
        _serve_batch(engine, traffic, "warmup", i, probes, sync)
    sync()

    t_open = time.perf_counter()
    batches = []
    while time.perf_counter() - t_open < seconds:
        batches.append(_serve_batch(engine, traffic, "window", len(batches),
                                    probes, sync))
    window_s = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    walls = [b.wall for b in batches]
    log(f"window {window_s:.3f} s, {len(batches)} batches; set-up "
        f"{t_open - t_start:.3f} s; peak {peak} B; batch s min "
        f"{min(walls):.4f} median {np.median(walls):.4f} max "
        f"{max(walls):.4f}; prefill s median "
        f"{np.median([t for b in batches for t in b.prefill_s]):.4f}, "
        f"decode s median "
        f"{np.median([t for b in batches for t in b.decode_s]):.4f}")

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("chipbench.tail"):
                for i in range(TRACE_BATCHES):
                    _serve_batch(engine, traffic, "tail", i, probes, sync)
                sync()
        t0 = time.perf_counter()
        tr = trace_mod.read(prof)
        del prof
        log(f"trace read in {time.perf_counter() - t0:.3f} s: "
            f"{len(tr.ops)} device operations, window {tr.window_s:.3f} s")

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(cell, arch, traffic, ref, t_open - t_start, window_s, batches,
              peak, peaks(kind), tr)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The program's state goes before the reference runs.
    engine.prefill = engine.decode = None
    del engine, probes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = check.judge(cell, arch, weights, traffic, batches, seed, dev)
    log(f"reference: {got['requests']} requests, {got['rows']} logit rows, "
        f"{got['dropped']} + {got['dropped_decode']} routed assignments "
        f"dropped, in {time.perf_counter() - t0:.3f} s")
    verdict = decide(cell, batches, got)

    attempted = sum(len(b.ok) for b in batches)
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": attempted - sum(sum(b.ok) for b in batches),
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": 1,
                         "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = verdict["checks"]
    return result


def decide(cell: Cell, batches: list, got: dict) -> dict:
    """``correct`` and the numbers compared, each beside its limit: every
    request of the window came back with its tokens, each decode step was
    fed the token served before it, as many requests were judged as the
    workload asks (or all that finished), and each reading is within its
    limit."""
    limits = cell.traffic["check"]["limits"]
    done = sum(sum(b.ok) for b in batches)
    want = min(int(cell.traffic["check"]["requests"]), done)
    fed = all((b.decode_in == b.served).all() for b in batches)
    checks = {"failed_requests": {"value": sum(len(b.ok) for b in batches)
                                  - done, "limit": 0},
              "unfed_tokens": {"value": 0 if fed else 1, "limit": 0},
              "unjudged_requests": {"value": max(0, want - got["requests"]),
                                    "limit": 0}}
    for name, limit in limits.items():
        checks[name] = {"value": got["program"].get(name), "limit": limit}
    correct = done > 0 and checks["failed_requests"]["value"] == 0 and fed \
        and got["requests"] >= want and all(
            got["program"].get(n) is not None and got["program"][n] <= lim
            for n, lim in limits.items())
    return {"correct": bool(correct), "checks": checks}
