#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the query engine on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printing one line of its numbers:

1. build  — compile the hand-written kernels under
   ``src/repro_torch/csrc/`` (one ``nvcc`` per source, all at once);
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
5. kernels — each kernel's wrapper against its plain PyTorch version on
   the card at the shapes the queries gave it, timed with CUDA events
   (median and spread of five batches) beside its bandwidth bound, the
   plain version and one PyTorch library call.

Ends with the card's name and power limit, a ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``. Any mismatch or exception exits
non-zero without the ``ok`` line. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import pathlib
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
    an untimed query run (the launch count stays the wrapper's own)."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.orig = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None or self.size(args) > self.size(self.args[0]):
            self.args = (tuple(a.clone() for a in args), dict(kwargs))
        return self.orig(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.orig)


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
    hj.PROBE_LAUNCHES = hj.PROBE_RANGE_LAUNCHES = 0
    sr.SEGMENT_REDUCE_LAUNCHES = 0
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
    launches = {"probe": hj.PROBE_LAUNCHES,
                "probe_range": hj.PROBE_RANGE_LAUNCHES,
                "segment_reduce": sr.SEGMENT_REDUCE_LAUNCHES}
    fallbacks = dict(tc.FALLBACK_STATS)
    for name in QUERIES:
        t0 = time.perf_counter()
        want = coords["numpy"].execute(plan_for(name),
                                       query_id=f"{name}-numpy").result
        numpy_s = time.perf_counter() - t0
        check_result(name, results[name], want)
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
        {name: w[1] for name, w in walls.items()}


# Device kernel names of the port's own kernels, as the profiler lists
# them (``probe_range_kernel`` first: it also ends in ``_kernel``).
OWN_KERNELS = (("probe_range", "probe_range_kernel"),
               ("probe", "probe_kernel"),
               ("segment_reduce", "segment_reduce_pass"))


def own_kernel(key: str):
    for name, symbol in OWN_KERNELS:
        if symbol in key:
            return name
    return None


def profile_queries(store, keys, walls):
    """Where a warm query's time goes: device busy time from
    ``torch.profiler`` (kernels and copies) against the warm wall time,
    each of the port's kernels' own device time, and the host functions
    with the most self time under ``cProfile``."""
    import cProfile
    import pstats
    import torch
    from torch.autograd import DeviceType
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
        kernel_us = copy_us = 0.0
        kernel_n = 0
        own = {kname: [0, 0.0] for kname, _ in OWN_KERNELS}
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
                kname = own_kernel(evt.key)
                if kname is not None:
                    own[kname][0] += evt.count
                    own[kname][1] += evt.self_device_time_total / 1e6
        pr = cProfile.Profile()
        pr.enable()
        c.execute(plan_for(name), query_id=f"{name}-cprof")
        torch.cuda.synchronize()
        pr.disable()
        st = pstats.Stats(pr)
        top = sorted(st.stats.items(), key=lambda kv: kv[1][2],
                     reverse=True)[:8]
        wall = walls[name]
        log("profile", name=name, warm_wall_s=wall,
            device_kernel_s=kernel_us / 1e6, device_kernels=kernel_n,
            device_copy_s=copy_us / 1e6,
            own_kernels={k: {"launches": n, "device_s": t}
                         for k, (n, t) in own.items() if n},
            device_idle_share=1.0 - (kernel_us + copy_us) / 1e6 / wall,
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
        scalars, starts = kw["scalars"], kw["starts"]
        n, s = keys.numel(), build.numel()
        if kind == "probe":
            kern = lambda: hj.sorted_probe(build, keys, scalars=scalars,  # noqa: E731
                                           starts=starts)
            plain = lambda: hj.sorted_probe_plain(build, keys, scalars,  # noqa: E731
                                                  starts)
            lib = lambda: torch.searchsorted(build, keys)  # noqa: E731
            out_bytes = 4 + 1
        else:
            kern = lambda: hj.sorted_probe_range(build, keys,  # noqa: E731
                                                 scalars=scalars,
                                                 starts=starts)
            plain = lambda: hj.sorted_probe_range_plain(  # noqa: E731
                build, keys, scalars, starts)
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


def check_segment_reduce(recorded, launches):
    import numpy as np
    import torch
    from repro_torch.kernels import segment_reduce as sr
    (vals, ids), kw = recorded["segment_reduce"]
    num_segments, mode = kw["num_segments"], kw.get("mode", "sum")

    def one(vals, ids, S, mode):
        # The public wrapper, which derives and checks the segment
        # offsets from the ids on the card before its passes.
        kern = lambda: sr.segment_reduce(  # noqa: E731
            vals, ids, num_segments=S, mode=mode)
        plain = lambda: sr.segment_reduce_plain(  # noqa: E731
            vals, ids, S, mode)
        got, want = kern(), plain()
        offsets = sr.segment_offsets(ids, S)
        exact = np.stack([
            np.add.reduceat(v, offsets[:-1]) if mode == "sum" else
            np.diff(offsets).astype(np.float64) if mode == "count" else
            (np.minimum if mode == "min" else np.maximum).reduceat(
                v, offsets[:-1])
            for v in vals.double().cpu().numpy()])
        if not torch.equal(got, want):
            raise AssertionError(f"segment_reduce {mode}: kernel != plain")
        g = got.double().cpu().numpy()
        if mode in ("min", "max"):
            np.testing.assert_array_equal(g, exact.astype(np.float32))
        else:
            np.testing.assert_allclose(g, exact, rtol=RTOL)
        c, n = vals.shape
        n_valid = int(offsets[-1])
        valid_ids = ids[:n_valid].to(torch.int64)
        vt = vals.t().contiguous()
        lib = (lambda: torch.segment_reduce(  # noqa: E731
            vt, "sum" if mode == "count" else mode,
            lengths=torch.bincount(valid_ids, minlength=S), axis=0))
        # Bytes the function must move: every id read once, the valid
        # rows' values once (none in count mode, which reads no values),
        # one float32 result per (column, segment).
        value_bytes = 0 if mode == "count" else 4 * c * n_valid
        return {"max_abs_err": float((got - want).abs().max()),
                "max_rel_err_f64": float((np.abs(g - exact)
                                          / np.abs(exact)).max()),
                "bound_ms": bound_ms(4 * n + value_bytes + 4 * c * S),
                "bound_by": "bytes", **kernel_times(kern, plain, lib),
                "passes": len(sr.reduction_passes(offsets))}

    main = one(vals, ids, num_segments, mode)
    row = {"name": "segment_reduce", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_reduce.cu",
           "replaces": "src/repro/kernels/segment_reduce.py:43",
           "launches": launches["segment_reduce"], **main}
    log("kernel", **row, columns=vals.shape[0], n=vals.shape[1],
        segments=num_segments, mode=mode)
    # Q1's stack of five sum columns at the query's row count, against
    # few and many segments, in every mode.
    n = vals.shape[1]
    rng = np.random.default_rng(0)
    q1 = torch.as_tensor(np.round(rng.uniform(1.0, 1000.0, (5, n)), 2),
                         dtype=torch.float32, device=vals.device)
    for S in (4, 1024):
        sid = torch.as_tensor(np.sort(rng.integers(0, S, n)).astype(np.int32),
                              device=vals.device)
        for m in ("sum", "count", "min", "max"):
            log("kernel_sweep", name="segment_reduce", columns=5, n=n,
                segments=S, mode=m, **one(q1, sid, S, m))
    return [{k: row[k] for k in ROW_KEYS}]


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

    t0 = time.perf_counter()
    report = kbuild.build_all()
    regs = [ln.strip() for r in report.values() for ln in r["log"].splitlines()
            if "registers" in ln]
    log("build", seconds=time.perf_counter() - t0,
        built=sorted(report), ptxas=regs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True
                         ).stdout.strip().splitlines()[0]
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.perf_counter()
    store = ObjectStore()
    keys = {"lineitem": datagen.load_table(store, "lineitem", LINEITEM_ROWS,
                                           1),
            "orders": datagen.load_table(store, "orders", ORDERS_ROWS, 1)}
    log("load", seconds=time.perf_counter() - t0,
        lineitem_rows=LINEITEM_ROWS, orders_rows=ORDERS_ROWS,
        stored_mib=store.total_bytes() / 2**20)

    launches, recorded, warm_walls = run_queries(store, keys)
    profile_queries(store, keys, warm_walls)
    kernels = check_probes(recorded, launches) \
        + check_segment_reduce(recorded, launches)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
