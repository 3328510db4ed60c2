"""One benchmark function per paper figure/table (Skyrise reproduction).

Each function returns rows of (name, us_per_call, derived) where
``us_per_call`` is the wall time of producing the artifact (model/simulation
execution time) and ``derived`` is the headline quantity compared against
the paper's published value. ``benchmarks.run`` prints them as CSV and
validates the EXPECT bounds.

The port's copy of ``benchmarks/paper_figures.py``: the same functions,
rows and bounds, with the imports retargeted at ``repro_torch.core``
(whose modules these figures read are the reference's, byte for byte
after the same retargeting). ``repro_torch.bench.run`` prints them.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import (breakeven, burst_planner, partition_scaling,
                              pricing, token_bucket, variability)
from repro_torch.core.storage_service import (LatencyModel, PROFILES,
                                              aggregated_throughput, iops)

MIB = 1024.0 ** 2
GIB = 1024.0 ** 3


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e6, out


def fig05_token_bucket():
    """Fig 5: burst 1.2 GiB/s for ~250 ms; 7.5 MiB/100 ms baseline;
    renewable (shorter) second burst after a 3 s idle."""
    def run():
        b = token_bucket.TokenBucket(token_bucket.LAMBDA_INBOUND)
        trace = b.throughput_trace(8.0, idle_windows=[(2.0, 5.0)])
        ts = np.asarray([t for t, _ in trace])
        bw = np.asarray([x for _, x in trace])
        burst1 = float((bw[(ts < 2.0)] > 1.0 * GIB).sum()) * 0.02
        burst2 = float((bw[(ts > 5.0)] > 1.0 * GIB).sum()) * 0.02
        base = float(np.mean(bw[(ts > 1.0) & (ts < 2.0)]))
        return burst1, burst2, base
    us, (b1, b2, base) = _timed(run)
    return [
        ("fig05/initial_burst_s", us, b1),
        ("fig05/renewed_burst_s", us, b2),
        ("fig05/baseline_mib_s", us, base / MIB),
    ]


def fig06_bursting_vs_vm():
    """Fig 6: EC2 buckets grow with instance size; Lambda's is fixed."""
    rows = []
    for name in ("c6g.medium", "c6g.xlarge", "c6g.4xlarge"):
        inst = pricing.EC2_CATALOG[name]
        cfg = token_bucket.ec2_bucket(inst)
        us, t = _timed(lambda c=cfg: token_bucket.transfer_time(
            c.initial_bytes, c))
        rows.append((f"fig06/{name}/bucket_gib", us,
                     cfg.initial_bytes / GIB))
    us, lam = _timed(lambda: token_bucket.burst_budget_bytes() / MIB)
    rows.append(("fig06/lambda/bucket_mib", us, lam))
    return rows


def fig07_network_scaling():
    """Fig 7: aggregate burst bandwidth scales with function count; a
    customer VPC caps at ~20 GiB/s."""
    def agg(n, vpc):
        per = 1.2 * GIB
        total = n * per
        return min(total, 20 * GIB) if vpc else total
    rows = []
    for n in (32, 128, 256):
        us, free = _timed(lambda n=n: agg(n, False))
        _, vpc = _timed(lambda n=n: agg(n, True))
        rows.append((f"fig07/{n}fns/no_vpc_gib_s", us, free / GIB))
        rows.append((f"fig07/{n}fns/vpc_gib_s", us, vpc / GIB))
    return rows


def fig08_storage_throughput():
    rows = []
    for name, prof in PROFILES.items():
        us, bw = _timed(lambda p=prof: aggregated_throughput(p, 128))
        rows.append((f"fig08/{name}/read_gib_s_128c", us, bw / GIB))
    return rows


def fig09_storage_iops():
    rows = []
    for name, prof in PROFILES.items():
        us, r = _timed(lambda p=prof: iops(p))
        rows.append((f"fig09/{name}/read_iops", us, r))
        rows.append((f"fig09/{name}/write_iops", us,
                     iops(prof, read=False)))
    return rows


def fig10_storage_latency():
    rows = []
    rng = np.random.default_rng(0)
    for name, prof in PROFILES.items():
        model = LatencyModel(prof.read_latency_q)
        us, s = _timed(lambda m=model: m.sample(rng, 1_000_000))
        rows.append((f"fig10/{name}/read_p50_ms", us,
                     float(np.median(s)) * 1e3))
        rows.append((f"fig10/{name}/read_p95_ms", us,
                     float(np.quantile(s, 0.95)) * 1e3))
        rows.append((f"fig10/{name}/read_max_ms", us, float(s.max()) * 1e3))
    return rows


def fig11_iops_scaling():
    us, out = _timed(partition_scaling.simulate_rampup)
    ok = out["ok"]
    err_rate = out["failed"].sum() / (ok.sum() + out["failed"].sum())
    return [
        ("fig11/peak_iops", us, float(ok.max())),
        ("fig11/final_partitions", us, float(out["partitions"].max())),
        ("fig11/error_rate", us, float(err_rate)),
        ("fig11/duration_min", us, float(out["t_min"].max())),
    ]


def fig12_scaling_cost():
    rows = []
    for target, t_want, c_want in ((27500, 26, 25), (50000, 120, 228),
                                   (100000, 540, 1094)):
        us, t = _timed(lambda x=target: partition_scaling.time_to_reach_iops(x))
        _, c = _timed(lambda x=target: partition_scaling.cost_to_reach_iops(x))
        rows.append((f"fig12/{target}iops/minutes", us, t))
        rows.append((f"fig12/{target}iops/usd", us, c))
    return rows


def fig13_downscaling():
    us, _ = _timed(lambda: None)
    return [
        ("fig13/partitions_after_1d", us,
         partition_scaling.partitions_after_idle(5, 24)),
        ("fig13/partitions_after_3d", us,
         partition_scaling.partitions_after_idle(5, 72)),
        ("fig13/partitions_after_5d", us,
         partition_scaling.partitions_after_idle(5, 120)),
    ]


def table5_variability():
    us, t5 = _timed(lambda: variability.table5(runs=400, seed=3))
    return [
        ("table5/eu_cold_mr", us, t5["eu-west-1"]["cold_mr"]),
        ("table5/ap_cold_mr", us, t5["ap-northeast-1"]["cold_mr"]),
        ("table5/us_cold_cov", us, t5["us-east-1"]["cold_cov"]),
        ("table5/us_warm_cov", us, t5["us-east-1"]["warm_cov"]),
    ]


def table7_storage_bei():
    us, t7 = _timed(breakeven.table7)
    return [
        ("table7/ram_ssd_4k_s", us, t7["RAM/SSD"][0]),
        ("table7/ram_s3_4k_d", us, t7["RAM/S3 Standard"][0] / 86400),
        ("table7/ram_s3_16m_s", us, t7["RAM/S3 Standard"][3]),
        ("table7/ssd_s3_4k_d", us, t7["SSD/S3 Standard"][0] / 86400),
        ("table7/ssd_xregion_4k_d", us, t7["SSD/S3 X-Region"][0] / 86400),
    ]


def table8_shuffle_beas():
    us, _ = _timed(breakeven.table8)
    b = breakeven.beas
    return [
        ("table8/c6g_xlarge_mib", us, b("c6g.xlarge") / MIB),
        ("table8/c6gn_xlarge_mib", us, b("c6gn.xlarge") / MIB),
        ("table8/c6gn_reserved_mib", us,
         b("c6gn.xlarge", reserved=True) / MIB),
        ("table8/express_never", us,
         1.0 if b("c6g.xlarge", prices=pricing.S3_EXPRESS) is None else 0.0),
    ]


# Expected bounds: (lo, hi) on 'derived'; paper values inside.
EXPECT = {
    "fig05/initial_burst_s": (0.15, 0.35),
    "fig05/renewed_burst_s": (0.05, 0.30),
    "fig05/baseline_mib_s": (40, 110),
    "fig06/lambda/bucket_mib": (290, 310),
    "fig07/256fns/no_vpc_gib_s": (250, 350),
    "fig07/256fns/vpc_gib_s": (18, 22),
    "fig08/s3-standard/read_gib_s_128c": (230, 270),
    "fig08/dynamodb/read_gib_s_128c": (0.2, 0.5),
    "fig09/s3-standard/read_iops": (7000, 9000),
    "fig09/s3-express/read_iops": (200000, 240000),
    "fig09/dynamodb/read_iops": (14000, 18000),
    "fig10/s3-standard/read_p50_ms": (24, 30),
    "fig10/s3-standard/read_max_ms": (1000, 10200),
    "fig10/s3-express/read_p50_ms": (4, 6),
    "fig11/peak_iops": (24000, 40000),
    "fig11/final_partitions": (5, 8),
    "fig11/error_rate": (0.01, 0.25),
    "fig12/27500iops/minutes": (25, 27),
    "fig12/50000iops/minutes": (115, 125),
    "fig12/50000iops/usd": (220, 236),
    "fig12/100000iops/minutes": (520, 560),
    "fig12/100000iops/usd": (1050, 1140),
    "fig13/partitions_after_1d": (5, 5),
    "fig13/partitions_after_3d": (2, 2),
    "fig13/partitions_after_5d": (1, 1),
    "table5/eu_cold_mr": (1.25, 1.75),
    "table5/ap_cold_mr": (0.8, 1.1),
    "table7/ram_ssd_4k_s": (30, 46),
    "table7/ram_s3_4k_d": (1.9, 2.1),
    "table7/ram_s3_16m_s": (33, 49),
    "table7/ssd_s3_4k_d": (47, 71),
    "table7/ssd_xregion_4k_d": (56, 84),
    "table8/c6g_xlarge_mib": (1.3, 2.7),
    "table8/c6gn_xlarge_mib": (5.5, 8.5),
    "table8/c6gn_reserved_mib": (13, 19),
    "table8/express_never": (1.0, 1.0),
}

ALL = [fig05_token_bucket, fig06_bursting_vs_vm, fig07_network_scaling,
       fig08_storage_throughput, fig09_storage_iops, fig10_storage_latency,
       fig11_iops_scaling, fig12_scaling_cost, fig13_downscaling,
       table5_variability, table7_storage_bei, table8_shuffle_beas]
