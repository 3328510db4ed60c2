"""Burst- and warm-aware planners (paper 4.5): the two application-level
optimizations the paper demonstrates, packaged as first-class planning APIs.

``plan_scan``      — Fig 14: assign input partitions to workers such that each
                     worker's ingress stays inside its network burst budget
                     (scan-heavy queries were up to 53% faster when it does).
``plan_shuffle``   — Fig 15: size shuffle parallelism against the storage
                     partition IOPS capacity, and decide whether pre-warming
                     (or S3 Express) pays off for the expected request count.

Both are used by the query engine's coordinator and by the training data
pipeline / checkpoint writer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import partition_scaling, pricing, token_bucket

MIB = 1024.0 ** 2


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    workers: int
    partitions_per_worker: int
    bytes_per_worker: float
    within_burst: bool
    expected_bw_per_worker: float
    expected_scan_s: float


def plan_scan(total_bytes: float, partition_bytes: float,
              max_workers: int,
              bucket: token_bucket.TokenBucketConfig = token_bucket.LAMBDA_INBOUND,
              io_efficiency: float = 0.75,
              cpu_bytes_per_s: Optional[float] = None) -> ScanPlan:
    """Choose worker count so per-worker input fits the burst budget.

    ``io_efficiency`` models S3 request handling + decompression overhead vs
    the raw network model (the gap between the model and I/O-stack curves in
    Fig 14). ``cpu_bytes_per_s`` optionally adds the worker's measured
    scan/decode throughput (``core.bench_profile``, fed from
    BENCH_engine.json) to the expected scan time; callers without a
    measurement leave it None and get the pure network model.
    """
    n_parts = max(1, math.ceil(total_bytes / max(partition_bytes, 1.0)))
    budget = token_bucket.burst_budget_bytes(bucket)
    parts_per_worker_burst = max(1, int(budget // max(partition_bytes, 1.0)))
    workers = min(max_workers, math.ceil(n_parts / parts_per_worker_burst))
    ppw = math.ceil(n_parts / workers)
    bpw = ppw * partition_bytes
    bw = token_bucket.effective_throughput(bpw, bucket) * io_efficiency
    scan_s = bpw / bw
    if cpu_bytes_per_s:
        scan_s += bpw / cpu_bytes_per_s
    return ScanPlan(workers=workers, partitions_per_worker=ppw,
                    bytes_per_worker=bpw, within_burst=bpw <= budget,
                    expected_bw_per_worker=bw,
                    expected_scan_s=scan_s)


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    readers: int
    writers: int
    read_requests: int
    expected_shuffle_s: float
    storage: str                    # 's3-standard' | 's3-standard-warm' | 's3-express'
    warm_partitions: int
    request_cost_usd: float
    recommendation: str


def plan_shuffle(rows_stages: tuple[int, int], object_bytes: float,
                 warm_partitions: int = 1,
                 interactive_deadline_s: Optional[float] = 30.0
                 ) -> ShufflePlan:
    """Plan an all-to-all shuffle of stage A (writers) -> stage B (readers)
    through object storage. Every reader fetches its partition range from
    every writer object: requests = writers x readers (paper 4.5.2: 320
    workers -> ~42,000 reads for Q12)."""
    writers, readers = rows_stages
    requests = writers * readers
    iops_cold = partition_scaling.MEASURED_READ_IOPS_FRESH
    iops_warm = warm_partitions * partition_scaling.READ_IOPS_PER_PARTITION
    iops_express = 220000.0

    t_cold = requests / iops_cold
    t_warm = requests / max(iops_warm, iops_cold)
    t_express = requests / iops_express

    cost_std = pricing.storage_request_cost(
        pricing.S3_STANDARD, reads=requests, writes=writers,
        read_bytes=int(readers * writers * object_bytes / max(readers, 1)),
        write_bytes=int(writers * object_bytes))
    cost_express = pricing.storage_request_cost(
        pricing.S3_EXPRESS, reads=requests, writes=writers,
        read_bytes=int(readers * writers * object_bytes / max(readers, 1)),
        write_bytes=int(writers * object_bytes))

    # Scaling IOPS as part of an interactive query takes too long (paper:
    # 26+ minutes); recommend warm reuse when partitions exist, Express when
    # the deadline cannot be met cold.
    if warm_partitions > 1:
        storage, t = "s3-standard-warm", t_warm
        rec = "reuse warmed bucket (IOPS persist days; Fig 13)"
        cost = cost_std
    elif interactive_deadline_s is not None and t_cold > interactive_deadline_s \
            and t_express <= interactive_deadline_s:
        storage, t = "s3-express", t_express
        rec = ("cold-start deadline miss: use S3 Express "
               f"(+{(cost_express - cost_std) * 100:.1f} cents)")
        cost = cost_express
    else:
        storage, t = "s3-standard", t_cold
        rec = ("cold bucket acceptable; sustained workloads should warm "
               f"({partition_scaling.time_to_reach_iops(requests / max(interactive_deadline_s or 30.0, 1e-9)):.0f} min to scale)")
        cost = cost_std
    return ShufflePlan(readers=readers, writers=writers,
                       read_requests=requests, expected_shuffle_s=t,
                       storage=storage, warm_partitions=warm_partitions,
                       request_cost_usd=cost, recommendation=rec)


def combine_writes(total_bytes: float, target_access_bytes: float,
                   instance_name: str = "c6g.xlarge") -> dict[str, float]:
    """Write combining / staged shuffle sizing (paper 5.3.2): pick object
    sizes at or above the break-even access size so object storage beats a
    provisioned KV cluster."""
    from repro_torch.core import breakeven
    b = breakeven.beas(instance_name)
    target = max(target_access_bytes, b or target_access_bytes)
    return {
        "beas_bytes": float(b) if b else float("inf"),
        "chosen_access_bytes": float(target),
        "objects": max(1.0, math.ceil(total_bytes / target)),
        "economical_on_object_store": float(target >= (b or float("inf"))),
    }
