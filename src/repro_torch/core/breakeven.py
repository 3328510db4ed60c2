"""Cost break-even analysis (paper Section 5, Tables 6-8).

Three families of break-evens:

1. ``faas_break_even_qph`` — FaaS-vs-IaaS query throughput break-even
   (Table 6): run rate above which a peak-provisioned VM cluster is cheaper
   than paying per-query function lifetimes.

2. ``bei_capacity`` / ``bei_request`` — the two cloud variants of Gray's
   five-minute rule (Section 5.3.1, Table 7): break-even interval between
   accesses at which caching a page in tier-1 costs the same as re-reading
   it from tier-2. The capacity variant prices tier-2 by rented capacity
   (RAM/SSD/EBS); the request variant prices tier-2 per request (S3, DDB).

3. ``beas`` — break-even access size for object-store shuffles vs a
   provisioned key-value cluster (Section 5.3.2, Table 8): because object
   storage charges per request independent of size, there is an access size
   above which it undercuts VM network capacity.

The exact constants of the paper's spreadsheet are not published; where a
constant is not derivable from Tables 1-2 we solve for it from one published
break-even and reuse it everywhere else (documented inline). Tests assert
the published Table 7/8 values within banded tolerance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import pricing

MIB = 1024.0 ** 2
GIB = 1024.0 ** 3
MB = 1e6  # the paper's formulas are stated per-MB


# ---------------------------------------------------------------------------
# Table 6 — FaaS compute break-even
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryExecutionStats:
    """Execution statistics of one query in both deployments (Table 6)."""

    name: str
    iaas_runtime_s: float
    faas_runtime_s: float
    cumulated_function_time_s: float     # sum of all function lifetimes
    function_memory_gib: float           # 7,076 MiB workers in the paper
    peak_nodes: int                      # peak-provisioned IaaS cluster size
    stage_node_seconds: Optional[list[tuple[int, float]]] = None
    storage_requests: int = 0
    storage_cost_usd: float = 0.0
    invocations: int = 0


def faas_query_cost(stats: QueryExecutionStats, tier3: bool = False) -> float:
    """USD per query on FaaS: aggregated coordinator+worker lifetimes."""
    invocations = stats.invocations or stats.peak_nodes
    return pricing.lambda_cost(stats.function_memory_gib,
                               stats.cumulated_function_time_s /
                               max(invocations, 1),
                               invocations=invocations, tier3=tier3)


def faas_break_even_qph(stats: QueryExecutionStats,
                        vm_instance: str = "c6g.xlarge",
                        reserved: bool = False) -> float:
    """Queries/hour below which FaaS beats a peak-provisioned VM cluster."""
    cluster_per_h = pricing.ec2_cost(vm_instance, 1.0, count=stats.peak_nodes,
                                     reserved=reserved)
    return cluster_per_h / faas_query_cost(stats)


def peak_to_average_nodes(stats: QueryExecutionStats) -> float:
    """Intra-query elasticity headroom (Table 6, bottom)."""
    if not stats.stage_node_seconds:
        raise ValueError("per-stage node counts required")
    total_s = sum(s for _, s in stats.stage_node_seconds)
    avg = sum(n * s for n, s in stats.stage_node_seconds) / max(total_s, 1e-9)
    peak = max(n for n, _ in stats.stage_node_seconds)
    return peak / avg


# ---------------------------------------------------------------------------
# Table 7 — break-even intervals (five-minute rule, cloud variants)
# ---------------------------------------------------------------------------

# Effective RAM rent. Derived from the paper's own RAM / S3-Standard @4KiB
# row (2 days), which depends only on this constant and the S3 GET price:
#   rent = PagesPerMB * price / BEI = (1e6/4096) * 4e-7 / 172800 s
# = 5.65e-10 $/MB/s (~0.21 c/GiB-h). The paper attributes only the
# incremental RAM share of the worker VM to the cache, not Table 1's full
# memory-price band.
RAM_USD_PER_MB_S = (1e6 / 4096.0) * pricing.S3_STANDARD.usd_per_read \
    / (2 * 86400.0)


def bei_capacity(access_bytes: float, *, tier2_accesses_per_s: float,
                 tier2_rent_per_h: float,
                 ram_usd_per_mb_s: float = RAM_USD_PER_MB_S) -> float:
    """Capacity-priced break-even interval (seconds).

    BEI = PagesPerMB / AccessesPerSecondPerDisk
        * RentPerHourPerDisk / RentPerHourPerMBofRAM
    """
    pages_per_mb = MB / access_bytes
    rent_ram_per_mb_h = ram_usd_per_mb_s * 3600.0
    return (pages_per_mb / tier2_accesses_per_s) * \
        (tier2_rent_per_h / rent_ram_per_mb_h)


def bei_request(access_bytes: float, *, usd_per_access: float,
                tier1_usd_per_mb_s: float = RAM_USD_PER_MB_S) -> float:
    """Request-priced break-even interval (seconds).

    BEI = PagesPerMB * PricePerAccessToTier2 / RentPerSecondPerMBofTier1
    """
    pages_per_mb = MB / access_bytes
    return pages_per_mb * usd_per_access / tier1_usd_per_mb_s


def ssd_accesses_per_s(instance: pricing.Ec2Instance,
                       access_bytes: float) -> float:
    """IOPS at a given access size: min(4K IOPS, bandwidth / size).

    Paper: the 2 GiB/s EC2 NVMe bandwidth cap keeps larger-access BEIs flat.
    """
    bw = instance.ssd_bw_gib_s * GIB
    return min(instance.ssd_read_iops_4k, bw / access_bytes)


def ssd_rent_per_h(instance: pricing.Ec2Instance) -> float:
    """Rent attributed to the local NVMe: the d-variant price premium over
    the SSD-less sibling, scaled to the whole instance when no sibling
    exists. (c6gd.xlarge - c6g.xlarge = $0.0178/h for 237 GB.)"""
    sibling = instance.name.replace("c6gd", "c6g")
    if sibling != instance.name and sibling in pricing.EC2_CATALOG:
        return instance.usd_per_hour - pricing.EC2_CATALOG[sibling].usd_per_hour
    return instance.usd_per_hour


def ebs_accesses_per_s(access_bytes: float) -> float:
    bw = pricing.EBS_PROVISIONED_BW_MIB_S * MIB
    return min(pricing.EBS_PROVISIONED_IOPS, bw / access_bytes)


def bei_ram_ssd(access_bytes: float,
                instance_name: str = "c6gd.16xlarge") -> float:
    inst = pricing.EC2_CATALOG[instance_name]
    return bei_capacity(access_bytes,
                        tier2_accesses_per_s=ssd_accesses_per_s(inst, access_bytes),
                        tier2_rent_per_h=ssd_rent_per_h(inst))


def bei_ram_ebs(access_bytes: float) -> float:
    return bei_capacity(access_bytes,
                        tier2_accesses_per_s=ebs_accesses_per_s(access_bytes),
                        tier2_rent_per_h=pricing.EBS_VOLUME_USD_PER_H)


def _request_price(prices: pricing.StoragePricing, access_bytes: float,
                   xregion: bool = False) -> float:
    per = pricing.storage_request_cost(prices, reads=1, writes=0,
                                       read_bytes=int(access_bytes))
    if xregion:
        per += access_bytes / GIB * pricing.S3_XREGION_USD_PER_GIB
    return per


def bei_ram_s3(access_bytes: float, express: bool = False) -> float:
    prices = pricing.S3_EXPRESS if express else pricing.S3_STANDARD
    return bei_request(access_bytes,
                       usd_per_access=_request_price(prices, access_bytes))


# SSD as tier-1: rent per MB-s of local NVMe capacity.
def ssd_usd_per_mb_s(instance_name: str = "c6gd.16xlarge") -> float:
    inst = pricing.EC2_CATALOG[instance_name]
    return ssd_rent_per_h(inst) / 3600.0 / (inst.ssd_gb * 1e3)


def bei_ssd_s3(access_bytes: float, express: bool = False,
               xregion: bool = False,
               instance_name: str = "c6gd.16xlarge") -> float:
    prices = pricing.S3_EXPRESS if express else pricing.S3_STANDARD
    return bei_request(
        access_bytes,
        usd_per_access=_request_price(prices, access_bytes, xregion=xregion),
        tier1_usd_per_mb_s=ssd_usd_per_mb_s(instance_name))


def table7(access_sizes=(4 * 1024, 16 * 1024, 4 * MIB, 16 * MIB)
           ) -> dict[str, list[float]]:
    """The full Table-7 matrix, rows as in the paper, seconds."""
    return {
        "RAM/SSD": [bei_ram_ssd(a) for a in access_sizes],
        "RAM/EBS": [bei_ram_ebs(a) for a in access_sizes],
        "RAM/S3 Standard": [bei_ram_s3(a) for a in access_sizes],
        "RAM/S3 Express": [bei_ram_s3(a, express=True) for a in access_sizes],
        "SSD/S3 Standard": [bei_ssd_s3(a) for a in access_sizes],
        "SSD/S3 Express": [bei_ssd_s3(a, express=True) for a in access_sizes],
        "SSD/S3 X-Region": [bei_ssd_s3(a, xregion=True) for a in access_sizes],
    }


# ---------------------------------------------------------------------------
# Table 8 — break-even access size for shuffles
# ---------------------------------------------------------------------------

def beas(instance_name: str = "c6g.xlarge", reserved: bool = False,
         prices: pricing.StoragePricing = pricing.S3_STANDARD
         ) -> Optional[float]:
    """Break-even access size in bytes; None if storage never breaks even.

    BEAS = PricePerAccess * MBPerHourPerServer / RentPerHourPerServer.
    A per-GiB transfer fee adds a size-proportional term; when that term
    alone exceeds the VM's per-MB network rent, no access size breaks even
    (S3 Express, Table 8).
    """
    inst = pricing.EC2_CATALOG[instance_name]
    rate = inst.usd_per_hour_reserved if reserved else inst.usd_per_hour
    mb_per_h = inst.net_baseline_gbps * 1e9 / 8.0 * 3600.0 / MB
    vm_usd_per_mb = rate / mb_per_h
    transfer_usd_per_mb = prices.usd_per_gib_read * MB / GIB
    if transfer_usd_per_mb >= vm_usd_per_mb:
        return None
    fixed = prices.usd_per_read
    return fixed / (vm_usd_per_mb - transfer_usd_per_mb) * MB


def table8() -> dict[str, Optional[float]]:
    cells = {
        "c6g.xlarge/on-demand": ("c6g.xlarge", False),
        "c6g.8xlarge/on-demand": ("c6g.8xlarge", False),
        "c6gn.xlarge/on-demand": ("c6gn.xlarge", False),
        "c6gn.xlarge/reserved": ("c6gn.xlarge", True),
    }
    out: dict[str, Optional[float]] = {}
    for label, (inst, res) in cells.items():
        out[f"S3 Standard|{label}"] = beas(inst, res, pricing.S3_STANDARD)
        out[f"S3 Express|{label}"] = beas(inst, res, pricing.S3_EXPRESS)
    return out


# ---------------------------------------------------------------------------
# Live planner input: per-shuffle exchange-tier placement (object vs KV)
# ---------------------------------------------------------------------------

# The paper's 7,076 MiB Lambda worker (Table 6) — what one second of a worker
# blocked on an exchange round trip costs. Kept local: importing the
# coordinator here would be circular.
EXCHANGE_WORKER_MEM_GIB = 7076.0 / 1024.0
DEFAULT_WORKER_USD_PER_S = pricing.LAMBDA_USD_PER_GIB_S * EXCHANGE_WORKER_MEM_GIB


@dataclasses.dataclass(frozen=True)
class ExchangePlacement:
    """Outcome of one per-shuffle tier decision, with its inputs preserved
    so the optimizer can emit them as trace lines and ``explain`` can render
    the break-even arithmetic."""

    tier: str                            # "object" | "kv"
    beas_bytes: Optional[float]          # None => KV never breaks even
    access_bytes: Optional[float]        # None => no size estimate
    n_objects: int                       # writers x partitions round trips
    object_usd: Optional[float] = None   # modeled whole-shuffle cost
    kv_usd: Optional[float] = None
    object_s: Optional[float] = None     # modeled per-object round trip
    kv_s: Optional[float] = None
    note: str = ""


def exchange_beas(*,
                  object_prices: pricing.StoragePricing = pricing.S3_STANDARD,
                  kv_prices: pricing.StoragePricing = pricing.KV_MEMORY,
                  object_profile=None, kv_profile=None,
                  worker_usd_per_s: float = DEFAULT_WORKER_USD_PER_S,
                  residency_s: float = 60.0,
                  object_bytes_per_s: Optional[float] = None,
                  kv_bytes_per_s: Optional[float] = None) -> Optional[float]:
    """Break-even access size (bytes/object) below which the KV tier wins.

    Same shape as ``beas`` (Table 8), applied between the two exchange tiers
    instead of storage-vs-VM-network. One shuffle object costs a *fixed*
    per-access amount (write + read request fees, plus the worker-seconds
    burned waiting out each tier's median request latency) and a *marginal*
    per-byte amount (transfer fees, capacity rent over the shuffle's
    residency, worker-seconds per byte at the tier's effective bandwidth).
    The object store's requests are expensive and slow; KV's bytes are
    expensive:

        BEAS = (fixed_object - fixed_kv) / (marginal_kv - marginal_object)

    Returns ``None`` when KV never breaks even (its fixed per-access cost
    already exceeds the object store's, so no access is small enough) and
    ``math.inf`` when KV wins at every size (its per-byte premium is not a
    premium under the given throughput profile).
    """
    from repro_torch.core import storage_service as ss
    obj_prof = object_profile or ss.S3_STANDARD_PROFILE
    kv_prof = kv_profile or ss.KV_MEMORY_PROFILE

    def fixed(prices, prof):
        lat = prof.write_latency_q[0] + prof.read_latency_q[0]
        return prices.usd_per_write + prices.usd_per_read \
            + worker_usd_per_s * lat

    def marginal(prices, prof, bytes_per_s):
        write_bw = bytes_per_s or prof.write_bw_per_client
        read_bw = bytes_per_s or prof.read_bw_per_client
        transfer = (prices.usd_per_gib_read + prices.usd_per_gib_write) / GIB
        rent = pricing.storage_capacity_cost(prices, 1.0 / GIB,
                                             residency_s / 3600.0)
        wait = worker_usd_per_s * (1.0 / write_bw + 1.0 / read_bw)
        return transfer + rent + wait

    advantage = fixed(object_prices, obj_prof) - fixed(kv_prices, kv_prof)
    premium = marginal(kv_prices, kv_prof, kv_bytes_per_s) \
        - marginal(object_prices, obj_prof, object_bytes_per_s)
    if advantage <= 0.0:
        return None
    if premium <= 0.0:
        return math.inf
    return advantage / premium


def _exchange_tier_model(prices: pricing.StoragePricing, prof,
                         worker_usd_per_s: float, total_bytes: float,
                         n_objects: int, residency_s: float,
                         bytes_per_s: Optional[float]) -> tuple[float, float]:
    """(whole-shuffle USD, per-object round-trip seconds) on one tier."""
    write_bw = bytes_per_s or prof.write_bw_per_client
    read_bw = bytes_per_s or prof.read_bw_per_client
    per_obj = total_bytes / max(n_objects, 1)
    rt_s = prof.write_latency_q[0] + prof.read_latency_q[0] \
        + per_obj / write_bw + per_obj / read_bw
    usd = pricing.storage_request_cost(
        prices, reads=n_objects, writes=n_objects,
        read_bytes=int(total_bytes), write_bytes=int(total_bytes))
    usd += pricing.storage_capacity_cost(prices, total_bytes / GIB,
                                         residency_s / 3600.0)
    usd += worker_usd_per_s * rt_s * n_objects
    return usd, rt_s


def place_exchange(shuffle_bytes: Optional[float], writers: int,
                   partitions: int, *,
                   object_prices: pricing.StoragePricing = pricing.S3_STANDARD,
                   kv_prices: pricing.StoragePricing = pricing.KV_MEMORY,
                   object_profile=None, kv_profile=None,
                   worker_usd_per_s: float = DEFAULT_WORKER_USD_PER_S,
                   residency_s: float = 60.0,
                   object_bytes_per_s: Optional[float] = None,
                   kv_bytes_per_s: Optional[float] = None
                   ) -> ExchangePlacement:
    """Choose the exchange tier for one shuffle from its estimated bytes and
    fan-out (request count scales with producer x consumer fragments).

    Degenerate shuffles are handled without special cases: 0 bytes means the
    fixed per-access advantage is the whole story (KV wins if it breaks even
    at all), fan-out 1 just means one round trip. Missing estimates and a
    ``None`` break-even both fall back to the object store with a note —
    never a crash (the optimizer records the note as a trace line).
    """
    from repro_torch.core import storage_service as ss
    obj_prof = object_profile or ss.S3_STANDARD_PROFILE
    kv_prof = kv_profile or ss.KV_MEMORY_PROFILE
    n = max(1, int(writers)) * max(1, int(partitions))
    beas_bytes = exchange_beas(
        object_prices=object_prices, kv_prices=kv_prices,
        object_profile=obj_prof, kv_profile=kv_prof,
        worker_usd_per_s=worker_usd_per_s, residency_s=residency_s,
        object_bytes_per_s=object_bytes_per_s, kv_bytes_per_s=kv_bytes_per_s)

    if shuffle_bytes is None:
        return ExchangePlacement(
            "object", beas_bytes, None, n,
            note="no size estimate -> object store (fallback)")

    total = float(shuffle_bytes)
    access = total / n
    object_usd, object_s = _exchange_tier_model(
        object_prices, obj_prof, worker_usd_per_s, total, n, residency_s,
        object_bytes_per_s)
    kv_usd, kv_s = _exchange_tier_model(
        kv_prices, kv_prof, worker_usd_per_s, total, n, residency_s,
        kv_bytes_per_s)

    if beas_bytes is None:
        tier = "object"
        note = ("kv fixed per-access cost never undercuts the object store "
                "-> object store (fallback)")
    elif access < beas_bytes:
        tier = "kv"
        note = (f"access {access:.0f} B/object < break-even "
                f"{beas_bytes:.0f} B -> kv")
    else:
        tier = "object"
        note = (f"access {access:.0f} B/object >= break-even "
                f"{beas_bytes:.0f} B -> object store")
    return ExchangePlacement(tier, beas_bytes, access, n,
                             object_usd=object_usd, kv_usd=kv_usd,
                             object_s=object_s, kv_s=kv_s, note=note)


def place_exchange_from_bench(shuffle_bytes: Optional[float], writers: int,
                              partitions: int, *,
                              bench_path=None, **kw) -> ExchangePlacement:
    """``place_exchange`` fed with the *measured* per-tier exchange
    throughputs from the committed benchmark profile (the
    ``tiered_exchange`` section), falling back to the service profiles'
    per-client bandwidth when no measurement exists.

    Shared by lowering-time placement (``engine.optimizer``) and runtime
    re-placement at stage boundaries (``engine.adaptive``), so both make
    the decision from the same calibrated inputs.
    """
    from repro_torch.core import bench_profile
    sec = bench_profile.section("tiered_exchange", path=bench_path) or {}
    return place_exchange(
        shuffle_bytes, writers, partitions,
        object_bytes_per_s=sec.get("object_exchange_bytes_per_s"),
        kv_bytes_per_s=sec.get("kv_exchange_bytes_per_s"), **kw)


# ---------------------------------------------------------------------------
# TPU extension: elastic (preemptible, fine-grained) vs reserved pods
# ---------------------------------------------------------------------------

def tpu_break_even_jobs_per_hour(chips: int, job_chip_seconds: float,
                                 elastic_tier: str = "on_demand",
                                 provisioned_tier: str = "reserved") -> float:
    """Jobs/hour below which paying per-job chip-seconds (elastic pool,
    released between jobs) beats holding a reserved pod — the paper's
    Table-6 argument transplanted to TPU pricing."""
    job_cost = pricing.tpu_pod_cost(1, job_chip_seconds / 3600.0,
                                    tier=elastic_tier)
    pod_per_h = pricing.tpu_pod_cost(chips, 1.0, tier=provisioned_tier)
    return pod_per_h / job_cost


def format_interval(seconds: float) -> str:
    """Human format mirroring the paper's table (s / min / h / d)."""
    if seconds < 90:
        return f"{seconds:.0f}s"
    if seconds < 5400:
        return f"{seconds / 60:.0f}min"
    if seconds < 2 * 86400:
        return f"{seconds / 3600:.0f}h"
    return f"{seconds / 86400:.0f}d"
