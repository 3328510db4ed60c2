"""Cloud pricing catalog and cost calculators (paper Tables 1 and 2).

All AWS prices are the paper's us-east-1 numbers (Feb-Oct 2024). The TPU v5e
entries extend the model to the pod target of this framework (public list
prices, us-central1) so the same break-even machinery (``core.breakeven``)
prices elastic-vs-provisioned TPU jobs.

Units follow the paper: memory in GiB-hours, requests in $/1e6, transfer in
$/GiB, storage in $/GiB-month.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

MIB = 1024 ** 2
GIB = 1024 ** 3

# ---------------------------------------------------------------------------
# Table 1 — compute services
# ---------------------------------------------------------------------------

# AWS Lambda (ARM / Graviton2).
LAMBDA_USD_PER_GIB_S = 1.3334e-5          # 4.80 c/GiB-h top tier
LAMBDA_USD_PER_GIB_S_TIER3 = 1.0667e-5    # 3.84 c/GiB-h (>15B GiB-s/mo tier)
LAMBDA_USD_PER_REQUEST = 2.0e-7           # $0.20 per 1M invocations
LAMBDA_MIB_PER_VCPU = 1769                # 1 vCPU-equivalent per 1,769 MiB
LAMBDA_MIN_MEM_GIB = 0.125
LAMBDA_MAX_MEM_GIB = 10.0
LAMBDA_NET_BASELINE_GBPS = 0.63           # constant across sizes (paper 4.2)
LAMBDA_EPHEMERAL_USD_PER_GIB_MO = 0.0812  # 8.12 c/GiB-mo


@dataclasses.dataclass(frozen=True)
class Ec2Instance:
    """An EC2 instance type (C6g family and friends, paper footnotes 2-6)."""

    name: str
    vcpus: int
    memory_gib: float
    usd_per_hour: float                 # on-demand
    usd_per_hour_reserved: float        # 3yr reserved effective
    net_baseline_gbps: float
    net_burst_gbps: float
    net_bucket_gib: float               # token-bucket capacity (Fig 6)
    ssd_gb: float = 0.0                 # local NVMe (d-variants)
    ssd_read_iops_4k: float = 0.0
    ssd_bw_gib_s: float = 0.0


# C6g / C6gd / C6gn catalog. Network baselines from the EC2 docs the paper
# cites [22]; bucket sizes are the Fig-6 measured burst capacities (burst
# duration ranges 3-45 min in the paper's reruns).
EC2_CATALOG: dict[str, Ec2Instance] = {
    i.name: i
    for i in [
        Ec2Instance("c6g.medium", 1, 2, 0.0340, 0.0219, 0.500, 10.0, 2.6),
        Ec2Instance("c6g.xlarge", 4, 8, 0.1360, 0.0876, 1.25, 10.0, 5.2),
        Ec2Instance("c6g.2xlarge", 8, 16, 0.2720, 0.1752, 2.50, 10.0, 10.4),
        Ec2Instance("c6g.4xlarge", 16, 32, 0.5440, 0.3504, 5.00, 10.0, 20.9),
        Ec2Instance("c6g.8xlarge", 32, 64, 1.0880, 0.7008, 12.0, 12.0, 0.0),
        Ec2Instance("c6g.16xlarge", 64, 128, 2.1760, 1.4016, 25.0, 25.0, 0.0),
        Ec2Instance("c6gd.xlarge", 4, 8, 0.1538, 0.0991, 1.25, 10.0, 5.2,
                    ssd_gb=220, ssd_read_iops_4k=53750, ssd_bw_gib_s=0.25),
        Ec2Instance("c6gd.4xlarge", 16, 32, 0.6152, 0.3963, 5.0, 10.0, 20.9,
                    ssd_gb=880, ssd_read_iops_4k=215000, ssd_bw_gib_s=1.0),
        # 16xlarge carries 2x1900 GB NVMe (~3.52 TB usable) at 2 GiB/s each —
        # the paper's "max SSD bandwidth in EC2 of 2 GiB/s" per-drive cap.
        Ec2Instance("c6gd.16xlarge", 64, 128, 2.4608, 1.5852, 25.0, 25.0, 0.0,
                    ssd_gb=3800, ssd_read_iops_4k=860000, ssd_bw_gib_s=4.0),
        Ec2Instance("c6gn.xlarge", 4, 8, 0.1728, 0.0664, 6.25, 25.0, 20.0),
        Ec2Instance("c6gn.2xlarge", 8, 16, 0.3456, 0.2226, 12.5, 25.0, 40.0),
        Ec2Instance("c6gn.8xlarge", 32, 64, 1.3824, 0.8905, 50.0, 50.0, 0.0),
    ]
}

# EBS gp3 (paper Table 7's RAM/EBS row), provisioned to 16K IOPS and
# 500 MiB/s; the hourly rent includes capacity (1 TB), provisioned IOPS
# ($0.005/IOPS-mo over 3K) and throughput ($0.04/MiB/s-mo over 125).
# These provisioning choices reproduce the paper's 27min/7min/3min row.
EBS_USD_PER_GIB_MO = 0.08
EBS_PROVISIONED_IOPS = 16000.0
EBS_PROVISIONED_BW_MIB_S = 500.0
EBS_VOLUME_USD_PER_H = (0.08 * 1000 + (16000 - 3000) * 0.005
                        + (500 - 125) * 0.04) / (30 * 24)

# ---------------------------------------------------------------------------
# Table 2 — serverless storage services
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StoragePricing:
    name: str
    usd_per_read: float                   # per request
    usd_per_write: float                  # per request
    usd_per_gib_read: float               # transfer fee
    usd_per_gib_write: float
    usd_per_gib_month: float
    request_size_unit_kib: Optional[float] = None  # DynamoDB-style unit pricing
    free_transfer_kib: float = 0.0        # S3 Express: first 512 KiB free


S3_STANDARD = StoragePricing("s3-standard", 4.0e-7, 5.0e-6, 0.0, 0.0, 0.022)
S3_EXPRESS = StoragePricing("s3-express", 2.0e-7, 2.5e-6, 0.0015, 0.008, 0.16,
                            free_transfer_kib=512.0)
DYNAMODB = StoragePricing("dynamodb", 2.5e-7, 1.25e-6, 0.0, 0.0, 0.25,
                          request_size_unit_kib=4.0)
DYNAMODB_WRITE_UNIT_KIB = 1.0
EFS = StoragePricing("efs", 0.0, 0.0, 0.03, 0.06, 0.30)
S3_XREGION_USD_PER_GIB = 0.02             # cross-region transfer (Table 7)

# Memory-grade KV exchange tier (ElastiCache-serverless-class): cheap
# requests, expensive bytes. Transfer fees dominate for bulk shuffles; the
# per-GiB-hour capacity rent ($0.125/GiB-h = $90/GiB-mo) prices residency of
# shuffle intermediates for the duration of a query. This is the tier whose
# break-even against S3 Standard ``core.breakeven.exchange_beas`` computes.
KV_MEMORY_USD_PER_GIB_H = 0.125
KV_MEMORY = StoragePricing("kv-memory", 2.0e-7, 2.5e-7, 0.01, 0.04,
                           KV_MEMORY_USD_PER_GIB_H * 30 * 24)

STORAGE_PRICING = {p.name: p for p in [S3_STANDARD, S3_EXPRESS, DYNAMODB, EFS,
                                       KV_MEMORY]}

# ---------------------------------------------------------------------------
# TPU v5e extension (framework target hardware)
# ---------------------------------------------------------------------------

TPU_V5E_PEAK_BF16_FLOPS = 197e12
TPU_V5E_HBM_GIB = 16.0
TPU_V5E_HBM_BW_GB_S = 819e9
TPU_V5E_ICI_LINK_GB_S = 50e9
TPU_V5E_USD_PER_CHIP_H = 1.20             # on-demand list price
TPU_V5E_USD_PER_CHIP_H_RESERVED = 0.54    # 3y commitment
TPU_V5E_USD_PER_CHIP_H_PREEMPTIBLE = 0.48 # spot — the "serverless-style" tier


# ---------------------------------------------------------------------------
# Cost calculators
# ---------------------------------------------------------------------------

def lambda_vcpus(memory_gib: float) -> float:
    """vCPU-equivalents allocated to a function of the given size."""
    return memory_gib * 1024.0 / LAMBDA_MIB_PER_VCPU


def lambda_memory_for_vcpus(vcpus: float) -> float:
    """GiB needed to get ``vcpus`` vCPU-equivalents (paper workers: 4 vCPU)."""
    return vcpus * LAMBDA_MIB_PER_VCPU / 1024.0


def lambda_cost(memory_gib: float, duration_s: float, invocations: int = 1,
                tier3: bool = False) -> float:
    """Cost of ``invocations`` function runs of ``duration_s`` each."""
    rate = LAMBDA_USD_PER_GIB_S_TIER3 if tier3 else LAMBDA_USD_PER_GIB_S
    compute = memory_gib * duration_s * invocations * rate
    return compute + invocations * LAMBDA_USD_PER_REQUEST


def ec2_cost(instance: str, hours: float, count: int = 1,
             reserved: bool = False) -> float:
    spec = EC2_CATALOG[instance]
    rate = spec.usd_per_hour_reserved if reserved else spec.usd_per_hour
    return rate * hours * count


def storage_request_cost(pricing: StoragePricing, reads: int, writes: int,
                         read_bytes: int = 0, write_bytes: int = 0) -> float:
    """Request + transfer cost of an access pattern against one service."""
    r_units, w_units = float(reads), float(writes)
    if pricing.request_size_unit_kib:  # DynamoDB unit-based pricing
        if reads:
            per = read_bytes / max(reads, 1) / 1024.0
            r_units = reads * max(1.0, math.ceil(per / pricing.request_size_unit_kib))
        if writes:
            per = write_bytes / max(writes, 1) / 1024.0
            w_units = writes * max(1.0, math.ceil(per / DYNAMODB_WRITE_UNIT_KIB))
    cost = r_units * pricing.usd_per_read + w_units * pricing.usd_per_write
    # Transfer fees. S3 Express only charges beyond the first 512 KiB/request.
    free = pricing.free_transfer_kib * 1024.0
    billable_r = max(0.0, read_bytes - free * reads)
    billable_w = max(0.0, write_bytes - free * writes)
    cost += billable_r / GIB * pricing.usd_per_gib_read
    cost += billable_w / GIB * pricing.usd_per_gib_write
    return cost


def storage_capacity_cost(pricing: StoragePricing, gib: float,
                          hours: float) -> float:
    return pricing.usd_per_gib_month * gib * hours / (30 * 24)


def tpu_pod_cost(chips: int, hours: float, tier: str = "on_demand") -> float:
    rate = {
        "on_demand": TPU_V5E_USD_PER_CHIP_H,
        "reserved": TPU_V5E_USD_PER_CHIP_H_RESERVED,
        "preemptible": TPU_V5E_USD_PER_CHIP_H_PREEMPTIBLE,
    }[tier]
    return chips * hours * rate


def cost_per_gib_per_s(pricing: StoragePricing, request_bytes: int,
                       read: bool = True) -> float:
    """c/GiB/s of sustained read/write throughput (paper 4.3.1 comparison)."""
    per_req = storage_request_cost(
        pricing,
        reads=1 if read else 0, writes=0 if read else 1,
        read_bytes=request_bytes if read else 0,
        write_bytes=0 if read else request_bytes)
    return per_req / (request_bytes / GIB) * 100.0
