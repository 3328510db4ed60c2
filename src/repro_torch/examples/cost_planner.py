"""Cost planner: the paper's break-even machinery as a planning tool.

Given a workload description, prints the economic decisions the paper's
Section 5 derives — storage tiering (five-minute-rule variants), shuffle
medium choice (BEAS), FaaS-vs-IaaS deployment, and the TPU-pod extension
(elastic vs reserved) for training jobs. Framework-free: the port's
copy of ``examples/cost_planner.py``.

    PYTHONPATH=src python -m repro_torch.examples.cost_planner
"""
import argparse

from repro_torch.core import breakeven, burst_planner, pricing

MIB = 1024 ** 2
GIB = 1024 ** 3


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    print("=" * 64)
    print("1) Storage tiering (Table 7: break-even access intervals)")
    print("=" * 64)
    t7 = breakeven.table7()
    for row, vals in t7.items():
        cells = " / ".join(breakeven.format_interval(v) for v in vals)
        print(f"  {row:20s} 4KiB/16KiB/4MiB/16MiB: {cells}")
    print("  -> cold (>=hourly) data in S3, MiB-sized accesses;"
          " warm data on VM SSDs (paper §6)")

    print()
    print("=" * 64)
    print("2) Shuffle medium (Table 8: break-even access size)")
    print("=" * 64)
    for inst in ("c6g.xlarge", "c6gn.xlarge"):
        b = breakeven.beas(inst)
        print(f"  {inst}: S3 beats a KV-VM cluster above "
              f"{b / MIB:.1f} MiB/access")
    plan = burst_planner.combine_writes(100 * GIB, 256 * 1024)
    print(f"  write-combining 256 KiB partials -> "
          f"{plan['chosen_access_bytes'] / MIB:.1f} MiB objects "
          f"({plan['objects']:.0f} objects for 100 GiB)")

    print()
    print("=" * 64)
    print("3) Query deployment (Table 6: FaaS break-even throughput)")
    print("=" * 64)
    q6 = breakeven.QueryExecutionStats(
        "q6", 5.2, 5.7, 515.9, 7076 / 1024, 201, invocations=201)
    print(f"  TPC-H Q6: {breakeven.faas_query_cost(q6) * 100:.2f} c/query "
          f"on Lambda; break-even {breakeven.faas_break_even_qph(q6):.0f} "
          f"queries/hour vs a peak-provisioned 201-VM cluster")

    print()
    print("=" * 64)
    print("4) TPU pods (beyond-paper: elastic vs reserved)")
    print("=" * 64)
    ratio = pricing.TPU_V5E_USD_PER_CHIP_H_RESERVED \
        / pricing.TPU_V5E_USD_PER_CHIP_H
    print(f"  reserved/on-demand price ratio: {ratio:.2f} -> a reserved "
          f"256-chip pod pays off above {ratio * 100:.0f}% utilization")
    be = breakeven.tpu_break_even_jobs_per_hour(
        chips=256, job_chip_seconds=256 * 900.0)
    print(f"  a 15-min full-pod finetune job breaks even at "
          f"{be:.1f} jobs/hour — run fewer than that, stay elastic "
          f"(the paper's 'infrequent and peak usage' rule, §6)")


if __name__ == "__main__":
    main()
