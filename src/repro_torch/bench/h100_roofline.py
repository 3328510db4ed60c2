"""Roofline benchmark on the H100 (the port of
``benchmarks/tpu_roofline.py``): reads the dry run's artifacts
(``artifacts/torch/dryrun/``) and reports each cell's bottleneck term
and the roofline fraction of the dominant term against MODEL_FLOPS.
Re-derivation only: tracing happens in ``repro_torch.launch.dryrun``.
With no artifacts it reports no rows."""
from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.launch import roofline

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "torch" \
    / "dryrun"


def load_cells(mesh: str = "16x16", artifacts: Path | None = None
               ) -> list[dict]:
    cells = []
    for f in sorted((artifacts or ARTIFACTS).glob(f"*__{mesh}.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") == "ok" and not rec.get("tag"):
            cells.append(rec)
    return cells


def mfu_upper_bound(rec: dict) -> float:
    """Achievable-MFU upper bound implied by the three-term roofline:
    MODEL_FLOPS runtime at the H100's peak / roofline-limited runtime."""
    r = rec["roofline"]
    limit = max(r["compute_s"], r["memory_s"], r["collective_s"])
    ideal = r["model_flops"] / rec["chips"] / roofline.H100_PEAK_BF16_FLOPS
    return ideal / limit if limit else 0.0


def rows(artifacts: Path | None = None) -> list[tuple]:
    t0 = time.perf_counter()
    cells = load_cells(artifacts=artifacts)
    us = (time.perf_counter() - t0) * 1e6
    out = []
    for rec in cells:
        r = rec["roofline"]
        name = f"roofline/{rec['arch']}/{rec['shape']}"
        out.append((f"{name}/bottleneck_s", us,
                    max(r["compute_s"], r["memory_s"], r["collective_s"])))
        out.append((f"{name}/mfu_bound", us, mfu_upper_bound(rec)))
    if cells:
        worst = min(cells, key=mfu_upper_bound)
        out.append(("roofline/cells_analyzed", us, float(len(cells))))
        out.append(("roofline/worst_cell_mfu", us, mfu_upper_bound(worst)))
    return out


EXPECT = {
    "roofline/cells_analyzed": (30, 34),
}

ALL = [rows]
