"""Generate ``artifacts/torch/EXPERIMENTS.md`` from the port's dry-run and
hillclimb artifacts (the port of ``repro.launch.report``, which writes
the reference's root ``EXPERIMENTS.md``; this module never touches it).

Hardware constants are the H100's (``launch.roofline``): 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a direction, 80 GB a card.
``dominant``, ``kernelized_terms`` and ``mfu_bound`` keep the
reference's names and formulas on those constants.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[3]
ART = ROOT / "artifacts" / "torch" / "dryrun"
HILL = ROOT / "artifacts" / "torch" / "hillclimb.json"
OUT = ROOT / "artifacts" / "torch" / "EXPERIMENTS.md"

GIB = 2 ** 30
PEAK = roofline.H100_PEAK_BF16_FLOPS
BUDGET = roofline.H100_MEMORY_BYTES


def load(mesh: str, tag: str = "", art: Path = ART):
    out = {}
    for f in sorted(art.glob(f"*__{mesh}{'__' + tag if tag else ''}.json")):
        rec = json.loads(f.read_text())
        if rec.get("tag", "") != tag:
            continue
        out[(rec.get("arch") or rec["cell"].split("__")[0],
             rec.get("shape") or rec["cell"].split("__")[1])] = rec
    return out


def fmt_bytes(b):
    return f"{b / GIB:.2f}"


def dominant(r):
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: r[k])


def kernelized_terms(rec):
    return rec.get("roofline_kernelized") or roofline.kernelized_terms(
        rec["roofline"], rec.get("score_bytes_per_device", 0.0))


def mfu_bound(rec, kern=False):
    r = rec["roofline"]
    t = kernelized_terms(rec) if kern else r
    limit = max(t["compute_s"], t["memory_s"], t["collective_s"])
    ideal = r["model_flops"] / rec["chips"] / PEAK
    return ideal / limit if limit > 0 else float("nan")


def limit_s(t) -> float:
    """The roofline-limited time: the largest of the three terms."""
    return max(t["compute_s"], t["memory_s"], t["collective_s"])


def headline(hill: list, chips: int = 256) -> list[str]:
    """One row per hillclimbed cell: its baseline and best bottleneck and
    MFU bound (as traced, and kernelized), and the winning change."""
    rows, cells = [], {}
    for row in hill:
        cells.setdefault((row["arch"], row["shape"]), []).append(row)
    for (arch, shape), its in cells.items():
        def rec(terms, kern):
            return {"roofline": terms, "roofline_kernelized": kern,
                    "chips": chips}
        base = rec(its[0]["before"], its[0].get("before_kernelized"))
        best = min(its, key=lambda r: limit_s(kernelized_terms(
            rec(r["after"], r.get("after_kernelized")))))
        bk = rec(best["after"], best.get("after_kernelized"))
        rows.append(
            f"| {arch} {shape} | {limit_s(base['roofline']):.4f} s "
            f"{dominant(base['roofline'])[:-2]} | "
            f"{limit_s(bk['roofline']):.4f} s / "
            f"{limit_s(kernelized_terms(bk)):.4f} s kern. | "
            f"{mfu_bound(base):.3f} ({mfu_bound(base, kern=True):.3f}) | "
            f"{mfu_bound(bk):.3f} ({mfu_bound(bk, kern=True):.3f}) | "
            f"`{best['tag']}` |")
    return rows


def main(art: Path = ART, hill_path: Path = HILL, out: Path = OUT) -> None:
    single = load("16x16", art=art)
    multi = load("2x16x16", art=art)
    hill = json.loads(hill_path.read_text()) if hill_path.exists() else []

    L = []
    L.append("# EXPERIMENTS (the PyTorch/CUDA port)\n")
    L.append("All artifacts regenerable: `python -m repro_torch.launch.dryrun "
             "--all --both`, `python -m repro_torch.launch.hillclimb`, "
             "`python -m repro_torch.launch.report`. Hardware constants: "
             "NVIDIA H100 SXM5 datasheet — 989 dense bf16 TFLOP/s, 3.35 "
             "TB/s HBM3, 450 GB/s NVLink a direction, 80 GB a card. Every "
             "term is a count of one rank's traced step over those rates, "
             "not a measured time.\n")
    L.append("## §Paper-validation\n")
    L.append("`python -m repro_torch.bench.run` re-derives every paper "
             "figure and table on the port (Table 6 on the card) and holds "
             "each value to the reference's band.\n")

    # ----- dry run ----------------------------------------------------------
    L.append("## §Dry-run (production meshes, one rank of a fake world)\n")
    L.append("Every (arch x shape) cell traced as rank 0 of a fake "
             "256-rank (16x16) and 512-rank (2x16x16) world on fake "
             "tensors. `long_500k` is n/a by rule for the full-attention "
             "archs. Memory: the tracked peak of live storages a rank "
             f"(budget {BUDGET / 1e9:.0f} GB).\n")
    L.append("| arch | shape | 16x16 | mem/dev GiB | 2x16x16 | mem/dev GiB |")
    L.append("|---|---|---|---|---|---|")
    keys = sorted(set(single) | set(multi))

    def cell(r):
        if r is None:
            return "—", ""
        if r["status"] != "ok":
            return r["status"], ""
        return "ok", fmt_bytes(r["memory"].get("bytes_per_device", 0))
    for k in keys:
        cs, ms_ = cell(single.get(k))
        cm, mm = cell(multi.get(k))
        L.append(f"| {k[0]} | {k[1]} | {cs} | {ms_} | {cm} | {mm} |")
    over = [k for k in keys if single.get(k, {}).get("status") == "ok"
            and single[k]["memory"]["bytes_per_device"] > BUDGET]
    L.append("")
    L.append(f"Cells over the {BUDGET / 1e9:.0f} GB budget on 16x16: "
             + (", ".join(f"{a} {s}" for a, s in over) or "none") + ".\n")

    # ----- roofline ---------------------------------------------------------
    L.append("## §Roofline (single-pod 16x16, per-rank terms in seconds)\n")
    L.append("compute = dot FLOPs / 989 TF; memory = op bytes / 3.35 TB/s; "
             "collective = ring wire bytes / 450 GB/s "
             "(`repro_torch.launch.trace_analysis`). `kern. MFU` also "
             "credits the flash-attention kernel with keeping score "
             "tensors on chip (`score_bytes`).\n")
    L.append("| arch | shape | compute | memory | collective | bottleneck |"
             " MODEL_FLOPS | useful | MFU bound | kern. MFU |")
    L.append("|---|---|---|---|---|---|---|---|---|---|")
    for k in keys:
        rec = single.get(k)
        if rec is None or rec["status"] != "ok":
            continue
        r = rec["roofline"]
        L.append(
            f"| {k[0]} | {k[1]} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{dominant(r)[:-2]} | {r['model_flops']:.2e} | "
            f"{r['useful_flops_ratio']:.2f} | {mfu_bound(rec):.3f} | "
            f"{mfu_bound(rec, kern=True):.3f} |")
    L.append("")

    # ----- perf -------------------------------------------------------------
    L.append("## §Perf (hypothesis -> change -> trace -> verdict)\n")
    L.append("The reference's hillclimb iterations, traced on the port "
             "(`artifacts/torch/hillclimb.json`). Baseline = the untagged "
             "16x16 cell.\n")
    if hill:
        L.append("| cell | baseline bottleneck | best bottleneck | baseline "
                 "MFU (kern.) | best MFU (kern.) | winning change |")
        L.append("|---|---|---|---|---|---|")
        L.extend(headline(hill))
        L.append("")
    for row in hill:
        b, a = row["before"], row["after"]
        bb, aa = limit_s(b), limit_s(a)
        verdict = "CONFIRMED" if aa < bb * 0.95 else (
            "NEUTRAL" if aa < bb * 1.1 else "REFUTED")
        k = row.get("after_kernelized")
        kern = f" (kernelized: {limit_s(k):.4f}s)" if k else ""
        L.append(f"### {row['arch']} / {row['shape']} / `{row['tag']}` — "
                 f"{verdict}")
        L.append(f"*Hypothesis*: {row['hypothesis']}")
        L.append(f"*Traced*: bottleneck {bb:.4f}s -> {aa:.4f}s{kern}; "
                 f"terms after: compute {a['compute_s']:.4f} / memory "
                 f"{a['memory_s']:.4f} / collective "
                 f"{a['collective_s']:.4f}; mem/dev "
                 f"{row['mem_gib_after']:.1f} GiB.\n")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(L))
    print(f"wrote {out} ({len(L)} lines)")


if __name__ == "__main__":
    main()
