"""The port's hillclimb, report and H100 roofline benchmark against the
reference's, on the CPU.

``repro_torch.launch.hillclimb``'s iterations (arch, shape, tag, change)
and its two parameter rule sets are the reference's, read from the
reference's source (importing ``repro.launch.hillclimb`` would set
``XLA_FLAGS`` for every later test of the worker). ``report``'s
``dominant``, ``kernelized_terms`` and ``mfu_bound`` are the reference's
formulas on the H100's constants, and ``bench.h100_roofline`` gives the
reference's ``benchmarks/tpu_roofline`` rows, on the same synthetic
records: MFU scaled by the peaks' ratio, memory terms by the bandwidths'.
"""
import json
import sys

import pytest

from repro.launch import report as ref_report
from repro_torch.bench import h100_roofline
from repro_torch.launch import hillclimb, report, roofline
from repro_torch.sharding import rules as shrules
from reference_source import REPO_ROOT, module_values
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from benchmarks import tpu_roofline  # noqa: E402

REF = module_values("repro.launch.hillclimb", "ITERATIONS", "FSDP_RULES",
                    "DP256V2_RULES", "FSDP_ACT_RULES", "ZERO16_ACT_RULES")
TPU_PEAK, TPU_HBM = 197e12, 819e9
MFU_SCALE = TPU_PEAK / roofline.H100_PEAK_BF16_FLOPS


def test_iterations_equal_the_reference():
    got = [(a, s, t, kw) for a, s, t, _, kw in hillclimb.ITERATIONS]
    want = [(a, s, t, kw) for a, s, t, _, kw in REF["ITERATIONS"]]
    assert got == want


def test_param_rule_sets_equal_the_reference():
    assert hillclimb.FSDP_RULES == REF["FSDP_RULES"]
    assert hillclimb.DP256V2_RULES == REF["DP256V2_RULES"]


def test_rule_names_resolve_to_the_reference_sets():
    kw = hillclimb.resolve({"rules": "dp256v2", "act_rules": "fsdp_acts"})
    assert kw["rules"] == REF["DP256V2_RULES"]
    assert kw["act_rules"] == REF["FSDP_ACT_RULES"] \
        == shrules.FSDP_ACT_RULES
    assert hillclimb.resolve({"act_rules": "zero16"})["act_rules"] == \
        REF["ZERO16_ACT_RULES"]


def _record(arch, shape, compute, memory, collective, *, score=0.0,
            kern=None, chips=256, mflops=1e18, status="ok", tag=""):
    rec = {"cell": f"{arch}__{shape}__16x16", "status": status, "tag": tag,
           "arch": arch, "shape": shape, "chips": chips,
           "roofline": {"compute_s": compute, "memory_s": memory,
                        "collective_s": collective,
                        "bytes_per_device": memory * TPU_HBM,
                        "model_flops": mflops},
           "score_bytes_per_device": score}
    if kern is not None:
        rec["roofline_kernelized"] = kern
    return rec


RECORDS = [
    _record("a", "train_4k", 1.0, 3.0, 2.0, score=0.5 * 3.0 * TPU_HBM),
    _record("b", "prefill_32k", 4.0, 1.0, 0.5),
    _record("c", "decode_32k", 0.1, 0.2, 0.9, kern={
        "compute_s": 0.1, "memory_s": 0.05, "collective_s": 0.9,
        "bottleneck": "collective"}),
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["arch"])
def test_report_formulas_are_the_reference_s(rec):
    assert report.dominant(rec["roofline"]) == \
        ref_report.dominant(rec["roofline"])
    got, want = report.kernelized_terms(rec), ref_report.kernelized_terms(rec)
    if "roofline_kernelized" in rec:          # the record's own terms
        assert got == want
    else:                                     # bytes over each bandwidth
        assert got["memory_s"] * roofline.H100_HBM_BYTES_PER_S == \
            pytest.approx(want["memory_s"] * TPU_HBM, rel=1e-12)
    for kern in (False, True):
        if kern and "roofline_kernelized" not in rec:
            continue      # the memory term moved with the bandwidth
        assert report.mfu_bound(rec, kern=kern) == pytest.approx(
            ref_report.mfu_bound(rec, kern=kern) * MFU_SCALE, rel=1e-12)


def test_h100_roofline_rows_match_tpu_roofline(tmp_path, monkeypatch):
    for rec in RECORDS + [_record("d", "train_4k", 1, 1, 1, tag="x"),
                          _record("e", "long_500k", 1, 1, 1,
                                  status="n/a")]:
        name = rec["cell"] + (f"__{rec['tag']}" if rec["tag"] else "")
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(tpu_roofline, "ARTIFACTS", tmp_path)
    want = tpu_roofline.rows()
    got = h100_roofline.rows(artifacts=tmp_path)
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, _, w), (_, _, g) in zip(want, got):
        scale = MFU_SCALE if name.endswith("mfu") or \
            name.endswith("mfu_bound") else 1.0
        assert g == pytest.approx(w * scale, rel=1e-12), name
    assert dict((r[0], r[2]) for r in got)["roofline/cells_analyzed"] == 3
    assert h100_roofline.EXPECT == tpu_roofline.EXPECT


def test_h100_roofline_without_artifacts_has_no_rows(tmp_path):
    assert h100_roofline.rows(artifacts=tmp_path) == []


def test_report_writes_its_own_experiments(tmp_path):
    art = tmp_path / "dryrun"
    art.mkdir()
    for rec in RECORDS:
        rec = dict(rec, memory={"bytes_per_device": 2 ** 30})
        rec["roofline"] = dict(rec["roofline"], model_flops=1e18,
                               useful_flops_ratio=0.5)
        (art / f"{rec['cell']}.json").write_text(json.dumps(rec))
    hill = tmp_path / "hillclimb.json"
    hill.write_text(json.dumps([{
        "arch": "a", "shape": "train_4k", "tag": "blocked",
        "hypothesis": "h", "before": RECORDS[0]["roofline"],
        "after": RECORDS[1]["roofline"], "after_kernelized": None,
        "mem_gib_after": 1.0}]))
    out = tmp_path / "EXPERIMENTS.md"
    report.main(art=art, hill_path=hill, out=out)
    text = out.read_text()
    assert "| a | train_4k | ok | 1.00 |" in text
    assert "### a / train_4k / `blocked` — REFUTED" in text
    assert "| a train_4k |" in text          # the generated headline row
    assert report.OUT != REPO_ROOT / "EXPERIMENTS.md"
