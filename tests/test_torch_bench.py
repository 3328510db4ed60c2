"""The port's bench harness and its regression gate on the CPU, at a tiny
size: every section of ``repro_torch.bench.engine_bench`` runs with the
torch backend on ``device="cpu"``; the file it writes holds what
``core.bench_profile`` reads, so the planner's ``torch`` throughput
comes from it; and ``repro_torch.bench.check_regression`` passes and
refuses results exactly as the reference's gate does."""
import importlib.util
import json
import pathlib

import pytest

from repro_torch.bench import check_regression as gate
from repro_torch.bench import engine_bench as eb
from repro_torch.core import bench_profile

REPO = pathlib.Path(__file__).resolve().parents[1]


def _reference(name: str):
    """The reference's ``benchmarks/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_gate = _reference("check_regression")

# Sizes at which every section runs in seconds on the CPU and still
# meets its own inline checks (the tiered plan keeps bulk shuffles on the
# object store, the out-of-core cap spills the join build and flushes the
# agg accumulator more than once).
TINY = dict(
    SERDE_ROWS=5000, SHUFFLE_ROWS=5000, SHUFFLE_PARTITIONS=4,
    PIPELINE_ROWS=20000, JOIN_PROBE_ROWS=20000, JOIN_BUILD_ROWS=5000,
    JOIN_PARTITIONS=4, DUP_PROBE_ROWS=20000, DUP_BUILD_UNIQUE=3000,
    FUSION_ROWS=20000, FUSION_PARTITIONS=4, PLANNING_Q12_ROWS=12000,
    PLANNING_Q12_PARTS=4, ELISION_ROWS=20000, ELISION_ORDERS=5000,
    ELISION_PARTITIONS=4, SERVING_N_QUERIES=4, SERVING_ROWS=12000,
    SERVING_PARTS=6, TIERED_ROWS=150000, TIERED_ORDERS=37500,
    TIERED_PARTS=4, ADAPT_SEEDS=3, OOC_JOIN_PROBE_ROWS=100000,
    OOC_JOIN_BUILD_ROWS=25000, OOC_AGG_ROWS=200000, OOC_CAP_MIB=0.12,
    OOC_OBJECTS=8, OOC_REPEATS=1, FAULT_SEEDS=3, REPEATS=2)

# The keys each section must record (beyond its sizes).
SECTION_KEYS = {
    "pipeline": ("batch_mib", "numpy_s", "torch_s", "copy_s", "speedup"),
    "join_pipeline": ("rows_out", "numpy_s", "torch_s", "copy_s",
                      "speedup"),
    "dup_key_join": ("rows_out", "numpy_s", "torch_s", "copy_s",
                     "speedup"),
    "partition_fusion": ("numpy_s", "torch_s", "copy_s", "speedup"),
    "shuffle_elision": ("elided_model_runtime_s",
                        "unelided_model_runtime_s", "speedup",
                        "cost_ratio"),
    "serde": ("npz_ser_mib_s", "frame_deser_mib_s", "ser_speedup",
              "deser_speedup"),
    "shuffle": ("seed_s", "radix_s", "radix_mib_s", "speedup"),
    "planning": ("q12_lower_s", "q12_runtime_s", "overhead_frac"),
    "concurrent_serving": ("plan_cache_hits", "plan_cache_misses",
                           "plan_cache_hit_rate", "admission", "speedup"),
    "tiered_exchange": ("placed_kv_shuffles", "placed_object_shuffles",
                        "speedup", "cost_vs_all_kv_speedup"),
    "adaptive_chaos": ("static_p99_runtime_s", "adaptive_p99_runtime_s",
                       "p99_speedup", "mean_speedup"),
    "out_of_core": ("join_spill_slowdown", "agg_spill_rounds",
                    "join_vs_numpy_speedup", "join_baseline_copy_s",
                    "agg_mem_reduction_speedup"),
    "fault_recovery": ("kills", "p99_speedup", "mean_speedup"),
}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Every section at the tiny size on the CPU, written to a file."""
    mp = pytest.MonkeyPatch()
    for name, value in TINY.items():
        assert hasattr(eb, name), name
        mp.setattr(eb, name, value)
    out = tmp_path_factory.mktemp("bench") / "BENCH_engine_torch.json"
    try:
        results = eb.run_sections(list(eb.SECTIONS), out, merge=False,
                                  device="cpu")
        yield out, results
    finally:
        mp.undo()


def test_harness_has_every_reference_section():
    ref_bench = _reference("engine_bench")
    assert list(eb.SECTIONS) == list(ref_bench.SECTIONS)
    assert set(SECTION_KEYS) == set(eb.SECTIONS)


@pytest.mark.parametrize("name", list(SECTION_KEYS))
def test_section_runs_on_cpu(tiny, name):
    _, results = tiny
    section = results[name]
    for key in SECTION_KEYS[name]:
        assert key in section, key
    if name != "planning":
        assert gate.collect_speedups(section)
    if "copy_s" in section:
        # The backend ran on the host: there is no copy to the card.
        assert section["copy_s"] == 0.0
        assert section["torch_s"] > 0.0 and section["numpy_s"] > 0.0
    if name == "concurrent_serving":
        n = section["n_queries"]
        assert section["plan_cache_misses"] == 1
        assert section["plan_cache_hits"] == n - 1


def test_written_file_feeds_the_planner(tiny, monkeypatch):
    path, results = tiny
    on_disk = json.loads(path.read_text())
    assert on_disk["device"]["torch_device"] == "cpu"
    assert "nvidia_smi" not in on_disk["device"]
    assert on_disk["config"]["pipeline_rows"] == TINY["PIPELINE_ROWS"]
    pipe = on_disk["pipeline"]
    want = pipe["batch_mib"] * bench_profile.MIB / pipe["torch_s"]
    fallback = 1.0
    assert bench_profile.cpu_bytes_per_s("torch", fallback,
                                         path=str(path)) == want
    monkeypatch.setenv("REPRO_BENCH_PROFILE", str(path))
    bench_profile.clear_cache()
    try:
        assert bench_profile.cpu_bytes_per_s("torch", fallback) == want
        assert want != fallback
    finally:
        bench_profile.clear_cache()


def test_section_option_merges_into_the_file(tmp_path, monkeypatch):
    for name, value in TINY.items():
        monkeypatch.setattr(eb, name, value)
    out = tmp_path / "bench.json"
    out.write_text(json.dumps({"pipeline": {"torch_s": 1.0}}))
    eb.main(["--section", "serde,shuffle", "--device", "cpu",
             "--out", str(out)])
    got = json.loads(out.read_text())
    assert got["pipeline"] == {"torch_s": 1.0}
    assert {"serde", "shuffle", "device", "config"} <= set(got)
    with pytest.raises(SystemExit, match="unknown sections"):
        eb.main(["--section", "nope", "--device", "cpu", "--out",
                 str(out)])


def test_harness_asks_for_the_card_by_default(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eb.main(["--section", "serde", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


# ---------------------------------------------------------------------------
# The gate, against the reference's on the same results
# ---------------------------------------------------------------------------

def _clean() -> dict:
    return {
        "pipeline": {"speedup": 1.4},
        "join_pipeline": {"speedup": 2.0},
        "planning": {"overhead_frac": 0.002},
        "concurrent_serving": {"speedup": 2.0, "n_queries": 8,
                               "plan_cache_hit_rate": 0.875},
        "out_of_core": {"join_spill_slowdown": 1.5,
                        "join_mem_reduction_speedup": 3.0},
        "adaptive_chaos": {"p99_speedup": 1.6},
        "fault_recovery": {"p99_speedup": 1.4, "kills": 3, "ooms": 1,
                           "invoke_fails": 0},
    }


def _with(path: str, value):
    res = _clean()
    sec, key = path.split(".")
    if value is None:
        del res[sec]
    else:
        res[sec][key] = value
    return res


CASES = {
    "clean": (_clean(), None),
    "speedup_below_one": (_with("pipeline.speedup", 0.93), None),
    "below_baseline_tolerance": (_clean(),
                                 {"join_pipeline": {"speedup": 5.0}}),
    "planning_over_one_percent": (_with("planning.overhead_frac", 0.02),
                                  None),
    "missing_required_section": (_with("join_pipeline.speedup", None),
                                 None),
    "plan_cache_misses": (_with("concurrent_serving.plan_cache_hit_rate",
                                0.5), None),
    "spill_too_slow": (_with("out_of_core.join_spill_slowdown", 4.5),
                       None),
    "adaptive_p99": (_with("adaptive_chaos.p99_speedup", 1.2), None),
    "fault_p99": (_with("fault_recovery.p99_speedup", 1.1), None),
    "no_faults_injected": ({**_clean(), "fault_recovery": {
        "p99_speedup": 1.4, "kills": 0, "ooms": 0, "invoke_fails": 0}},
        None),
}
REQUIRED = ["pipeline", "join_pipeline", "out_of_core"]


@pytest.mark.parametrize("case", list(CASES))
def test_gate_judges_as_the_reference(case):
    current, baseline = CASES[case]
    got = gate.check(current, baseline, 0.5, required_sections=REQUIRED)
    assert got == ref_gate.check(current, baseline, 0.5,
                                 required_sections=REQUIRED)
    assert (got == []) == (case == "clean")


@pytest.mark.parametrize("case", ["clean", "speedup_below_one",
                                  "missing_required_section",
                                  "planning_over_one_percent"])
def test_gate_exit_code(case, tmp_path, capsys):
    current, _ = CASES[case]
    path = tmp_path / "current.json"
    path.write_text(json.dumps(current))
    base = tmp_path / "base.json"
    base.write_text(json.dumps(_clean()))
    rc = gate.main(["--current", str(path), "--baseline", str(base),
                    "--require-section", ",".join(REQUIRED)])
    out = capsys.readouterr().out
    assert rc == (0 if case == "clean" else 1)
    assert ("REGRESSIONS" in out) == (case != "clean")
    assert gate.DEFAULT_BENCH.name == "BENCH_engine_torch.json"
