"""``BENCHMARK.json`` and the files it names keep to the benchmark's
contract: keys, names, units, files under ``paths``, a reader for every
metric, every cell's end-to-end and per-layer metrics, and each
configuration file as the port's registry runs it."""
import json
import math
import pathlib
import re

import pytest

from chipbench.manifest import ROOT, load_cell, load_json, reports

MAN = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "chipbench/run.py"]
    assert MAN["paths"] == ["chipbench"]
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51
    for p in MAN["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
    assert len(json.dumps(MAN)) < 64 * 1024
    cells = len(MAN["workloads"])
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


def test_every_file_under_paths_has_a_name_of_name_characters():
    for f in (ROOT / "chipbench").rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith("chipbench/")
    conf = load_json(ROOT / entry["file"])
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert (ROOT / "chipbench" / "references"
            / f"{conf['reference']}.py").exists()
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_file_is_the_port_registry_config(entry):
    """Every setting the file gives is the port's registered config's."""
    from repro_torch.configs.registry import ARCHS
    from chipbench.harness import arch_config
    arch = load_json(ROOT / entry["file"])["arch"]
    built, reg = arch_config(arch), ARCHS[entry["name"]]
    for key in arch:
        assert getattr(reg, key) == getattr(built, key), key


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda e: e["name"])
def test_workload_entries_and_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(entry[key])
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    cell = load_cell(entry["name"])
    t = cell.traffic
    assert t["batch"] >= 1 and t["new_tokens"] >= 1
    assert set(t["check"]["limits"]) == {"token_gap", "logit_err"}
    for limit in t["check"]["limits"].values():
        assert isinstance(limit, float) and 0 < limit < math.inf
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_cell_pairs_names_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(CELLS)) == len(CELLS)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    e2e = metric in MAN["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "chipbench" / "metrics" / f"{metric['name']}.py").exists()
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        moved = next(m for m in MAN["end_to_end"]
                     if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert reports(moved, cell)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in MAN["per_layer"])


def test_no_file_outside_the_benchmark_is_named():
    for word in MAN["command"][1:]:
        assert pathlib.PurePosixPath(word).parts[0] in MAN["paths"]
