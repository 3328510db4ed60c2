"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration: the ``file`` of its ``configs`` entry, which names its
  plain reference, ``chipbench/references/<reference>.py``;
- a cell's traffic mix: ``chipbench/workloads/<cell>.json``;
- a metric's reader: ``chipbench/metrics/<metric>.py``, whose
  ``read(run)`` returns the metric's value or None.

Adding a configuration, a cell or a metric adds files; nothing here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "chipbench"


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """The Python file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"chipbench_{path.parent.name}_{path.stem}".replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the workload file
    end_to_end: list        # the manifest's metric entries this cell reports
    per_layer: list

    def reference(self):
        return load_module(HERE / "references"
                           / f"{self.config['reference']}.py")


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    man = load_json(root / "BENCHMARK.json")
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in man['workloads']]}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / "chipbench" / "workloads" / f"{name}.json")
    if traffic["traffic"] != entry["traffic"] or \
            config["name"] != entry["config"]:
        raise ValueError(f"{name}: its files name traffic "
                         f"{traffic['traffic']!r} and config "
                         f"{config['name']!r}, the manifest "
                         f"{entry['traffic']!r} and {entry['config']!r}")
    return Cell(name, entry["chips"], config, traffic,
                [m for m in man["end_to_end"] if reports(m, name)],
                [m for m in man["per_layer"] if reports(m, name)])


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py").read
