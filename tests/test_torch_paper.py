"""The port's paper benchmarks against the reference's, on the CPU.

Every row of ``repro_torch.bench.paper_figures.ALL`` and
``paper_queries.ALL`` has the reference's name, in the reference's
order, and its derived value equals the reference's within rtol 1e-9
(integers exactly); ``us_per_call`` is a wall time and is not compared.
Both run under ``test_torch_parity``'s ``mirror_env``: one pinned bench
profile (the reference's ``BENCH_engine.json`` with the port's
``torch_s`` set to ``jit_s``), so Table 6's modeled runtimes of the
port's ``torch`` backend (on ``device="cpu"``) and of the reference's
``jit`` are comparable. The ``EXPECT`` bands equal the reference's, the
port's ``engine_data_plane`` rows carry the reference's names in its
order, and ``repro_torch.bench.run`` exits 1 on a planted band failure.
Also: each ``core`` module ``paper_figures`` reads is the reference's,
byte for byte, once its imports are retargeted (``storage_service``'s
added ``copy_objects`` aside).
"""
import importlib
import json
import pathlib
import re
import sys
import types

import numpy as np
import pytest

from test_torch_parity import REPO, mirror_env, port_source  # noqa: F401

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

RTOL = 1e-9


def _modules(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.bench.{name}"))


def _assert_rows_equal(ref_rows, port_rows):
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows]
    for (name, _, want), (_, _, got) in zip(ref_rows, port_rows):
        if isinstance(want, (int, np.integer)) and \
                isinstance(got, (int, np.integer)):
            assert got == want, name
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), name


FIGURES = [fn.__name__ for fn in _modules("paper_figures")[1].ALL]
QUERIES = [fn.__name__ for fn in _modules("paper_queries")[1].ALL]


@pytest.mark.parametrize("fn", FIGURES)
def test_paper_figure_rows_equal_reference(mirror_env, fn):
    ref, port = _modules("paper_figures")
    _assert_rows_equal(getattr(ref, fn)(), getattr(port, fn)())


@pytest.mark.parametrize("fn", QUERIES)
def test_paper_query_rows_equal_reference(mirror_env, fn):
    ref, port = _modules("paper_queries")
    kw = {"device": "cpu"} if fn == "table6_compute_breakeven" else {}
    _assert_rows_equal(getattr(ref, fn)(), getattr(port, fn)(**kw))


def test_all_lists_follow_the_reference():
    for name in ("paper_figures", "paper_queries"):
        ref, port = _modules(name)
        assert [f.__name__ for f in port.ALL] == \
            [f.__name__ for f in ref.ALL]


@pytest.mark.parametrize("name", ["paper_figures", "paper_queries",
                                  "engine_bench"])
def test_expect_bands_equal_reference(name):
    ref, port = _modules(name)
    assert port.EXPECT == ref.EXPECT


def test_engine_data_plane_rows_follow_the_reference(monkeypatch):
    """The reference's hook over its committed ``BENCH_engine.json`` and
    the port's over its committed ``BENCH_engine_torch.json``: the same
    row names in the same order, each port row read from the port's
    sections (``*_jit_*`` rows from ``torch_s``)."""
    ref, port = _modules("engine_bench")
    ref_results = json.loads((REPO / "BENCH_engine.json").read_text())
    port_results = json.loads((REPO / "BENCH_engine_torch.json")
                              .read_text())
    monkeypatch.setattr(ref, "run_all", lambda: ref_results)
    want = ref.engine_data_plane()
    got = port.data_plane_rows(port_results)
    assert [r[0] for r in got] == [r[0] for r in want]
    rows = {name: (us, derived) for name, us, derived in got}
    pp = port_results["pipeline"]
    assert rows["engine/pipeline_jit_mrows_s"] == \
        (pp["torch_s"] * 1e6, pp["torch_mrows_s"])
    assert rows["engine/shuffle_speedup"][1] == \
        port_results["shuffle"]["speedup"]
    assert [f.__name__ for f in port.ALL] == ["engine_data_plane"]


def _fake(rows, expect, raises=False):
    def bench():
        if raises:
            raise RuntimeError("planted")
        return rows
    return types.SimpleNamespace(ALL=[bench], EXPECT=expect)


def test_run_exits_1_on_a_planted_band_failure(capsys):
    from repro_torch.bench import run
    inside = _fake([("x/ratio", 1.0, 0.5)], {"x/ratio": (0.0, 1.0)})
    run.main([inside])
    assert "# all expected bounds satisfied" in capsys.readouterr().out
    outside = _fake([("x/ratio", 1.0, 1.5), ("x/free", 1.0, 9.0)],
                    {"x/ratio": (0.0, 1.0)})
    with pytest.raises(SystemExit) as exc:
        run.main([inside, outside])
    assert exc.value.code == 1
    captured = capsys.readouterr()
    assert "x/ratio,1.0,1.5" in captured.out      # every row printed
    assert "x/free,1.0,9" in captured.out
    assert "x/ratio: 1.5 not in [0.0, 1.0]" in captured.err
    with pytest.raises(SystemExit) as exc:
        run.main([_fake([], {}, raises=True)])
    assert exc.value.code == 1


# The core modules paper_figures reads, and the one addition the port
# made to them.
FIGURE_CORE = ("breakeven", "burst_planner", "partition_scaling", "pricing",
               "token_bucket", "variability", "storage_service")
ADDED = {"storage_service": "copy_objects"}


def _without_function(src: str, name: str) -> str:
    """``src`` with the top-level function ``name`` cut out."""
    m = re.search(rf"\n\ndef {name}\(.*?(?=\n\n\n|\Z)", src, re.S)
    assert m, name
    return src[:m.start()] + src[m.end():]


@pytest.mark.parametrize("name", FIGURE_CORE)
def test_figure_core_modules_equal_reference(name):
    ref = (REPO / "src" / "repro" / "core" / f"{name}.py").read_text()
    port = (REPO / "src" / "repro_torch" / "core" / f"{name}.py"
            ).read_text()
    if name in ADDED:
        port = _without_function(port, ADDED[name])
    assert port == port_source(ref)


def test_paper_figures_reads_only_those_core_modules():
    import ast
    src = pathlib.Path(_modules("paper_figures")[1].__file__).read_text()
    used = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("repro_torch."):
            if node.module == "repro_torch.core":
                used |= {a.name for a in node.names}
            else:
                used.add(node.module.rsplit(".", 1)[1])
    assert used == set(FIGURE_CORE)
