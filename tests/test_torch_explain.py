"""``repro_torch.engine.explain`` against the reference's explainer: for
every paper query, with and without planner statistics and a memory
budget, on ``numpy``/``numpy`` and ``jit``/``torch`` under one pinned
profile, the text is the reference's but for the backend's name; so is
the CLI's output, run as ``python -m repro_torch.engine.explain``, and
the compiled-plan cache state it reports after a run."""
import os
import subprocess
import sys

import pytest

from repro.core.storage_service import ObjectStore as RefStore
from repro.engine import datagen as rdatagen
from repro.engine import explain as rexplain
from repro.engine import optimizer as roptimizer
from repro.engine import queries as rqueries
from repro.engine.coordinator import Coordinator as RefCoordinator
from repro_torch.core.storage_service import ObjectStore, copy_objects
from repro_torch.engine import explain as texplain
from repro_torch.engine import optimizer as toptimizer
from repro_torch.engine import queries as tqueries
from repro_torch.engine.coordinator import Coordinator
from test_torch_parity import REPO, explain_as_port, mirror_env  # noqa: F401

PAIRS = [("numpy", "numpy"), ("jit", "torch")]
PAIR_IDS = ["numpy", "jit-torch"]
MIB = 1024.0 * 1024.0


@pytest.mark.parametrize("backends", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("query", sorted(rqueries.LOGICAL_BUILDERS))
def test_explain_text_is_the_reference(mirror_env, query, backends):
    rb, tb = backends
    ref = rexplain.explain(rqueries.LOGICAL_BUILDERS[query](), backend=rb)
    got = texplain.explain(tqueries.LOGICAL_BUILDERS[query](), backend=tb)
    assert got == (explain_as_port(ref) if rb == "jit" else ref)
    assert got.startswith("query: ") and "physical plan" in got


@pytest.mark.parametrize("backends", PAIRS, ids=PAIR_IDS)
def test_explain_with_stats_and_budget_is_the_reference(mirror_env,
                                                        backends):
    rb, tb = backends
    sizes = {"lineitem": 4096.0 * MIB, "orders": 1024.0 * MIB}
    for budget in (None, 64.0 * MIB):
        ref = rexplain.explain(rqueries.q12_logical(),
                               stats=roptimizer.Stats(dict(sizes)),
                               backend=rb, memory_budget=budget)
        got = texplain.explain(tqueries.q12_logical(),
                               stats=toptimizer.Stats(dict(sizes)),
                               backend=tb, memory_budget=budget)
        assert got == (explain_as_port(ref) if rb == "jit" else ref)
        assert ("memory" in got) == (budget is not None)


@pytest.mark.parametrize("argv", [
    ["tpch_q12"], ["tpch_q1", "--backend", "numpy"],
    ["tpch_q12", "--table-mib", "lineitem=4096", "--table-mib",
     "orders=1024", "--memory-budget", "64"], ["--list"]])
def test_cli_prints_the_reference(mirror_env, capsys, argv):
    assert rexplain.main(argv) == 0
    ref = capsys.readouterr().out
    assert texplain.main(argv) == 0
    got = capsys.readouterr().out
    assert got == explain_as_port(ref)


def test_cli_rejects_unknown_query_and_jit(capsys):
    assert texplain.main(["tpch_q99"]) == 2
    assert "unknown query" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        texplain.main(["tpch_q12", "--backend", "jit"])


def test_python_m_runs_without_a_card_or_warning(mirror_env):
    """The module runs as a script on a machine without a card (it only
    lowers the plan) and without runpy's already-imported warning; its
    text is the reference's."""
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep
               + os.environ.get("PYTHONPATH", ""), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "repro_torch.engine.explain", "tpch_q12"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ref = rexplain.explain(rqueries.q12_logical(), backend="jit")
    assert out.stdout == explain_as_port(ref) + "\n"


def test_engine_package_loads_explain_lazily():
    import importlib

    import repro_torch.engine as eng
    assert eng.explain is importlib.import_module(
        "repro_torch.engine.explain")
    with pytest.raises(AttributeError):
        eng.no_such_module  # noqa: B018


@pytest.mark.parametrize("backends", PAIRS, ids=PAIR_IDS)
def test_cache_state_after_a_run_is_the_reference(mirror_env, backends):
    """Before a run both explainers report a miss; after one run on the
    compiled backend both report a hit (numpy keeps no plan cache)."""
    from repro.engine import compile as rcompile
    from repro_torch.engine import compile as tcompile
    rb, tb = backends
    rstore = RefStore()
    keys = {"lineitem": rdatagen.load_table(rstore, "lineitem", 4000, 4),
            "orders": rdatagen.load_table(rstore, "orders", 1000, 2)}
    tstore = ObjectStore()
    copy_objects(rstore, tstore)
    rcompile.PLAN_CACHE.clear()
    tcompile.PLAN_CACHE.clear()
    rc = RefCoordinator(rstore, backend=rb)
    tc = Coordinator(tstore, backend=tb, device="cpu")
    for t, k in keys.items():
        rc.register_table(t, k)
        tc.register_table(t, k)
    texts = []
    for _ in range(2):
        rstats = roptimizer.Stats.from_store(rstore, keys)
        tstats = toptimizer.Stats.from_store(tstore, keys)
        ref = rexplain.explain(rqueries.q12_logical(), stats=rstats,
                               backend=rb)
        got = texplain.explain(tqueries.q12_logical(), stats=tstats,
                               backend=tb)
        assert got == (explain_as_port(ref) if rb == "jit" else ref)
        texts.append(got)
        rres = rc.run(rqueries.q12_logical(), query_id="explained")
        tres = tc.run(tqueries.q12_logical(), query_id="explained")
        assert tres.plan_cache_hit == rres.plan_cache_hit
        assert tres.plan_shape_hash == rres.plan_shape_hash
        assert (rexplain.format_adaptive(rres) ==
                texplain.format_adaptive(tres))
    assert "compiled-plan cache: miss" in texts[0]
    state = "hit" if tb == "torch" else "miss"
    assert f"compiled-plan cache: {state}" in texts[1]
