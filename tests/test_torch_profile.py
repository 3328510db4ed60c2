"""The port's planner and coordinator read the same bench profile as the
reference where the backend does not differ: on the ``numpy`` backend,
with the repository's own files, TPC-H Q1's optimizer trace and modeled
runtime and cost equal the reference's on the same bytes; and under one
pinned profile whose ``jit_s`` equals its ``torch_s``, the reference's
``jit`` and the port's ``torch`` backend model the same runtimes."""
import json

import pytest

from repro.core import bench_profile as jbench
from repro.core.storage_service import ObjectStore as JStore
from repro.engine import datagen as jdatagen
from repro.engine import optimizer as joptimizer
from repro.engine import queries as jqueries
from repro.engine.coordinator import Coordinator as JCoordinator
from repro_torch.core import bench_profile as tbench
from repro_torch.core.storage_service import ObjectStore, copy_objects
from repro_torch.engine import optimizer as toptimizer
from repro_torch.engine import queries as tqueries
from repro_torch.engine.coordinator import Coordinator

MODELED = ("runtime_s", "cumulated_worker_s", "faas_cost_usd")


@pytest.fixture(scope="module")
def stores():
    jstore = JStore()
    keys = {"lineitem": jdatagen.load_table(jstore, "lineitem", 20000, 8)}
    tstore = ObjectStore()
    copy_objects(jstore, tstore)
    return jstore, tstore, keys


def _clear():
    jbench.clear_cache()
    tbench.clear_cache()


@pytest.fixture
def default_profiles(monkeypatch):
    """The repository's own profile files, as a user's checkout has them."""
    monkeypatch.delenv("REPRO_BENCH_PROFILE", raising=False)
    _clear()
    yield
    _clear()


@pytest.fixture
def pinned_profile(monkeypatch, tmp_path):
    """One profile for both packages, whose jit and torch throughputs
    are equal."""
    path = tmp_path / "profile.json"
    path.write_text(json.dumps({"pipeline": {
        "batch_mib": 64.0, "numpy_s": 0.5, "jit_s": 0.125,
        "torch_s": 0.125}, "tiered_exchange": {}}))
    monkeypatch.setenv("REPRO_BENCH_PROFILE", str(path))
    _clear()
    yield
    _clear()


def _q1_both(stores, jbackend, tbackend):
    """Q1 lowered and run twice (cold, then warm workers) by each
    package: the optimizer traces and each run's results."""
    jstore, tstore, keys = stores
    jc = JCoordinator(jstore, mode="elastic", backend=jbackend)
    tc = Coordinator(tstore, mode="elastic", backend=tbackend, device="cpu")
    jc.register_table("lineitem", keys["lineitem"])
    tc.register_table("lineitem", keys["lineitem"])
    jplan, jreport = joptimizer.lower(
        jqueries.LOGICAL_BUILDERS["q1"](),
        stats=joptimizer.Stats.from_store(jstore, keys), backend=jbackend)
    tplan, treport = toptimizer.lower(
        tqueries.LOGICAL_BUILDERS["q1"](),
        stats=toptimizer.Stats.from_store(tstore, keys), backend=tbackend)
    runs = [(jc.execute(jplan, f"ref-{i}"), tc.execute(tplan, f"port-{i}"))
            for i in range(2)]
    return jreport.rules, treport.rules, runs


def test_numpy_backend_models_q1_as_the_reference(stores, default_profiles):
    assert tbench.load() == jbench.load() != {}
    jrules, trules, runs = _q1_both(stores, "numpy", "numpy")
    assert trules == jrules
    assert any("MiB/s" in line for line in trules)
    for jres, tres in runs:
        for field in MODELED:
            assert getattr(tres, field) == getattr(jres, field), field


def test_pinned_profile_models_torch_as_jit(stores, pinned_profile):
    assert tbench.cpu_bytes_per_s("torch", 1.0) \
        == jbench.cpu_bytes_per_s("jit", 1.0) == 512.0 * 2 ** 20
    jrules, trules, runs = _q1_both(stores, "jit", "torch")
    assert trules == jrules
    for jres, tres in runs:
        for field in MODELED:
            assert getattr(tres, field) == getattr(jres, field), field
