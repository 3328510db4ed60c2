"""End to end: TPC-H Q1, Q6, Q12 and a duplicate-key join through the
port's ``Coordinator(backend="torch", device="cpu")`` against the JAX
reference's ``Coordinator(backend="jit")``, both reading the very same
table bytes (``storage_service.copy_objects``). The lowered plans hash
identically; result keys, dtypes and counts agree exactly, aggregates
within rtol=1e-6. Plus the framework-free copies' plan parity and the
port's out-of-core spill parity."""
import numpy as np
import pytest
import torch

from repro.core import bench_profile as jbench
from repro.core.storage_service import ObjectStore as JStore
from repro.engine import datagen as jdatagen
from repro.engine import logical as jlogical
from repro.engine import optimizer as joptimizer
from repro.engine import plans as jplans
from repro.engine import queries as jqueries
from repro.engine.coordinator import Coordinator as JCoordinator
from repro_torch.core import bench_profile as tbench
from repro_torch.core.storage_service import ObjectStore, copy_objects
from repro_torch.engine import compile as tc
from repro_torch.engine import logical as tlogical
from repro_torch.engine import optimizer as toptimizer
from repro_torch.engine import plans as tplans
from repro_torch.engine import queries as tqueries
from repro_torch.engine import spill
from repro_torch.engine.coordinator import Coordinator
from repro_torch.kernels import hash_join as thj
from repro_torch.kernels import segment_reduce as tsr

TABLES = ("lineitem", "orders")


@pytest.fixture(scope="module")
def stores():
    """A reference store filled by the reference's datagen, and a port
    store holding a byte-for-byte copy of it."""
    jstore = JStore()
    keys = {"lineitem": jdatagen.load_table(jstore, "lineitem", 20000, 8),
            "orders": jdatagen.load_table(jstore, "orders", 5000, 4)}
    tstore = ObjectStore()
    copied = copy_objects(jstore, tstore)
    assert sorted(copied) == sorted(keys["lineitem"] + keys["orders"])
    return jstore, tstore, keys


def _dup_key_logical(lg, q):
    """Q12 with the join sides swapped: orders probes the filtered
    lineitem, whose l_orderkey repeats, so the build side has duplicate
    keys (with no stats the right side is the build)."""
    col = lg.col
    li = (lg.scan("lineitem")
          .filter(col("l_shipmode").isin([q.MAIL, q.SHIP])
                  & (col("l_commitdate") < col("l_receiptdate"))
                  & (col("l_shipdate") < col("l_commitdate"))
                  & (col("l_receiptdate") >= 731)
                  & (col("l_receiptdate") < 731 + 365))
          .select("l_orderkey", "l_shipmode"))
    high = col("o_orderpriority").case_in([q.URGENT, q.HIGH])
    return (lg.scan("orders").select("o_orderkey", "o_orderpriority")
            .join(li, on=("o_orderkey", "l_orderkey"))
            .select("l_shipmode", high.alias("high_line"),
                    (1 - high).alias("low_line"))
            .group_by("l_shipmode")
            .agg(lg.sum_("high_line").alias("high_line_count"),
                 lg.sum_("low_line").alias("low_line_count"),
                 lg.count_("high_line").alias("lines"))
            .collect("dup_key_join", shuffle_partitions=8))


_PLANS = {
    "q1": (lambda: jqueries.q1_plan(), lambda: tqueries.q1_plan(),
           ["l_returnflag", "l_linestatus"]),
    "q6": (lambda: jqueries.q6_plan(), lambda: tqueries.q6_plan(), []),
    "q12": (lambda: jqueries.q12_plan(), lambda: tqueries.q12_plan(),
            ["l_shipmode"]),
    "dup_key_join": (
        lambda: joptimizer.plan(_dup_key_logical(jlogical, jqueries)),
        lambda: toptimizer.plan(_dup_key_logical(tlogical, tqueries)),
        ["l_shipmode"]),
}


def _sorted(batch, key_cols):
    if not key_cols:
        return {k: np.asarray(v) for k, v in batch.items()}
    order = np.lexsort([np.asarray(batch[k]) for k in key_cols][::-1])
    return {k: np.asarray(v)[order] for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_query_matches_reference(stores, name, monkeypatch):
    jstore, tstore, keys = stores
    jplan_fn, tplan_fn, key_cols = _PLANS[name]
    calls = {"probe": 0, "probe_range": 0, "segment_reduce": 0}
    for mod, fn in ((thj, "sorted_probe"), (thj, "sorted_probe_range"),
                    (tsr, "segment_reduce")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **k):
            calls[_fn.replace("sorted_", "")] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    fallbacks = dict.fromkeys(tc.FALLBACK_STATS, 0)
    monkeypatch.setattr(tc, "FALLBACK_STATS", fallbacks)

    jc = JCoordinator(jstore, mode="elastic", backend="jit")
    tcoord = Coordinator(tstore, mode="elastic", backend="torch",
                         device="cpu")
    for t in TABLES:
        jc.register_table(t, keys[t])
        tcoord.register_table(t, keys[t])
    jres = jc.execute(jplan_fn(), query_id=f"ref-{name}")
    tres = tcoord.execute(tplan_fn(), query_id=f"port-{name}")

    assert tres.plan_shape_hash == jres.plan_shape_hash != ""
    a, b = jres.result, tres.result
    assert list(a) == list(b)
    assert a.num_rows == b.num_rows > 0
    ra, rb = _sorted(a, key_cols), _sorted(b, key_cols)
    for c in ra:
        assert ra[c].dtype == rb[c].dtype, c
        if c in key_cols or ra[c].dtype.kind in "iu":
            np.testing.assert_array_equal(ra[c], rb[c])
        else:
            np.testing.assert_allclose(ra[c], rb[c], rtol=1e-6)
    # The main path really went through the kernels' wrappers, with no
    # interpreted fallback.
    assert calls["segment_reduce"] > 0
    if name == "q12":
        assert calls["probe"] > 0 and calls["probe_range"] == 0
    if name == "dup_key_join":
        # A fragment whose build slice happens to hold no duplicate
        # takes the unique-key probe; the others take the range probe.
        assert calls["probe_range"] > 0
    assert not any(fallbacks.values()), fallbacks


def test_queries_match_numpy_reference_functions(stores):
    """The port against the queries' own float64 reference functions."""
    _, tstore, keys = stores
    from repro_torch.engine import columnar
    li = columnar.ColumnBatch.concat([
        columnar.deserialize(tstore.get(k)) for k in keys["lineitem"]])
    c = Coordinator(tstore, backend="torch", device="cpu")
    c.register_table("lineitem", keys["lineitem"])
    got = c.execute(tqueries.q6_plan(), query_id="q6-ref").result
    np.testing.assert_allclose(got["revenue"], [tqueries.q6_reference(li)],
                               rtol=1e-6)
    got = c.execute(tqueries.q1_plan(), query_id="q1-ref").result
    want = tqueries.q1_reference(li)
    g, w = (_sorted(x, ["l_returnflag", "l_linestatus"]) for x in (got, want))
    for col in w:
        np.testing.assert_allclose(np.asarray(g[col], np.float64),
                                   np.asarray(w[col], np.float64), rtol=1e-6)


@pytest.fixture
def pinned_profile(monkeypatch, tmp_path):
    """Both packages read one bench profile, so fan-outs derived from
    measured throughputs agree."""
    path = tmp_path / "profile.json"
    path.write_text('{"pipeline": {"batch_mib": 64.0, "numpy_s": 0.5}, '
                    '"tiered_exchange": {}}')
    monkeypatch.setenv("REPRO_BENCH_PROFILE", str(path))
    jbench.clear_cache()
    tbench.clear_cache()
    yield
    monkeypatch.delenv("REPRO_BENCH_PROFILE")
    jbench.clear_cache()
    tbench.clear_cache()


@pytest.mark.parametrize("name", ["q1", "q6", "q12", "bb_q3"])
def test_lowered_plans_identical(stores, pinned_profile, name):
    """The copied optimizer lowers every query to the reference's plan,
    op for op, without and with table statistics."""
    jstore, tstore, keys = stores
    jq = jqueries.LOGICAL_BUILDERS[name]()
    tq = tqueries.LOGICAL_BUILDERS[name]()
    jp, tp = joptimizer.plan(jq), toptimizer.plan(tq)
    assert jplans.plan_shape_hash(jp) == tplans.plan_shape_hash(tp)
    assert jplans.plan_cache_key(jp) == tplans.plan_cache_key(tp)
    for a, b in zip(jp.pipelines, tp.pipelines):
        assert jplans.canonicalize_ops(a.ops) == tplans.canonicalize_ops(b.ops)
    if name != "bb_q3":
        tkeys = {t: keys[t] for t in TABLES}
        js = joptimizer.Stats.from_store(jstore, tkeys)
        ts = toptimizer.Stats.from_store(tstore, tkeys)
        jl, _ = joptimizer.lower(jq, stats=js, backend="numpy")
        tl, _ = toptimizer.lower(tq, stats=ts, backend="numpy")
        assert jplans.plan_shape_hash(jl) == tplans.plan_shape_hash(tl)


@pytest.mark.parametrize("query", ["q1", "q12"])
def test_spill_forced_run_is_bit_identical(stores, query):
    """Out-of-core execution on the torch backend: a budget small enough
    to force spill rounds gives the unbudgeted run's bytes exactly."""
    _, tstore, keys = stores
    results = {}
    for tag, kw in (("unlimited", {}),
                    ("capped", {"memory_budget": 512.0,
                                "morsel_rows": 128})):
        c = Coordinator(tstore, backend="torch", device="cpu", **kw)
        for t in TABLES:
            c.register_table(t, keys[t])
        spill.reset_stats()
        results[tag] = c.execute(getattr(tqueries, f"{query}_plan")(),
                                 query_id=f"ooc-{query}-{tag}").result
        if tag == "capped":
            assert spill.SPILL_STATS["spill_rounds"] >= 2
    a, b = results["unlimited"], results["capped"]
    assert list(a) == list(b) and a.num_rows == b.num_rows
    for c in a:
        assert a[c].dtype == b[c].dtype
        np.testing.assert_array_equal(a[c], b[c])


def test_coordinator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Coordinator(ObjectStore())
    assert Coordinator(ObjectStore(), backend="numpy").backend == "numpy"
    with pytest.raises(ValueError):
        Coordinator(ObjectStore(), backend="jit", device="cpu")
