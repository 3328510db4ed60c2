"""The port's torch data plane (``repro_torch.engine.compile``) and
fragment execution against the JAX reference: every driver shape of the
reference's backend suite — fused filter/project segments, unique and
duplicate-key joins fused with downstream ops and the partition
assignment, mid-plan agg partition fusion, the collect fusion, and the
int32 guards with their warn-once fallback — runs through the port's
``"torch"`` backend on the CPU, the port's ``"numpy"`` backend and the
reference's ``"jit"`` backend on the same numpy inputs. Aggregates agree
within rtol=1e-6, keys, counts, row order and pass-through dtypes
exactly."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.engine import compile as jc
from repro.engine.columnar import ColumnBatch as JCB
from repro_torch.core.storage_service import ObjectStore
from repro_torch.engine import columnar, operators, queries
from repro_torch.engine import compile as tc
from repro_torch.engine.columnar import ColumnBatch as TCB
from repro_torch.engine.worker import (FragmentSpec, execute_fragment,
                                       result_key)

CPU = "cpu"


def _run(driver, left: dict, ops_fn, *args):
    """``driver`` on the port's torch and numpy backends and on the
    reference's jit backend; ``ops_fn(ColumnBatch)`` builds the op list
    with the package's own batch type for join builds."""
    return {
        "torch": getattr(tc, driver)(TCB(left), ops_fn(TCB), *args,
                                     backend="torch", device=CPU),
        "numpy": getattr(tc, driver)(TCB(left), ops_fn(TCB), *args,
                                     backend="numpy"),
        "jit": getattr(jc, driver)(JCB(left), ops_fn(JCB), *args,
                                   backend="jit"),
    }


def _assert_close(a, b, rtol=1e-6):
    assert list(a) == list(b)
    assert a.num_rows == b.num_rows
    for c in a:
        np.testing.assert_allclose(np.asarray(a[c], np.float64),
                                   np.asarray(b[c], np.float64), rtol=rtol)


def _assert_parity(res, exact_cols=()):
    """torch vs numpy and torch vs jit (batches or partition lists)."""
    t = res["torch"]
    parts = t if isinstance(t, list) else [t]
    for other in ("numpy", "jit"):
        o = res[other]
        oparts = o if isinstance(o, list) else [o]
        assert len(parts) == len(oparts)
        for p, q in zip(parts, oparts):
            _assert_close(q, p)
            for c in exact_cols:
                np.testing.assert_array_equal(np.asarray(p[c]),
                                              np.asarray(q[c]))


# ---------------------------------------------------------------------------
# Inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _join_inputs(n=20_000, s=5_000, seed=5):
    rng = np.random.default_rng(seed)
    left = {
        "l_orderkey": rng.integers(1, int(s * 1.3), n).astype(np.int64),
        "l_shipmode": rng.integers(0, 7, n, dtype=np.int8),
        "l_price": np.round(rng.uniform(1.0, 100.0, n), 2),
    }
    build = {
        "o_orderkey": rng.permutation(np.arange(1, s + 1)).astype(np.int64),
        "o_orderpriority": rng.integers(0, 5, s, dtype=np.int8),
    }
    return left, build


def _join(build, lk="l_orderkey", rk="o_orderkey"):
    return lambda CB: [{"op": "hash_join", "left_key": lk, "right_key": rk,
                        "build": CB(build)}]


def _dup_inputs(n=20_000, s=5_000, seed=7, all_dup=False, skew=4):
    """Build side where key ``k`` appears ``1 + k % skew`` times."""
    rng = np.random.default_rng(seed)
    uniq = np.arange(1, s + 1, dtype=np.int64)
    mult = np.full(s, 3, np.int64) if all_dup else 1 + (uniq % skew)
    bk = np.repeat(uniq, mult)
    perm = rng.permutation(len(bk))
    build = {
        "bk": bk[perm],
        "bv": rng.integers(0, 5, len(bk)).astype(np.int8)[perm],
        "bw": np.round(rng.uniform(0.0, 1.0, len(bk)), 3)[perm],
    }
    left = {
        "k": rng.integers(1, int(s * 1.3), n).astype(np.int64),
        "m": rng.integers(0, 7, n, dtype=np.int8),
        "p": np.round(rng.uniform(1.0, 100.0, n), 2),
    }
    return left, build


@pytest.fixture
def no_numpy_join_fallback(monkeypatch):
    """Records calls of the port's interpreted join (the torch path must
    not take it on these shapes)."""
    calls = []
    orig = operators.op_hash_join

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(operators, "op_hash_join", spy)
    return calls


def _torch_only(driver, left, ops_fn, *args):
    return getattr(tc, driver)(TCB(left), ops_fn(TCB), *args,
                               backend="torch", device=CPU)


# ---------------------------------------------------------------------------
# Unique-key joins fused with downstream ops
# ---------------------------------------------------------------------------

_JOIN_TAILS = {
    "plain": [],
    "filter_project": [
        {"op": "filter", "expr": ["in", "l_shipmode",
                                  [queries.MAIL, queries.SHIP]]},
        {"op": "project", "columns": [
            "l_orderkey", "l_shipmode",
            ["high_line", ["case_in", "o_orderpriority",
                           [queries.URGENT, queries.HIGH]]],
            ["low_line", ["sub1", ["case_in", "o_orderpriority",
                                   [queries.URGENT, queries.HIGH]]]]]}],
    "agg": [
        {"op": "project", "columns": [
            "l_shipmode",
            ["high_line", ["case_in", "o_orderpriority",
                           [queries.URGENT, queries.HIGH]]]]},
        {"op": "hash_agg", "keys": ["l_shipmode"],
         "aggs": [["high", "sum", "high_line"],
                  ["cnt", "count", "high_line"]]}],
}


@pytest.mark.parametrize("tail", sorted(_JOIN_TAILS))
def test_join_parity(tail, no_numpy_join_fallback):
    left, build = _join_inputs()
    res = _run("run_pipeline", left,
               lambda CB: _join(build)(CB) + _JOIN_TAILS[tail])
    assert len(no_numpy_join_fallback) == 1    # the numpy backend's only
    _assert_parity(res, exact_cols=["l_shipmode"])
    assert res["torch"].num_rows > 0
    if tail == "plain":
        b = res["torch"]
        assert b["l_orderkey"].dtype == np.int64
        assert b["l_price"].dtype == np.float64
        assert b["o_orderpriority"].dtype == np.int8


def test_join_partition_parity(no_numpy_join_fallback):
    left, build = _join_inputs()
    tail = [{"op": "filter", "expr": ["in", "l_shipmode", [2, 5]]},
            {"op": "project", "columns": [
                "l_orderkey", "l_shipmode",
                ["high_line", ["case_in", "o_orderpriority", [0, 1]]]]}]
    no_numpy_join_fallback.clear()
    res = _run("run_pipeline_partition", left,
               lambda CB: _join(build)(CB) + tail, "l_orderkey", 8)
    assert len(res["torch"]) == 8
    assert len(no_numpy_join_fallback) == 1    # the numpy backend's only
    # Row order within a partition matches the stable reference.
    _assert_parity(res, exact_cols=["l_orderkey", "l_shipmode"])


def test_join_empty_sides():
    left, build = _join_inputs(n=100, s=50)
    empty = {k: v[:0] for k, v in left.items()}
    out = _torch_only("run_pipeline", empty, _join(build))
    assert out.num_rows == 0
    assert set(out) == set(left) | {"o_orderpriority"}
    out2 = _torch_only("run_pipeline", left,
                       lambda CB: [{"op": "hash_join",
                                    "left_key": "l_orderkey",
                                    "right_key": "o_orderkey",
                                    "build": CB({})}])
    assert out2.num_rows == 0


def test_join_full_int32_span_build_keys():
    left = {"k": np.asarray([2**31 - 1, 7, -5, -2**31], np.int64)}
    build = {"bk": np.asarray([-2**31, -5, 0, 7, 2**31 - 1], np.int64),
             "bv": np.asarray([1.0, 2.0, 3.0, 4.0, 5.0])}
    res = _run("run_pipeline", left, _join(build, "k", "bk"))
    for b in res.values():
        assert b["k"].tolist() == [2**31 - 1, 7, -5, -2**31]
        assert b["bv"].tolist() == [5.0, 4.0, 2.0, 1.0]


# ---------------------------------------------------------------------------
# Duplicate build keys: range probe + device expansion
# ---------------------------------------------------------------------------

def test_join_duplicate_build_keys_expand():
    left = {"k": np.asarray([1, 2, 3, 1], np.int64),
            "lv": np.asarray([10.0, 20.0, 30.0, 40.0])}
    build = {"bk": np.asarray([1, 1, 2, 5], np.int64),
             "bv": np.asarray([0.5, 0.25, 0.125, 9.0])}
    out = _torch_only("run_pipeline", left, _join(build, "k", "bk"))
    assert out["k"].tolist() == [1, 1, 2, 1, 1]
    assert out["lv"].tolist() == [10.0, 10.0, 20.0, 40.0, 40.0]
    assert out["bv"].tolist() == [0.5, 0.25, 0.125, 0.5, 0.25]


@pytest.mark.parametrize("case", ["skewed", "all_dup", "heavy_skew"])
def test_dup_join_parity_sweep(case, no_numpy_join_fallback):
    left, build = _dup_inputs(
        all_dup=(case == "all_dup"), skew=16 if case == "heavy_skew" else 4,
        seed={"skewed": 7, "all_dup": 8, "heavy_skew": 9}[case])
    no_numpy_join_fallback.clear()
    out = _torch_only("run_pipeline", left, _join(build, "k", "bk"))
    assert not no_numpy_join_fallback, "dup-key join fell back to numpy"
    res = _run("run_pipeline", left, _join(build, "k", "bk"))
    _assert_parity(res, exact_cols=["k", "bv", "m"])
    _assert_close(res["numpy"], out)
    assert out.num_rows > len(left["k"])     # multiplicity expanded
    assert out["k"].dtype == np.int64 and out["bv"].dtype == np.int8


def test_dup_join_downstream_filter_and_partition(no_numpy_join_fallback):
    left, build = _dup_inputs(seed=10)
    tail = [{"op": "filter", "expr": ["in", "bv", [1, 3]]},
            {"op": "project", "columns": [
                "k", "m", ["hv", ["mul", "p", ["add1", "bw"]]]]}]
    no_numpy_join_fallback.clear()
    out = _torch_only("run_pipeline_partition", left,
                      lambda CB: _join(build, "k", "bk")(CB) + tail, "k", 8)
    assert not no_numpy_join_fallback
    assert sum(p.num_rows for p in out) > 0
    res = _run("run_pipeline_partition", left,
               lambda CB: _join(build, "k", "bk")(CB) + tail, "k", 8)
    _assert_parity(res, exact_cols=["k", "m"])


def test_dup_join_no_match_keeps_schema():
    left = {"k": np.asarray([100, 200], np.int64)}
    build = {"bk": np.asarray([1, 1, 2], np.int64),
             "bv": np.asarray([1.0, 2.0, 3.0])}
    res = _run("run_pipeline", left, _join(build, "k", "bk"))
    assert {b.num_rows for b in res.values()} == {0}
    assert set(res["torch"]) == set(res["numpy"]) == {"k", "bv"}


# ---------------------------------------------------------------------------
# Mid-plan agg partition fusion and the collect fusion
# ---------------------------------------------------------------------------

def _preagg_batch(n=50_000, seed=12):
    rng = np.random.default_rng(seed)
    return {
        "g": rng.integers(0, 5, n, dtype=np.int8),
        "h": rng.integers(0, 3, n, dtype=np.int8),
        "x": np.round(rng.uniform(900.0, 105000.0, n), 2),
        "d": np.round(rng.integers(0, 11, n) * 0.01, 2),
    }


_PREAGG_OPS = [
    {"op": "filter", "expr": ["lt", "d", 0.09]},
    {"op": "project", "columns": [
        "g", "h", "x", ["dp", ["mul", "x", ["sub1", "d"]]]]},
    {"op": "hash_agg", "keys": ["g", "h"],
     "aggs": [["sx", "sum", "x"], ["sdp", "sum", "dp"],
              ["c", "count", "x"], ["lo", "min", "x"],
              ["hi", "max", "x"]]},
]


def test_midplan_agg_partition_fusion_parity():
    res = _run("run_pipeline_partition", _preagg_batch(),
               lambda CB: _PREAGG_OPS, "g", 4)
    assert sum(p.num_rows for p in res["torch"]) > 0
    _assert_parity(res, exact_cols=["g", "h", "c"])


def test_midplan_fusion_empty_partitions_keep_dtypes():
    res = _run("run_pipeline_partition", _preagg_batch(n=5_000, seed=15),
               lambda CB: _PREAGG_OPS, "g", 16)
    pt, pn = res["torch"], res["numpy"]
    assert any(p.num_rows == 0 for p in pt)
    for p in range(16):
        for c in pn[p]:
            assert pt[p][c].dtype == pn[p][c].dtype, (p, c)
    merged = TCB.concat(pt)
    assert merged["g"].dtype == np.int8 and merged["c"].dtype == np.int64


def test_midplan_join_agg_partition_fusion_parity(no_numpy_join_fallback):
    """Q12's join_agg shape with duplicate build keys."""
    left, build = _dup_inputs(seed=13)
    tail = [{"op": "project", "columns": [
                "m", ["hl", ["case_in", "bv", [0, 1]]]]},
            {"op": "hash_agg", "keys": ["m"],
             "aggs": [["s", "sum", "hl"], ["c", "count", "hl"]]}]
    no_numpy_join_fallback.clear()
    _torch_only("run_pipeline_partition", left,
                lambda CB: _join(build, "k", "bk")(CB) + tail, "m", 4)
    assert not no_numpy_join_fallback
    res = _run("run_pipeline_partition", left,
               lambda CB: _join(build, "k", "bk")(CB) + tail, "m", 4)
    _assert_parity(res, exact_cols=["m", "c"])


def test_midplan_fusion_global_and_non_fused_aggs():
    batch = _preagg_batch(n=10_000, seed=14)
    glob = [{"op": "hash_agg", "keys": [],
             "aggs": [["sx", "sum", "x"], ["c", "count", "x"]]}]
    _assert_parity(_run("run_pipeline_partition", batch,
                        lambda CB: glob, "sx", 1))
    ops = [{"op": "project", "columns": ["g", "h", "x"]},
           {"op": "hash_agg", "keys": ["g", "h"],
            "aggs": [["sx", "sum", "x"]]}]
    _assert_parity(_run("run_pipeline_partition", batch,
                        lambda CB: ops, "h", 3), exact_cols=["g", "h"])


def test_collect_fusion_parity(no_numpy_join_fallback):
    left, build = _join_inputs(seed=21)
    ops = lambda CB: _join(build)(CB) + [   # noqa: E731
        {"op": "filter", "expr": ["lt", "l_price", 50.0]},
        {"op": "project", "columns": [
            "l_shipmode", ["rev", ["mul", "l_price", ["const", 0.5]]]]},
        {"op": "hash_agg", "keys": ["l_shipmode"],
         "aggs": [["rev", "sum", "rev"], ["n", "count", "rev"]]}]
    no_numpy_join_fallback.clear()
    res = _run("run_pipeline_collect", left, ops)
    assert len(no_numpy_join_fallback) == 1    # the numpy backend's only
    _assert_parity(res, exact_cols=["l_shipmode", "n"])


# ---------------------------------------------------------------------------
# Literal binding at the device widths
# ---------------------------------------------------------------------------

def test_query_literals_bind_like_the_reference():
    """The scan pipelines of Q1, Q6 and Q12 — with their own float, int
    and in-list literals — select the same rows on the torch backend as
    on the reference jit and the float64 numpy backend, including rows
    sitting exactly on the literal boundaries. Comparisons of narrow
    integer columns against literals outside the column's width (which
    torch would wrap if the column stayed int8) keep their meaning."""
    from repro_torch.engine import datagen
    batch = dict(datagen.gen_lineitem(20_000, seed=4))
    batch["l_discount"][:50] = 0.05           # q6 between lower bound
    batch["l_discount"][50:100] = 0.07        # q6 between upper bound
    batch["l_quantity"][100:150] = 24.0       # q6 strict bound
    batch["l_shipdate"][150:200] = datagen.DATE_MAX - 90   # q1 cutoff
    for plan_fn in (queries.q1_plan, queries.q6_plan, queries.q12_plan):
        pipe = plan_fn().pipelines[0]
        assert pipe.ops[0]["op"] == "filter"
        ops = [pipe.ops[0]]
        res = _run("run_pipeline", batch, lambda CB: ops)
        _assert_parity(res, exact_cols=list(batch))
    wide = [{"op": "filter", "expr": ["and", ["lt", "l_shipmode", 300],
                                      ["gt", "l_shipmode", -200],
                                      ["ne", "l_returnflag", 257]]}]
    res = _run("run_pipeline", batch, lambda CB: wide)
    assert res["torch"].num_rows == len(batch["l_shipmode"])
    _assert_parity(res)


def test_narrow_lits_bind_float32_values():
    lits = tc._narrow_lits([0.05, 24, True, [2, 5], [0.5, 1.5], 2**40])
    assert lits[0] == float(np.float32(0.05)) and isinstance(lits[0], float)
    assert lits[1] == 24 and lits[2] is True and lits[5] == 2**40
    assert lits[3].dtype == np.int32 and lits[4].dtype == np.float32


# ---------------------------------------------------------------------------
# int32 guards: interpreted routes, counted, warned once for joins
# ---------------------------------------------------------------------------

@pytest.fixture
def fallback_stats(monkeypatch):
    stats = dict.fromkeys(tc.FALLBACK_STATS, 0)
    monkeypatch.setattr(tc, "FALLBACK_STATS", stats)
    return stats


def test_fused_segment_wide_int_fallback(fallback_stats):
    big = np.asarray([2**31 + 5, 7, 2**40], dtype=np.int64)
    batch = {"k": big, "v": np.asarray([1.0, 2.0, 3.0])}
    ops = [{"op": "filter", "expr": ["eq", "k", int(big[0])]}]
    out = _torch_only("run_pipeline", batch, lambda CB: ops)
    assert out["k"].tolist() == [int(big[0])]
    assert fallback_stats["mask"] == 1


def test_fused_wide_const_and_derived_column_fallback(fallback_stats):
    batch = {"a": np.asarray([65536, 3], dtype=np.int64),
             "v": np.asarray([65536, 4], dtype=np.int64)}
    ops = [{"op": "project", "columns": ["a", ["p", ["mul", "a", "v"]]]},
           {"op": "filter", "expr": ["ge", "p", 1]}]
    res = _run("run_pipeline", batch, lambda CB: ops)
    np.testing.assert_array_equal(res["torch"]["p"], res["numpy"]["p"])
    assert res["torch"]["p"].tolist() == [2**32, 12]
    assert fallback_stats["project"] == 1 and fallback_stats["mask"] == 1
    ops2 = [{"op": "filter", "expr": ["lt", "a", 10_000_000_000]}]
    assert _torch_only("run_pipeline", batch, lambda CB: ops2).num_rows == 2
    assert fallback_stats["mask"] == 2


def test_fused_integer_projection_no_overflow(fallback_stats):
    batch = {"a": np.asarray([100000, 3], dtype=np.int64),
             "v": np.asarray([100000, 4], dtype=np.int64)}
    ops = [{"op": "project", "columns": [["p", ["mul", "a", "v"]]]}]
    out = _torch_only("run_pipeline", batch, lambda CB: ops)
    assert out["p"].tolist() == [10_000_000_000, 12]
    assert fallback_stats["project"] == 1


def test_hash_agg_high_cardinality_routes_to_reduceat(fallback_stats):
    rng = np.random.default_rng(11)
    n_keys = tc._MAX_KERNEL_GROUPS * 3
    batch = {"k": rng.integers(0, n_keys, 20000, dtype=np.int64),
             "v": rng.standard_normal(20000)}
    spec = [{"op": "hash_agg", "keys": ["k"],
             "aggs": [["s", "sum", "v"], ["c", "count", "v"],
                      ["lo", "min", "v"], ["hi", "max", "v"]]}]
    res = _run("run_pipeline", batch, lambda CB: spec)
    a, b = res["numpy"], res["torch"]
    assert a.num_rows == b.num_rows > tc._MAX_KERNEL_GROUPS
    np.testing.assert_array_equal(a["k"], b["k"])
    for col in ("s", "c", "lo", "hi"):
        np.testing.assert_allclose(a[col], b[col], rtol=1e-9)
    assert fallback_stats["hash_agg_groups"] == 1


def test_join_int32_overflow_falls_back(fallback_stats):
    left = {"k": np.asarray([2**40, 7, 2**31 + 1], np.int64)}
    build = {"bk": np.asarray([2**40, 2**31 + 1, 8], np.int64),
             "bv": np.asarray([1.0, 2.0, 3.0])}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = _torch_only("run_pipeline", left, _join(build, "k", "bk"))
    assert out["k"].tolist() == [2**40, 2**31 + 1]
    assert out["bv"].tolist() == [1.0, 2.0]
    assert fallback_stats["tail"] == 1


def test_int32_overflow_fallback_warns_once(monkeypatch, fallback_stats):
    monkeypatch.setattr(tc, "_INT32_FALLBACK_WARNED", False)
    left = {"k": np.asarray([2**40, 7], np.int64)}
    build = {"bk": np.asarray([2**40, 8], np.int64),
             "bv": np.asarray([1.0, 2.0])}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _torch_only("run_pipeline", left, _join(build, "k", "bk"))
        _torch_only("run_pipeline", left, _join(build, "k", "bk"))
    hits = [w for w in rec if issubclass(w.category, RuntimeWarning)
            and "int32" in str(w.message)]
    assert len(hits) == 1
    msg = str(hits[0].message)
    assert "'k'" in msg and str(2**40) in msg
    assert fallback_stats["tail"] == 2


def test_main_shapes_take_no_fallback(fallback_stats):
    left, build = _dup_inputs(seed=3)
    _torch_only("run_pipeline_partition", left,
                lambda CB: _join(build, "k", "bk")(CB), "k", 4)
    _torch_only("run_pipeline_partition", _preagg_batch(n=2000),
                lambda CB: _PREAGG_OPS, "g", 4)
    assert not any(fallback_stats.values())


# ---------------------------------------------------------------------------
# Backends, devices, caches
# ---------------------------------------------------------------------------

def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        tc.run_pipeline(TCB({}), [], backend="jit")
    with pytest.raises(ValueError):
        tc.run_pipeline_partition(TCB({}), [], "k", 2, backend="tpu2")


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    batch = TCB({"k": np.arange(4)})
    ops = [{"op": "filter", "expr": ["lt", "k", 2]}]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_pipeline(batch, ops, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run_pipeline_partition(batch, ops, "k", 2, backend="torch",
                                  device="cuda")
    store = ObjectStore()
    store.put("t/x", columnar.serialize(batch))
    spec = FragmentSpec(query_id="q", pipeline="p", fragment=0,
                        read_keys=["t/x"], read_keys2=[], columns=None,
                        ops=ops, output={"type": "collect"})
    assert (spec.backend, spec.device) == ("torch", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_fragment(store, spec)


def test_fragment_runs_on_the_spec_device():
    store = ObjectStore()
    left, build = _join_inputs(n=2000, s=500, seed=2)
    store.put("t/left", columnar.serialize(TCB(left)))
    store.put("t/build", columnar.serialize(TCB(build)))
    out = {}
    for backend in ("numpy", "torch"):
        spec = FragmentSpec(
            query_id=backend, pipeline="p", fragment=0,
            read_keys=["t/left"], read_keys2=["t/build"], columns=None,
            ops=[{"op": "hash_join", "left_key": "l_orderkey",
                  "right_key": "o_orderkey"},
                 {"op": "filter", "expr": ["ge", "l_price", 20.0]}],
            output={"type": "collect"}, backend=backend, device=CPU)
        execute_fragment(store, spec)
        out[backend] = columnar.deserialize(
            store.get(result_key(backend, "p", 0)))
    _assert_close(out["numpy"], out["torch"])
    assert out["torch"].num_rows > 0


def test_build_prep_memo_keys_on_the_host_key_array():
    """Morsel-wise probing reuses one build prep per host key array."""
    left, build = _join_inputs(n=3000, s=400, seed=6)
    b = TCB(build)
    ops = [{"op": "hash_join", "left_key": "l_orderkey",
            "right_key": "o_orderkey", "build": b}]
    canon, _ = tc._canon_json([tc._strip_build(op) for op in ops])
    tc.run_pipeline(TCB(left), ops, backend="torch", device=CPU)
    tail = tc._compile_tail(canon, None)
    prep = tail._build_prep
    assert prep[0] is b["o_orderkey"]
    half = {k: v[:1000] for k, v in left.items()}
    tc.run_pipeline(TCB(half), ops, backend="torch", device=CPU)
    assert tail._build_prep is prep


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.engine.coordinator, repro_torch.engine."
            "queries, repro_torch.engine.compile, repro_torch.kernels.build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": src},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
