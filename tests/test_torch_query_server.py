"""The port held against ``tests/test_query_server.py``: each of its
tests runs on the reference and, retargeted, on the port, and the two
runs must answer alike (``test_torch_parity.mirror``). Plan-cache hits
are a property of the compiled backend, so the test that counts them
runs on ``jit``/``torch`` only."""
import pytest

from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_query_server", numpy_too=(
    "test_interleaved_beats_serial_at_fixed_budget",
    "test_result_cache_hit_and_invalidation",
    "test_result_cache_bitmap_validation",
    "test_serving_under_tight_admission_still_completes")))


def test_plan_hashes_and_cache_keys_are_the_reference():
    """The compiled-plan cache and the result cache key a plan the way
    the reference does, for every paper query and literal."""
    from repro.engine import datagen, plans as rplans
    from repro.engine import queries as rqueries
    from repro_torch.engine import plans as tplans
    from repro_torch.engine import queries as tqueries
    year = datagen.DATE_1994_01_01
    for name in rqueries.QUERY_BUILDERS:
        ref = rqueries.QUERY_BUILDERS[name]()
        got = tqueries.QUERY_BUILDERS[name]()
        assert tplans.plan_shape_hash(got) == rplans.plan_shape_hash(ref)
        assert tplans.plan_cache_key(got) == rplans.plan_cache_key(ref)
    for lo in (year, year + 180):
        assert tplans.plan_cache_key(tqueries.q12_plan(year_lo=lo)) == \
            rplans.plan_cache_key(rqueries.q12_plan(year_lo=lo))


def test_query_server_takes_its_device():
    """``QueryServer(device=...)`` reaches its coordinator and every
    fragment; the default asks for the card and raises without one."""
    import torch

    from repro_torch.core.storage_service import ObjectStore
    from repro_torch.serve.query_server import QueryServer
    srv = QueryServer(ObjectStore(), device="cpu")
    assert srv.coordinator.backend == "torch"
    assert srv.coordinator.device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryServer(ObjectStore())
