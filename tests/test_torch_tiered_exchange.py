"""The port held against ``tests/test_tiered_exchange.py``: each of its
tests runs on the reference and, retargeted, on the port, and the two
runs must answer alike (``test_torch_parity.mirror``)."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_tiered_exchange", numpy_too=(
    "test_kv_shuffle_routes_to_kv_store",
    "test_exchange_cost_breakdown",
    "test_forced_object_execution_matches_auto",
    "test_worker_falls_back_without_kv_store")))
