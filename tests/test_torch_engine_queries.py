"""The port held against ``tests/test_engine_queries.py``: each of its
tests runs on the reference and, retargeted, on the port, and the two
runs must answer alike (``test_torch_parity.mirror``)."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_engine_queries", numpy_too=(
    "test_q6", "test_q1", "test_q12", "test_bb_q3_totals",
    "test_faas_vs_iaas_same_result", "test_stage_metrics_and_peak_workers",
    "test_burst_aware_fewer_or_equal_runtime")))
