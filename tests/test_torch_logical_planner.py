"""The port held against ``tests/test_logical_planner.py``: each of its tests
runs on the reference and, retargeted, on the port, and the two runs
must answer alike (``test_torch_parity.mirror``)."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_logical_planner", numpy_too=(
    "test_coordinator_validates_before_scheduling",)))
