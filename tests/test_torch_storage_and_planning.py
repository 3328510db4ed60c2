"""The port held against ``tests/test_storage_and_planning.py``: each of its tests
runs on the reference and, retargeted, on the port, and the two runs
must answer alike (``test_torch_parity.mirror``)."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_storage_and_planning"))
