"""The port held against ``tests/test_shuffle_elision.py``: each of its
tests runs on the reference and, retargeted, on the port, and the two
runs must answer alike (``test_torch_parity.mirror``). The end-to-end
parity test is parametrised over both backends already."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_shuffle_elision", numpy_too=(
    "test_coordinator_rejects_misdeclared_table_layout",)))
