"""The port held against ``tests/test_fault_domain.py``: each of its
tests runs on the reference and, retargeted, on the port, and the two
runs must answer alike (``test_torch_parity.mirror``). The crash-parity
harness is parametrised over both backends already."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_fault_domain", numpy_too=(
    "test_query_server_surfaces_failure_and_isolates_batch",
    "test_query_server_recovers_kills_in_shared_pool")))
