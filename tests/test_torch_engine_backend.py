"""The port held against ``tests/test_engine_backend.py``: each of its tests
runs on the reference and, retargeted, on the port, and the two runs
must answer alike (``test_torch_parity.mirror``).

``test_segment_reduce_kernel`` has no mirror: it holds the Pallas kernel
in interpret mode to the numpy oracle; the port's kernel is held to the
same oracle in ``tests/test_torch_kernels.py``."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_engine_backend", omit={
    "test_segment_reduce_kernel": "the reference's Pallas kernel in "
                                  "interpret mode (an argument the port's "
                                  "wrapper does not take)"}))
