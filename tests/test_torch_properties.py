"""The port held against ``tests/test_properties.py``: each of its tests
runs on the reference and, retargeted, on the port, and the two runs
must answer alike (``test_torch_parity.mirror``).

``test_ef_quantization_error_bounded`` has no mirror: it drives the
reference's ``ef_compress`` with ``jax.numpy`` arrays, which the port's
(torch) ``ef_compress`` does not take."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_properties", omit={
    "test_ef_quantization_error_bounded": "drives ef_compress with "
                                          "jax.numpy arrays"}))
