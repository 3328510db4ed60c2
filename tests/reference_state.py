"""Process-wide state that the reference's code leaves in a pytest worker.

The reference's step builders (``repro.launch.steps``) install activation
rules and their mesh at trace time, through
``repro.models.common.set_activation_rules``, and nothing clears them. A
reference test that builds a step on ``jax.make_mesh``'s ``Explicit``
axes (``test_substrate.py``'s serving engine, ``test_fault_tolerance.py``'s
``Trainer``) leaves every later call of ``common.shard`` in its worker
constraining activations to that mesh. The reference's attention prefill
then raises a ``ShardingTypeError``, so a parity test would pass or fail
with the files that ran before it in its worker.

A port test that runs the reference's model code in-process imports both
fixtures below; they are autouse, so the import is all it takes::

    from reference_state import (  # noqa: F401  (autouse fixtures)
        clean_reference_rules, clean_reference_rules_module)

Each clears the reference's rules before and after its scope and then
holds the port to its own contract: its steps install their rules only
for the call (``launch.steps._activation_rules``) and leave none behind.
The module-scoped one comes first, so a module-scoped fixture that builds
reference models, or a module-level cache of jitted reference functions
(``test_torch_serve.py``'s ``_JAX_STEPS``), never traces under leaked
rules: a trace that raised is not cached, while a clean one is reused.
"""
from __future__ import annotations

import pytest

from repro.models import common as jcommon
from repro_torch.models import common as tcommon


def clear_reference_rules() -> None:
    """Remove the activation rules and mesh the reference's step builders
    installed, through the reference's own public call."""
    jcommon.clear_activation_rules()


def assert_port_rules_clear() -> None:
    """The port's activation rules and mesh are not installed."""
    assert not tcommon._ACTIVATION_RULES, tcommon._ACTIVATION_RULES
    assert tcommon._ACTIVE["mesh"] is None, tcommon._ACTIVE


def _guard():
    clear_reference_rules()
    yield
    clear_reference_rules()
    assert_port_rules_clear()


@pytest.fixture(autouse=True)
def clean_reference_rules():
    """Each test starts with the reference's rules cleared and leaves
    neither package's rules installed."""
    yield from _guard()


@pytest.fixture(autouse=True, scope="module")
def clean_reference_rules_module():
    """The same around a module, set up before its module-scoped
    fixtures."""
    yield from _guard()
