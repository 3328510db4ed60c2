"""The activation rules that the reference's step builders leave installed,
and the port's steps that leave none (``tests/reference_state.py``).

The reference's ``launch.steps`` installs its rules the way this file
does, ``common.set_activation_rules(rules.activation_rules(mesh), mesh)``
on ``jax.make_mesh``'s ``Explicit`` axes, and never clears them. Under
them the reference's StableLM prefill (head dim 80, ``reduced()`` config
as in ``test_torch_stablelm.py``) raises a ``ShardingTypeError`` at its
cache update; once the guard's clear has run it matches the port's
``forward_prefill`` within that file's 1e-4. The port's step context
clears its rules even when the step raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# jax raises it from here and exports it under no public name.
from jax._src.core import ShardingTypeError

from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.sharding import rules as jrules
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttfm
from test_torch_stablelm import B, CACHE_LEN, S, TOL, models  # noqa: F401
from reference_state import (  # noqa: F401  (autouse fixtures)
    assert_port_rules_clear, clean_reference_rules,
    clean_reference_rules_module, clear_reference_rules)


def _install_reference_rules():
    """What ``repro.launch.steps``'s builders do at trace time."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcommon.set_activation_rules(jrules.activation_rules(mesh), mesh)
    assert jcommon._ACTIVATION_RULES


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_leaked_reference_rules_break_its_prefill_until_cleared(models,
                                                                impl):
    jcfg, tcfg, params, model = models
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    _install_reference_rules()
    with pytest.raises(ShardingTypeError, match="dynamic_update_slice"):
        jtfm.forward_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                             CACHE_LEN, impl=impl)
    # The port reads none of the reference's state.
    tlogits, _ = ttfm.forward_prefill(
        model, tcfg, {"tokens": torch.from_numpy(toks)}, CACHE_LEN,
        impl=impl)
    clear_reference_rules()
    assert not jcommon._ACTIVATION_RULES
    jlogits, _ = jtfm.forward_prefill(
        params, jcfg, {"tokens": jnp.asarray(toks)}, CACHE_LEN, impl=impl)
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(jlogits, np.float32), rtol=TOL,
                               atol=TOL)


def test_port_step_rules_cleared_when_the_step_raises():
    rules = {"batch": "data", "heads": "model"}
    with pytest.raises(RuntimeError, match="inside the step"):
        with tsteps._activation_rules(rules, "mesh", 4, ("data",)):
            assert tcommon._ACTIVATION_RULES == rules
            assert tcommon._ACTIVE["mesh"] == "mesh"
            raise RuntimeError("inside the step")
    assert_port_rules_clear()
    assert tcommon._ACTIVE == {"mesh": None, "batch": 0, "split": None}
