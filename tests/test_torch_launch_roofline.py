"""``launch.inputs`` and ``launch.roofline`` against the reference's.

For every registered config and every shape of ``SHAPES`` the reference
runs (``shape_applicable``), the port's meta-device inputs have the
shapes and dtypes of the reference's ``ShapeDtypeStruct``s, leaf by leaf
at the same paths, and ``count_params``, ``active_params``
and ``model_flops`` equal the reference's exactly. The roofline terms
use the H100's constants and no TPU one.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shape_applicable
from repro.configs.registry import ARCHS as JARCHS
from repro.launch import inputs as jinputs
from repro.launch import roofline as jroofline
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import inputs, roofline
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

CELLS = [(arch, shape) for arch in sorted(JARCHS) for shape in JSHAPES
         if shape_applicable(JARCHS[arch], JSHAPES[shape])]


def _flat(tree, path=""):
    """(path, leaf) pairs; NamedTuples by field."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _flat(getattr(tree, k), f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _dtype(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return np.dtype(t.dtype).name


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    want = jinputs.input_specs(JARCHS[arch], JSHAPES[shape])
    got = inputs.input_specs(ARCHS[arch], SHAPES[shape])
    w = dict(_flat(want))
    # The port's KV caches carry a host int of slot-split bookkeeping the
    # reference has no field for; it is not an input.
    g = {p: t for p, t in _flat(got) if not p.endswith("/slots")}
    assert sorted(g) == sorted(w)
    for path, t in g.items():
        s = w[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), path
        assert _dtype(t) == _dtype(s), path


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_counts_and_model_flops_equal_reference(arch):
    jcfg, tcfg = JARCHS[arch], ARCHS[arch]
    assert roofline.count_params(tcfg) == jroofline.count_params(jcfg)
    assert roofline.active_params(tcfg) == jroofline.active_params(jcfg)
    for shape in JSHAPES:
        assert roofline.model_flops(tcfg, SHAPES[shape]) \
            == jroofline.model_flops(jcfg, JSHAPES[shape])


def test_roofline_terms_use_h100_constants():
    r = roofline.roofline_terms(989e12, 3.35e12, 450e9, 4, 2 * 989e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
    assert r.useful_flops_ratio == 0.5
    r = roofline.roofline_terms(1e12, 1e12, 0.0, 1, 1e12)
    assert r.bottleneck == "memory"
    assert r.to_dict()["flops_per_device"] == 1e12
    text = open(roofline.__file__).read()
    assert "TPU" not in text and "v5e" not in text


def test_meta_specs_hold_no_storage():
    specs = inputs.input_specs(ARCHS["qwen1.5-110b"], SHAPES["train_4k"])
    assert all(t.device.type == "meta" for _, t in _flat(specs))
