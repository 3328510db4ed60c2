"""The port's dry run held against the reference's own lowering of the
same reduced cells, on the CPU.

``tests/test_torch_launch_dryrun.py`` holds the trace against real runs
of the port's step; that checks the port against itself. Here the same
cells are lowered and compiled by the reference (``repro.launch.steps``
on 8 or 4 host devices, in a subprocess so that its ``XLA_FLAGS`` stay
there) and read with ``repro.launch.hlo_analysis.analyze``, and the
port's trace (``repro_torch.launch.dryrun.trace_cell`` on a fake world)
must do the same work:

  * the same dot FLOPs a rank, exactly, but for two named differences
    (``GAP``), each a partitioning choice of XLA that the port's
    explicit layout does not make;
  * collectives over the same mesh axes; on each axis no kind the
    reference does not issue there, reading the port's reduce-scatter
    as an all-reduce (XLA's CPU pipeline reduces a gradient that stays
    sharded with an all-reduce and keeps its slice: it forms no
    reduce-scatter here); and an all-reduce on the same axes.

The reference issues more kinds than the port: an all-to-all over
``"data"`` and collective-permutes that re-lay its inputs, and (multi-pod
train) all-gathers over ``"pod"`` that its SPMD partitioner adds around
the embedding lookup ("involuntary full rematerialization"). The port's
layout needs none of them.

The reference's meshes take ``Auto`` axes: under jax 0.9 the
``Explicit`` axes ``jax.make_mesh`` now makes by default fail its steps
(ROADMAP C.1, ``test_distribution.py::test_small_dryrun_multipod_cell``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from reference_source import REPO_ROOT
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

# name: (arch, seq, batch, kind, mesh (pod, data, model) or (data,
# model), config changes): the reference test's multi-pod train cell,
# and one cell of each family and step kind on (data 2, model 2).
CELLS = {
    "train_multipod": ("internlm2-1.8b", 32, 8, "train", (2, 2, 2),
                       {"microbatches": 2}),
    "train_moe": ("deepseek-moe-16b", 32, 8, "train", (2, 2),
                  {"microbatches": 2}),
    "prefill_dense": ("internlm2-1.8b", 32, 8, "prefill", (2, 2), {}),
    "prefill_moe": ("deepseek-moe-16b", 32, 8, "prefill", (2, 2), {}),
    "prefill_recurrent": ("recurrentgemma-2b", 32, 8, "prefill", (2, 2),
                          {}),
    "prefill_rwkv": ("rwkv6-1.6b", 32, 8, "prefill", (2, 2), {}),
    "decode_dense": ("internlm2-1.8b", 32, 8, "decode", (2, 2), {}),
    "decode_recurrent": ("recurrentgemma-2b", 32, 8, "decode", (2, 2), {}),
}

REFERENCE = """
import dataclasses, json, re, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs.base import ShapeConfig
from repro.configs.registry import ARCHS
from repro.launch import hlo_analysis, inputs, steps
from repro.train.optimizer import AdamWConfig

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
OP = re.compile(r"= [^=]*? (" + "|".join(KINDS) + r")(-start)?\\(")
IOTA = re.compile(r"replica_groups=\\[([0-9,]+)\\]<=\\[([0-9,]+)\\]"
                  r"(?:T\\(([0-9,]+)\\))?")


def groups(line):
    m = IOTA.search(line)
    if m:
        ids = np.arange(int(np.prod([int(x) for x in m.group(2).split(",")])))
        ids = ids.reshape([int(x) for x in m.group(2).split(",")])
        if m.group(3):
            ids = ids.transpose([int(x) for x in m.group(3).split(",")])
        return ids.reshape(int(m.group(1).split(",")[0]), -1).tolist()
    m = re.search(r"(?:replica_groups|source_target_pairs)="
                  r"\\{(\\{[0-9, ]*\\}(?:,\\{[0-9, ]*\\})*)\\}", line)
    if not m:
        return []
    return [[int(x) for x in g.split(",") if x.strip()]
            for g in re.findall(r"\\{([0-9, ]*)\\}", m.group(1))]


def axes(text, mesh):
    # {mesh axis: kinds} of the collectives whose group holds device 0.
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    out = {}
    for line in text.splitlines():
        op = OP.search(line)
        for g in groups(line) if op else []:
            if 0 not in g:
                continue
            coords = [np.argwhere(ids == d)[0] for d in g]
            for i, name in enumerate(mesh.axis_names):
                if len({int(c[i]) for c in coords}) > 1:
                    out.setdefault(name, set()).add(op.group(1))
    return {k: sorted(v) for k, v in out.items()}


out = {}
for name, (arch, seq, batch, kind, dims, changes) in json.loads(
        sys.argv[1]).items():
    names = ("pod", "data", "model")[-len(dims):]
    mesh = jax.make_mesh(tuple(dims), names,
                         axis_types=(AxisType.Auto,) * len(dims))
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **changes)
    shape = ShapeConfig("c", seq, batch, kind)
    spec = inputs.input_specs(cfg, shape)
    if kind == "train":
        step, _ = steps.make_train_step(cfg, mesh, AdamWConfig(),
                                        global_batch=batch)
        low = step.lower(spec["params"], spec["opt_state"], spec["batch"])
    elif kind == "prefill":
        step, _ = steps.make_prefill_step(cfg, mesh, cache_len=seq,
                                          global_batch=batch)
        low = step.lower(spec["params"], spec["batch"])
    else:
        step, _ = steps.make_decode_step(cfg, mesh, batch, seq)
        low = step.lower(spec["params"], spec["tokens"], spec["caches"],
                         spec["position"])
    text = low.compile().as_text()
    s = hlo_analysis.analyze(text, int(np.prod(dims)))
    out[name] = {"flops": s.dot_flops, "axes": axes(text, mesh)}
print(json.dumps(out))
"""


def _cfg(name):
    arch, *_, changes = CELLS[name]
    return dataclasses.replace(ARCHS[arch].reduced(), **changes)


def _gap(name) -> float:
    """The port's dot FLOPs a rank less the reference's, by cause."""
    cfg = _cfg(name)
    _, seq, batch, kind, dims, _ = CELLS[name]
    data, tp = dims[-2], dims[-1]
    if name == "decode_recurrent":
        # RecurrentGemma's one KV head does not split over "model": each
        # model rank computes the K and V projections whole, where XLA
        # splits their contraction over "model" and all-reduces.
        attn = sum(k == "local" for k in cfg.layer_kinds())
        rows = batch // data
        return attn * 2 * (2 * rows * cfg.d_model * cfg.num_kv_heads
                           * cfg.head_dim) * (tp - 1) / tp
    if name == "train_moe":
        # XLA's backward of the shared experts does one more dot of their
        # forward's size a MoE layer and microbatch than twice the
        # forward; the port's backward is twice its forward (the two
        # agree on the forward and the recomputed forward).
        moe_layers = cfg.num_layers - cfg.moe.first_k_dense
        rows = batch * seq // cfg.microbatches // data
        return -(moe_layers * cfg.microbatches * 2 * rows * cfg.d_model
                 * cfg.moe.shared_d_ff // tp)
    return 0.0


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         json.dumps(CELLS)], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def traced():
    out = {}
    for name, (_, seq, batch, kind, dims, _) in CELLS.items():
        world = 1
        for d in dims:
            world *= d
        with mesh_mod.fake_world(world):
            mesh = mesh_mod.make_local_mesh(
                dims[-2], dims[-1], pod=dims[0] if len(dims) == 3 else 0,
                device_type="cpu")
            out[name], _ = dryrun.trace_cell(
                _cfg(name), ShapeConfig("c", seq, batch, kind), mesh,
                device_type="cpu")
    assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("name", list(CELLS))
def test_dot_flops_equal_the_reference_lowering(reference, traced, name):
    got, want = traced[name].dot_flops, reference[name]["flops"]
    assert want > 0
    assert got - want == _gap(name), (got, want)


def _kinds(by_axis: dict) -> dict:
    return {axis: {"all-reduce" if k == "reduce-scatter" else k
                   for k in kinds} for axis, kinds in by_axis.items()}


@pytest.mark.parametrize("name", list(CELLS))
def test_collectives_run_over_the_reference_axes(reference, traced, name):
    got = _kinds(traced[name].collective_axis_counts)
    want = _kinds(reference[name]["axes"])
    assert set(got) == set(want), (got, want)
    for axis, kinds in got.items():
        assert kinds <= want[axis], (axis, kinds, want[axis])
        assert ("all-reduce" in kinds) == ("all-reduce" in want[axis]), axis
