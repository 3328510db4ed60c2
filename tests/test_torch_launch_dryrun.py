"""The compile-only dry run of the port (``repro_torch.launch.dryrun``)
held against real runs of the same steps, on the CPU.

Each cell's step runs for real on 4 gloo CPU ranks (``launch.mesh.spawn``,
mesh (data 2, model 2)), rank 0 counting its matmul FLOPs
(``FlopCounterMode``) and its collectives (``core.shard_map.COMM``), and
is traced as rank 0 of a fake world of 4 on fake tensors. Both must give
the same FLOPs, the same bytes and ring wire bytes of each collective
kind (the trace reads them from the c10d ops, not from ``COMM``) and the
same parameter bytes a rank, which are also what the rules give. Cells:
a reduced InternLM2 train step (2 microbatches), a deeper one (4 layers,
4 microbatches: the dry run traces 2 and 3 of each and extrapolates), a
reduced MoE prefill (the EP all-to-all path) and a reduced
RecurrentGemma decode step (the slot-split window cache). Extrapolated
counts equal a whole trace's too, and the peak memory within 1%
(it is extrapolated). Also: the reference test's (2, 2, 2) multi-pod
train cell traces with FLOPs and collectives over ``"pod"``; a reduced
config goes through ``run_cell`` on a fake 16x16 world and writes a
record with the reference's keys; ``long_500k`` on a full-attention
arch is the reference's n/a record (the reference runs in a subprocess:
importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``). The same kind of
cells against the reference's own lowering:
``tests/test_torch_launch_reference.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import shard_map as sm
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from reference_source import dict_keys

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# name: (arch, shape, config changes)
CELLS = {
    "train": ("internlm2-1.8b", ShapeConfig("t", 32, 8, "train"),
              {"microbatches": 2}),
    "train_deep": ("internlm2-1.8b", ShapeConfig("t", 32, 16, "train"),
                   {"microbatches": 4, "num_layers": 4}),
    "moe_prefill": ("deepseek-moe-16b", ShapeConfig("p", 32, 8, "prefill"),
                    {}),
    "recurrent_decode": ("recurrentgemma-2b",
                         ShapeConfig("d", 32, 8, "decode"), {}),
}


def _cfg(name):
    arch, _, changes = CELLS[name]
    return dataclasses.replace(ARCHS[arch].reduced(), **changes)


def _local_bytes(model) -> int:
    return sum(p.to_local().numel() * p.element_size()
               for p in model.parameters())


def _rules_bytes(cfg, mesh) -> int:
    shapes, placements = steps.model_shardings(cfg, mesh)
    total = 0
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= s
        for size, pl in zip(mesh.shape, placements[name]):
            n //= size if pl.is_shard() else 1
        total += n * cfg.activation_dtype.itemsize
    return total


def real_rank() -> dict:
    """Each cell's step on this gloo rank: FLOPs, COMM, parameter
    bytes."""
    mesh = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
    out = {}
    for name, (_, shape, _) in CELLS.items():
        cfg = _cfg(name)
        step, args = dryrun.build_step(cfg, shape, mesh, device=CPU)
        sm.reset_comm()
        with FlopCounterMode(display=False) as counter:
            step(*args)
        out[name] = {"flops": counter.get_total_flops(),
                     "comm": {k: dict(v) for k, v in sm.COMM.items()},
                     "params": _local_bytes(args[0]),
                     "rules": _rules_bytes(cfg, mesh)}
    return out


@pytest.fixture(scope="module")
def real():
    return mesh_mod.spawn(real_rank, 4, backend="gloo", device="cpu",
                          timeout=300)


@pytest.fixture(scope="module")
def traced():
    out = {}
    with mesh_mod.fake_world(4):
        mesh = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
        for name, (_, shape, _) in CELLS.items():
            out[name] = dryrun.trace_cell(_cfg(name), shape, mesh,
                                          device_type="cpu")
        whole, _ = dryrun.trace_cell(_cfg("train_deep"),
                                     CELLS["train_deep"][1], mesh,
                                     device_type="cpu", extrapolate=False)
        out["train_deep_whole"] = (whole, None)
    assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("name", list(CELLS))
def test_trace_flops_equal_the_real_rank(real, traced, name):
    assert traced[name][0].dot_flops == real[0][name]["flops"] > 0


@pytest.mark.parametrize("name", list(CELLS))
def test_trace_collectives_equal_comm(real, traced, name):
    summary = traced[name][0]
    comm = real[0][name]["comm"]
    assert set(comm) == set(summary.collective_sent)
    for kind, entry in comm.items():
        assert summary.collective_sent[kind] == entry["bytes"], kind
        assert summary.collective_wire[kind] == pytest.approx(
            entry["wire"], rel=1e-12), kind
        assert summary.collective_counts[kind.replace("_", "-")] == \
            entry["calls"], kind


@pytest.mark.parametrize("name", list(CELLS))
def test_trace_param_bytes_equal_the_rules(real, traced, name):
    want = real[0][name]
    assert traced[name][0].tracked_bytes["params"] == want["params"] \
        == want["rules"]


def test_moe_prefill_takes_the_all_to_all_path(traced):
    assert traced["moe_prefill"][0].collective_counts["all-to-all"] > 0


def test_extrapolated_counts_equal_a_whole_trace(traced):
    cut, info = traced["train_deep"]
    whole = traced["train_deep_whole"][0]
    assert [t["num_layers"] for t in info["traced"]] == [2, 2, 3, 3]
    assert cut.while_trip_counts == [4, 4]
    for field in ("dot_flops", "hbm_bytes", "score_bytes",
                  "collective_counts", "collective_payload",
                  "collective_sent", "collective_wire",
                  "collective_axis_counts", "tracked_bytes", "ops"):
        assert getattr(cut, field) == getattr(whole, field), field
    assert cut.peak_bytes == pytest.approx(whole.peak_bytes, rel=0.01)


def test_multipod_cell_traces_collectives_over_pod():
    """The reference test's miniature multi-pod dry run, on the port."""
    cfg = dataclasses.replace(ARCHS["internlm2-1.8b"].reduced(),
                              microbatches=2)
    with mesh_mod.fake_world(8):
        mesh = mesh_mod.make_local_mesh(2, 2, pod=2, device_type="cpu")
        summary, info = dryrun.trace_cell(
            cfg, ShapeConfig("t", 32, 8, "train"), mesh, device_type="cpu")
    assert summary.dot_flops > 0
    assert summary.collective_axis_counts.get("pod"), \
        summary.collective_axis_counts
    assert info["splits"]["batch_axes"] == ["pod", "data"]


def test_run_cell_on_a_fake_16x16_world_writes_the_reference_keys(
        tmp_path):
    small = ARCHS["internlm2-1.8b"].reduced()
    over = {f.name: getattr(small, f.name)
            for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(ARCHS["internlm2-1.8b"],
                                                 f.name)}
    rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", multi_pod=False,
                          overrides=over, out_dir=tmp_path,
                          device_type="cpu")
    assert not dist.is_initialized()
    written = json.loads(
        (tmp_path / "internlm2-1.8b__decode_32k__16x16.json").read_text())
    assert written == json.loads(json.dumps(rec))
    ref = dict_keys("repro.launch.dryrun", "run_cell", "record")
    renamed = {"lower_s": "trace_s", "compile_s": None,
               "xla_cost_analysis": "flop_counter"}
    want = [renamed.get(k, k) for k in ref if renamed.get(k, k)]
    assert [k for k in rec if k in want] == want
    assert rec["chips"] == 256 and rec["mesh"] == [16, 16]
    assert rec["flop_counter"]["flops"] > 0
    assert rec["collectives"]["counts"]
    assert rec["memory"]["bytes_per_device"] > 0
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck"):
        assert key in rec["roofline"] and key in rec["roofline_kernelized"]


def test_cuda_dry_run_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with mesh_mod.fake_world(4):
        mesh = mesh_mod.make_local_mesh(2, 2, device_type="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.trace_cell(_cfg("train"), CELLS["train"][1], mesh)


def test_na_record_equals_the_reference():
    code = ("import json; from repro.launch import dryrun; "
            "print(json.dumps(dryrun.run_cell('deepseek-7b', 'long_500k', "
            "multi_pod=True)))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert dryrun.run_cell("deepseek-7b", "long_500k", multi_pod=True,
                           device_type="cpu") == want
