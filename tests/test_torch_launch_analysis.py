"""The dry run's trace analysis (``repro_torch.launch.trace_analysis``)
against the reference's HLO analysis (``repro.launch.hlo_analysis``).

Each collective kind at several group sizes: the reference's
``analyze`` on a hand-written HLO line, and the same collective issued
through ``torch.distributed`` on fake tensors in a fake world, traced:
the same count, payload and ring wire bytes, which are also
``core.shard_map.ring_wire_bytes``. The score-shape rule is the
reference's ``_is_score_shape``. The FLOPs, op bytes and peak of a small
eager function are held to a hand reckoning.
"""
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo_analysis
from repro_torch.core.shard_map import ring_wire_bytes
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import trace_analysis as ta
from reference_state import (  # noqa: F401  (autouse fixtures)
    clean_reference_rules, clean_reference_rules_module)

GROUPS = (2, 4, 16)
# kind (HLO name): (operand dims, result dims) for group size g.
SHAPES = {
    "all-gather": (lambda g: (8, 16), lambda g: (8 * g, 16)),
    "reduce-scatter": (lambda g: (8 * g, 16), lambda g: (8, 16)),
    "all-reduce": (lambda g: (8, 16), lambda g: (8, 16)),
    "all-to-all": (lambda g: (8 * g, 16), lambda g: (8 * g, 16)),
}


def _hlo(kind: str, g: int) -> str:
    src, res = (f(g) for f in SHAPES[kind])
    dims = lambda d: ",".join(map(str, d))            # noqa: E731
    groups = "{" + ",".join(map(str, range(g))) + "}"
    return "\n".join([
        "HloModule m",
        "",
        f"ENTRY %main (p0: f32[{dims(src)}]) -> f32[{dims(res)}] {{",
        f"  %p0 = f32[{dims(src)}]{{1,0}} parameter(0)",
        f"  ROOT %c = f32[{dims(res)}]{{1,0}} {kind}(f32[{dims(src)}]{{1,0}}"
        f" %p0), channel_id=1, replica_groups={{{groups}}}, "
        "dimensions={0}",
        "}",
    ])


def _issue(kind: str, g: int):
    """The collective on fake float32 tensors over a group of ``g``."""
    src, res = (f(g) for f in SHAPES[kind])
    x = torch.zeros(src)
    out = torch.empty(res)
    group = dist.new_group(list(range(g)))
    if kind == "all-gather":
        dist.all_gather_into_tensor(out, x, group=group)
    elif kind == "reduce-scatter":
        dist.reduce_scatter_tensor(out, x, group=group)
    elif kind == "all-reduce":
        dist.all_reduce(x, group=group)
    else:
        dist.all_to_all_single(out, x, group=group)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_collective_counts_equal_the_hlo_analysis(kind, g):
    want = hlo_analysis.analyze(_hlo(kind, g), g)
    with mesh_mod.fake_world(16):
        with FakeTensorMode():
            with ta.trace() as t:
                _issue(kind, g)
    got = t.summary()
    assert got.collective_counts == want.collective_counts
    assert got.collective_payload == want.collective_payload
    assert got.collective_wire_bytes == pytest.approx(
        want.collective_wire_bytes, rel=1e-12)
    comm = kind.replace("-", "_")
    assert ring_wire_bytes(comm, want.collective_payload[kind], g) == \
        pytest.approx(want.collective_wire_bytes, rel=1e-12)


@pytest.mark.parametrize("shape", [
    (4, 1024, 1024), (1024, 1024), (2, 8, 4096, 2048), (1024, 1023),
    (1023, 4096), (4096,), (8, 2048, 64), ()])
def test_score_shape_rule_is_the_reference_s(shape):
    type_str = "f32[" + ",".join(map(str, shape)) + "]"
    assert ta.is_score_shape(shape) == \
        hlo_analysis._is_score_shape(type_str)


def test_op_bytes_of_a_small_function_by_hand():
    with FakeTensorMode():
        x = torch.zeros((4, 8))
        w = torch.zeros((8, 16))
        with ta.trace() as t:
            t.mode.track((x, w), "inputs")
            y = x @ w                  # 4*8*4 + 8*16*4 read, 4*16*4 written
            z = torch.relu(y)          # 256 read, 256 written
            del y
            v = z.t()                  # a view: nothing moves
            s = v.sum()                # 256 read, 4 written
    got = t.summary()
    assert got.dot_flops == 2 * 4 * 8 * 16
    assert got.hbm_bytes == (128 + 512 + 256) + (256 + 256) + (256 + 4)
    assert got.score_bytes == 0
    assert got.tracked_bytes == {"inputs": 128 + 512}
    # x, w, y and z alive together, then y freed before s.
    assert got.peak_bytes == 128 + 512 + 256 + 256
    assert got.collective_counts == {}
    assert s.shape == ()


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_composite_copies_under_inference_mode_by_hand(fake):
    """Under ``inference_mode`` ``to``, ``contiguous`` and ``reshape``
    reach the mode whole; each copy they make is counted and stays live
    while a view of it does (prefill caches keep the last row of every
    layer's normalised input)."""
    with FakeTensorMode() if fake else torch.no_grad():
        x = torch.zeros((4, 256))                         # float32, 4 KiB
        with ta.trace() as t, torch.inference_mode():
            t.mode.track(x, "inputs")
            h = (x * 2).to(torch.bfloat16)   # 4096 + 4096, then 4096 + 2048
            same = h.to(torch.bfloat16)      # no copy
            c = x.t().contiguous()           # 4096 read, 4096 written
            r = x.t().reshape(-1)            # a copy: 4096 + 4096, and a
            #                                  view of it (_unsafe_view)
            last = h[-1]                     # a view keeps h's storage
            del h, same
    got = t.summary()
    assert got.hbm_bytes == (4096 + 4096) + (4096 + 2048) + 2 * (4096 + 4096)
    # The float32 product is freed after the cast; x, h, c and r remain.
    assert got.peak_bytes == t.mode.live == 4096 + 2048 + 4096 + 4096
    assert last.shape == (256,) and c.shape == (256, 4)
    assert r.shape == (1024,)
