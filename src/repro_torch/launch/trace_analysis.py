"""One rank's step, counted op by op: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference compiles each step for 256 or 512 placeholder devices and
parses the per-device SPMD module's HLO. The port has no HLO: it runs
eagerly, so each aten op is one kernel boundary. A dry run runs the step
as rank 0 of a fake world (``launch.mesh.fake_world``) on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage), and
``TraceMode``, a ``TorchDispatchMode`` entered under the fake mode, sees
every aten op and every c10d collective the rank issues. Its
``TraceSummary`` has the fields of ``HloSummary``, all per rank:

  * dot_flops     — ``torch.utils.flop_counter.FlopCounterMode``'s count
                    of the step's matmuls and convolutions;
  * hbm_bytes     — input and output bytes of every aten op that is not a
                    view (nor a metadata or allocation op), composite
                    ops counted as the ops they run: the counterpart of
                    the reference's fusion-boundary rule, an upper bound
                    of what fused kernels move;
  * score_bytes   — the part of ``hbm_bytes`` of ops whose output has two
                    trailing dims >= 1024 (``is_score_shape``): the
                    materialised attention scores that a flash kernel
                    keeps on chip;
  * collective_counts / collective_payload / collective_wire_bytes — by
                    kind (the reference's HLO names), read from the c10d
                    ops and their group's ``size()``: the payload is the
                    result's bytes (an all-reduce's tensor), the wire
                    bytes the reference's ring formulas
                    (``core.shard_map.ring_wire_bytes``). Independent of
                    the port's own ``COMM`` bookkeeping, as the HLO parse
                    is of JAX code; ``collective_sent`` converts each call
                    to ``COMM``'s ``bytes`` convention for comparisons;
                    given the mesh, ``collective_axis_counts`` and
                    ``collective_axis_wire`` split them by mesh axis;
  * while_trip_counts — ``[]``: the step's loops are Python loops,
                    unrolled in the trace (``launch.dryrun`` fills in the
                    trip counts it extrapolates over).

Composite ops (``to``, ``contiguous``, ``reshape``, ``einsum``,
``matmul``) reach the mode whole where autograd is off (prefill and
decode run under ``inference_mode``); the mode decomposes them, as
autograd does in a train step, so a copy they make is counted and kept
live like any op's output, not taken for a view.

Memory: the tracker follows storages, not tensors. Those that exist
before the step (parameters, optimizer state, inputs) are registered
with ``track`` by category; every storage an op creates is counted from
its first output until Python frees it (a weak reference's callback).
``peak_bytes`` is the most bytes alive at once; the categories give
parameters, optimizer state and inputs apart, and the rest of the peak
is the step's activations, gradients and temporaries.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.shard_map import ring_wire_bytes, sent_bytes

# c10d dispatcher ops: (kind as the reference's HLO names it, COMM's
# name, the index of the argument that holds the result).
COLLECTIVES = {
    "c10d._allgather_base_": ("all-gather", "all_gather", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "reduce_scatter", 0),
    "c10d.allreduce_": ("all-reduce", "all_reduce", 0),
    "c10d.alltoall_base_": ("all-to-all", "all_to_all", 0),
}
# Ops that read or write no tensor data: metadata, allocation, aliasing.
ZERO_COST = {
    "prim.device", "aten.detach", "aten.empty", "aten.empty_strided",
    "aten.new_empty", "aten.new_empty_strided", "aten.empty_like",
    "aten.lift_fresh", "aten.alias", "aten._unsafe_view",
    "aten._local_scalar_dense",
    "aten.sym_size", "aten.sym_stride", "aten.sym_numel",
    "aten.sym_storage_offset", "aten.is_same_size", "aten.set_",
    "c10d.barrier", "c10d.wait",
}


def is_score_shape(shape, min_dim: int = 1024) -> bool:
    """A materialised attention-score tensor: its two trailing dims are
    both sequence-sized (the reference's ``_is_score_shape``)."""
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _group(args):
    """The process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("a c10d op without its process group")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class TraceSummary:
    dot_flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    collective_counts: dict
    collective_payload: dict
    while_trip_counts: list
    score_bytes: float = 0.0
    # By COMM's name: each call's bytes in COMM's ``bytes`` convention,
    # and its wire bytes.
    collective_sent: dict = dataclasses.field(default_factory=dict)
    collective_wire: dict = dataclasses.field(default_factory=dict)
    # {mesh axis: {kind: calls}} and {mesh axis: {kind: wire bytes}}.
    collective_axis_counts: dict = dataclasses.field(default_factory=dict)
    collective_axis_wire: dict = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    tracked_bytes: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class TraceMode(TorchDispatchMode):
    """Counts what the ops dispatched under it move, and the storages they
    keep alive; enter it under ``FakeTensorMode`` (``trace`` does).
    With ``mesh`` each collective is also filed under its mesh axis
    (``"world"`` for a group that is none of the mesh's)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.axes = {} if mesh is None else {
            mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
        self.axis_counts: dict = {}
        self.axis_wire: dict = {}
        self.hbm = 0.0
        self.score = 0.0
        self.ops = 0
        self.counts: dict = {}
        self.payload: dict = {}
        self.sent: dict = {}
        self.wire: dict = {}
        self.live = 0
        self.peak = 0
        self.tracked: dict = {}
        self._refs: dict = {}

    # -- memory --------------------------------------------------------
    def _freed(self, key, nbytes):
        self._refs.pop(key, None)
        self.live -= nbytes

    def _add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return 0
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, k=key, n=nbytes: self._freed(k, n))
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        return nbytes

    def track(self, tensors, category: str) -> None:
        """Count the storages of ``tensors`` (any nesting; DTensors by
        their local tensors) as ``category`` from now on."""
        for t in tree_flatten(tensors)[0]:
            if isinstance(t, torch.Tensor):
                t = t.to_local() if hasattr(t, "to_local") else t
                self.tracked[category] = self.tracked.get(category, 0) \
                    + self._add(t)

    # -- ops -----------------------------------------------------------
    def _collective(self, name, args, out):
        kind, comm, i = COLLECTIVES[name]
        res = args[i]
        tensors = res if isinstance(res, (list, tuple)) else [res]
        nbytes = sum(_nbytes(t) for t in tensors)
        group = _group(args)
        g = group.size()
        sent = sent_bytes(comm, nbytes, g)
        wire = ring_wire_bytes(comm, nbytes, g)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.payload[kind] = self.payload.get(kind, 0.0) + nbytes
        self.sent[comm] = self.sent.get(comm, 0) + sent
        self.wire[comm] = self.wire.get(comm, 0.0) + wire
        axis = self.axes.get(group.group_name, "world")
        counts = self.axis_counts.setdefault(axis, {})
        counts[kind] = counts.get(kind, 0) + 1
        wires = self.axis_wire.setdefault(axis, {})
        wires[kind] = wires.get(kind, 0.0) + wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if name not in COLLECTIVES and name != "prim.device":
            # A composite op (``to``, ``contiguous``, ``reshape``,
            # ``einsum``, ``matmul``: what reaches the mode whole where
            # autograd is off, as in prefill and decode) counted as the
            # ops it runs: its copies are no views, its temporaries live.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if name in ZERO_COST or getattr(func, "is_view", False):
            return out
        self.ops += 1
        if name in COLLECTIVES:
            self._collective(name, args, out)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.hbm += nbytes
        if any(is_score_shape(t.shape) for t in outs):
            self.score += nbytes
        for t in outs:
            self._add(t)
        return out

    def summary(self, dot_flops: float) -> TraceSummary:
        return TraceSummary(
            float(dot_flops), self.hbm, sum(self.wire.values()),
            dict(self.counts), dict(self.payload), [], self.score,
            dict(self.sent), dict(self.wire), self.axis_counts,
            self.axis_wire, float(self.peak),
            dict(self.tracked), self.ops)


class trace:
    """``with trace(mesh) as t: ...`` counts the FLOPs (``FlopCounterMode``)
    and the ops (``TraceMode``) of what runs inside; ``t.summary()``
    after. ``t.mode.track(...)`` registers storages made before."""

    def __init__(self, mesh=None):
        self.flops = FlopCounterMode(display=False)
        self.mode = TraceMode(mesh)

    def __enter__(self):
        self.flops.__enter__()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.flops.__exit__(*exc)

    def summary(self) -> TraceSummary:
        return self.mode.summary(self.flops.get_total_flops())
