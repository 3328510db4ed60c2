"""``shard_map`` and the collectives of a mesh axis: the port's
counterpart of ``repro.core.jax_compat``.

The reference resolves ``jax.shard_map`` once and runs its expert-
parallel MoE and its compressed gradient reduction inside it, calling
``all_to_all``, ``all_gather``, ``psum`` and ``pmax`` by axis name. Here
a mesh is a ``torch.distributed.DeviceMesh`` whose dims carry those
names, one process a rank, and ``axis_group(mesh, name)`` gives the
process group of one axis. ``shard_map(f, mesh, in_specs, out_specs)``
hands ``f`` each input's local shard by its spec (a DTensor's local
tensor, or the rank's slice of a plain tensor that every rank holds
whole) and wraps ``f``'s outputs as DTensors by ``out_specs``.

Every collective calls ``torch.distributed``'s own ops
(``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``all_reduce``) on a group, so the same code runs
on gloo (CPU ranks, or several ranks on one card) and on NCCL. DTensor
supplies placements and local views only: its ``redistribute``, whose
functional collectives crashed with gloo on CUDA tensors (torch 2.11,
H100), is never called. Those that carry gradients are autograd
functions whose backward is the matching collective:

  ==================  ==========================  =======================
  op                  forward                     backward
  ==================  ==========================  =======================
  ``split``           the rank's chunk of a dim   all-gather of the chunks
  ``gather``          all-gather along a dim      the rank's chunk
  ``copy_in``         identity                    all-reduce (sum)
  ``reduce_out``      all-reduce (sum)            identity
  ``reduce_scatter``  sum, the rank's chunk       all-gather of the chunks
  ``all_to_all``      exchange of dim-0 chunks    the inverse exchange
  ``gather_param``    all-gather of a shard       reduce-scatter (+ sums)
  ==================  ==========================  =======================

A rank's backward holds the gradient of one global loss, which every
rank computes whole: what a rank computes for the whole group
(replicated) gets the whole gradient, what it computes for itself alone
gets its own part. ``COMM`` counts, for each kind of collective, the
calls, the bytes it sent from this rank (``bytes``), its ring-algorithm
wire bytes (``wire``: ``ring_wire_bytes`` of each call's result and
group size, the reference dry run's formulas) and, under
``timing(True)``, the seconds it took, the device synchronised on both
sides.

Several ranks on one card. NCCL refuses them, and gloo moves a CUDA
tensor's bytes through host memory and TCP at about 0.3 GB/s a rank (an
H100 host, 4 ranks, torch 2.11: ``scripts/collective_bandwidth.py``).
``open_mailboxes`` is the explicit choice of another transport for that
case (``launch.mesh.spawn(..., transport="cuda_ipc")``): each rank
allocates a device buffer, the
mailbox, and maps every peer's by CUDA IPC; a collective writes the
rank's part into its mailbox, meets its group at a gloo barrier, reads
its peers' parts from their mailboxes (device-to-device copies, sums in
rank order, so every rank gets the same bits), and meets them again
before the mailbox is reused. Payloads larger than the mailbox go in
pieces. ``COMM["mailbox"]`` counts those bytes apart.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding import rules as shrules

DP_AXES = ("pod", "data")

COMM: dict = {}
_TIMING = [False]
MAILBOX_BYTES = 256 * 2 ** 20


class _Mailboxes:
    """This rank's device mailbox and every rank's, mapped by CUDA IPC."""

    def __init__(self, nbytes: int, device: torch.device):
        from torch.multiprocessing.reductions import reduce_tensor
        self.nbytes = nbytes
        self.box = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        handles = [None] * dist.get_world_size()
        dist.all_gather_object(handles, reduce_tensor(self.box))
        me = dist.get_rank()
        self.peers = [self.box if r == me else fn(*args)
                      for r, (fn, args) in enumerate(handles)]


_MAIL: list = [None]


def open_mailboxes(device: torch.device, nbytes: int = MAILBOX_BYTES):
    """Route every collective on CUDA tensors through device mailboxes
    (a collective over the world: every rank calls it). Only for ranks
    that share one card under gloo: it checks both."""
    if dist.get_backend() != "gloo" or device.type != "cuda":
        raise ValueError("device mailboxes serve gloo ranks on one card")
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(torch.cuda.get_device_properties(
        device).uuid))
    if len(set(devices)) != 1:
        raise ValueError("device mailboxes need every rank on one card")
    _MAIL[0] = _Mailboxes(nbytes, device)


def close_mailboxes() -> None:
    """Drop the peers' mappings (every rank calls it, before exit)."""
    if _MAIL[0] is not None:
        _MAIL[0] = None
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.ipc_collect()


def mailboxes_open() -> bool:
    return _MAIL[0] is not None


def _mail(x: torch.Tensor):
    return _MAIL[0] if _MAIL[0] is not None and x.is_cuda else None


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _meet(group, x) -> None:
    torch.cuda.current_stream(x.device).synchronize()
    dist.barrier(group=group)


def _mail_gather(mail, out, src, group) -> None:
    """all_gather_into_tensor through the mailboxes."""
    ranks = dist.get_process_group_ranks(group)
    sb, ob = _bytes(src), _bytes(out)
    n = sb.numel()
    for off in range(0, n, mail.nbytes):
        size = min(mail.nbytes, n - off)
        mail.box[:size].copy_(sb[off:off + size])
        _meet(group, src)
        for j, r in enumerate(ranks):
            ob[j * n + off:j * n + off + size].copy_(mail.peers[r][:size])
        _meet(group, src)
    _record("mailbox", n * (len(ranks) - 1), None)


def _mail_blocks(mail, src, group, each):
    """Write ``src`` (dim 0 in one block per group rank) into the mailbox
    piecewise, and hand ``each(off, size, parts)`` the peers' pieces of
    this rank's block: ``parts[j]`` from group rank j."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    me = dist.get_rank(group)
    sb = _bytes(src)
    block = sb.numel() // n
    step = (mail.nbytes // n) // 16 * 16
    for off in range(0, block, step):
        size = min(step, block - off)
        for j in range(n):
            mail.box[j * step:j * step + size].copy_(
                sb[j * block + off:j * block + off + size])
        _meet(group, src)
        each(off, size, [mail.peers[r][me * step:me * step + size]
                         for r in ranks])
        _meet(group, src)
    _record("mailbox", block * (n - 1), None)


def _mail_reduce(parts, dtype, op):
    acc = parts[0].view(dtype).clone()
    for p in parts[1:]:
        if op == dist.ReduceOp.MAX:
            torch.maximum(acc, p.view(dtype), out=acc)
        else:
            acc.add_(p.view(dtype))
    return acc


def reset_comm() -> None:
    COMM.clear()


@contextlib.contextmanager
def timing(on: bool = True):
    """Time every collective (host clock, device synchronised)."""
    prev = _TIMING[0]
    _TIMING[0] = on
    try:
        yield
    finally:
        _TIMING[0] = prev


def sent_bytes(kind: str, nbytes: int, group: int) -> int:
    """The bytes ``COMM`` counts for one collective (``bytes``): what
    this rank sends in a ring, the payload for an all-reduce. ``nbytes``
    is the result's bytes, ``group`` the ranks of its group."""
    if kind == "all_gather":
        return nbytes // group * (group - 1)
    if kind == "reduce_scatter":
        return nbytes * (group - 1)
    if kind == "all_to_all":
        return nbytes * (group - 1) // group
    return nbytes


def ring_wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """A collective's wire bytes a rank by the ring formulas of the
    reference's HLO analysis (``repro.launch.hlo_analysis``): ``nbytes``
    is the result's bytes (the payload of an all-reduce), ``group`` the
    ranks of its group."""
    if group <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * nbytes * (group - 1) / group
    if kind in ("all_gather", "all_to_all"):
        return nbytes * (group - 1) / group
    if kind == "reduce_scatter":
        return float(nbytes * (group - 1))
    raise ValueError(f"no ring formula for {kind!r}")


def _record(kind: str, nbytes: int, t0: float | None,
            wire: float = 0.0) -> None:
    entry = COMM.setdefault(kind, {"calls": 0, "bytes": 0, "wire": 0.0,
                                   "s": 0.0})
    entry["calls"] += 1
    entry["bytes"] += int(nbytes)
    entry["wire"] += wire
    if t0 is not None:
        entry["s"] += time.perf_counter() - t0


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _start(x):
    if not _TIMING[0]:
        return None
    _sync(x)
    return time.perf_counter()


def _done(x, kind, t0, nbytes, group):
    """Record one collective with a result of ``nbytes`` over ``group``
    ranks."""
    if t0 is not None:
        _sync(x)
    _record(kind, sent_bytes(kind, nbytes, group), t0,
            ring_wire_bytes(kind, nbytes, group))


# ---------------------------------------------------------------------------
# Axes
# ---------------------------------------------------------------------------

def axis_names(mesh) -> tuple:
    return shrules.axis_names(mesh)


def axis_size(mesh, axis: str) -> int:
    return shrules.mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without the axis)."""
    if axis not in axis_names(mesh):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of one mesh axis."""
    return mesh.get_group(axis)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in DP_AXES if a in axis_names(mesh))


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def dp_index(mesh) -> int:
    """This rank's batch shard over (pod, data), pod-major."""
    i = 0
    for a in dp_axes(mesh):
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    return i


def mesh_device(mesh) -> torch.device:
    """The device this rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_size(mesh) -> int:
    n = 1
    for s in shrules.mesh_shape(mesh).values():
        n *= s
    return n


# ---------------------------------------------------------------------------
# Plain collectives (no autograd); one axis each
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    t0 = _start(src)
    mail = _mail(src)
    if mail is not None:
        _mail_gather(mail, out, src, axis_group(mesh, axis))
    else:
        dist.all_gather_into_tensor(out, src, group=axis_group(mesh, axis))
    _done(src, "all_gather", t0, out.numel() * out.element_size(), n)
    # Contiguous, as the kernels that take gathered weights need.
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, mesh, axis: str
                    ) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    t0 = _start(src)
    mail = _mail(src)
    if mail is not None:
        ob = _bytes(out)

        def each(off, size, parts):
            ob[off:off + size].copy_(_bytes(_mail_reduce(
                parts, src.dtype, dist.ReduceOp.SUM)))
        _mail_blocks(mail, src, axis_group(mesh, axis), each)
    else:
        dist.reduce_scatter_tensor(out, src, group=axis_group(mesh, axis))
    _done(src, "reduce_scatter", t0, out.numel() * out.element_size(), n)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, axis: str, op=None) -> torch.Tensor:
    """Out-of-place all-reduce over one axis (sum unless ``op``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    out = x.contiguous().clone()
    t0 = _start(out)
    mail = _mail(out)
    if mail is not None:
        # Every rank's whole tensor as one block a rank: each reads all.
        group = axis_group(mesh, axis)
        ob = _bytes(out)
        rep = out.reshape(1, -1).expand(n, -1).contiguous()

        def each(off, size, parts):
            ob[off:off + size].copy_(_bytes(_mail_reduce(
                parts, out.dtype, op or dist.ReduceOp.SUM)))
        _mail_blocks(mail, rep, group, each)
    else:
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM,
                        group=axis_group(mesh, axis))
    _done(out, "all_reduce", t0, out.numel() * out.element_size(), n)
    return out


def broadcast(t: torch.Tensor, src: int = 0) -> None:
    """In-place broadcast over the world from rank ``src``."""
    mail = _mail(t)
    if mail is None:
        dist.broadcast(t, src=src)
        return
    tb = _bytes(t)
    world = dist.group.WORLD
    for off in range(0, tb.numel(), mail.nbytes):
        size = min(mail.nbytes, tb.numel() - off)
        if dist.get_rank() == src:
            mail.box[:size].copy_(tb[off:off + size])
        _meet(world, t)
        if dist.get_rank() != src:
            tb[off:off + size].copy_(mail.peers[src][:size])
        _meet(world, t)
    _record("mailbox", tb.numel(), None)


def _chunk(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{n} ranks of {axis!r}")
    step = size // n
    return x.narrow(dim, axis_index(mesh, axis) * step, step)


def _exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """all_to_all_single: dim-0 chunk j goes to rank j of ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    src = x.contiguous()
    out = torch.empty_like(src)
    t0 = _start(src)
    mail = _mail(src)
    if mail is not None:
        ob = _bytes(out)
        block = ob.numel() // n

        def each(off, size, parts):
            for j, p in enumerate(parts):
                ob[j * block + off:j * block + off + size].copy_(p)
        _mail_blocks(mail, src, axis_group(mesh, axis), each)
    else:
        dist.all_to_all_single(out, src, group=axis_group(mesh, axis))
    _done(src, "all_to_all", t0, out.numel() * out.element_size(), n)
    return out


# ---------------------------------------------------------------------------
# Collectives with their backward
# ---------------------------------------------------------------------------

class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _chunk(x, dim, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return _all_gather(g, dim, mesh, axis), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return _chunk(g, dim, mesh, axis).contiguous(), None, None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return all_reduce(g, mesh, axis), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        for a in axes:
            x = all_reduce(x, mesh, a)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _reduce_scatter(x, dim, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return _all_gather(g.contiguous(), dim, mesh, axis), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # The exchange is its own inverse: chunk j of rank i went to rank
        # j as its chunk i.
        mesh, axis = ctx.args
        return _exchange(g, mesh, axis), None, None


def split(x, dim: int, mesh, axis: str):
    """The rank's chunk of a tensor every rank of ``axis`` holds whole;
    the backward all-gathers the chunks' gradients."""
    return _Split.apply(x, dim, mesh, axis)


def gather(x, dim: int, mesh, axis: str):
    """All-gather along ``dim`` over ``axis``, into a tensor every rank
    holds whole; the backward keeps the rank's own chunk of the gradient
    (every rank carries the same loss, so a sum would count it n
    times)."""
    return _Gather.apply(x, dim, mesh, axis)


def copy_in(x, mesh, axis: str):
    """Identity on a tensor every rank of ``axis`` holds whole, entering
    work that the ranks split between them; the backward sums the parts
    of the gradient (Megatron's f)."""
    return _CopyIn.apply(x, mesh, axis)


def reduce_out(x, mesh, axes: Sequence[str]):
    """Sum over ``axes`` of per-rank parts into a whole; the backward
    hands each rank the gradient of the whole (Megatron's g)."""
    return _ReduceOut.apply(x, mesh, tuple(axes))


def reduce_scatter(x, dim: int, mesh, axis: str):
    """The rank's chunk along ``dim`` of the sum over ``axis`` of the
    ranks' partial tensors; the backward hands each rank the gradient of
    the whole sum (the chunks' gradients all-gathered)."""
    return _ReduceScatter.apply(x, dim, mesh, axis)


def all_to_all(x, mesh, axis: str):
    """Exchange of dim-0 chunks over ``axis`` (chunk j to rank j)."""
    return _AllToAll.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# Parameters: local shards of a spec, gathered where they are used
# ---------------------------------------------------------------------------

def _entries(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shard(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (the layout of
    ``DTensor`` with ``rules.placements_for(spec)``)."""
    out = full
    for d, entry in enumerate(spec):
        for a in _entries(entry):          # pod before data: pod-major
            out = _chunk(out, d, mesh, a)
    return out


def gather_full(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from each rank's ``local`` shard (no autograd)."""
    out = local
    for d, entry in enumerate(spec):
        for a in reversed(_entries(entry)):
            out = _all_gather(out, d, mesh, a)
    return out


def to_local(t):
    """The local tensor of a DTensor (itself otherwise)."""
    return t.to_local() if isinstance(t, DTensor) else t


def spec_of(t) -> tuple:
    """The spec of a DTensor's placements (one entry per tensor dim)."""
    names = t.device_mesh.mesh_dim_names
    spec: list = [None] * t.ndim
    for name, pl in zip(names, t.placements):
        if pl.is_shard():
            d = pl.dim
            spec[d] = (name,) if spec[d] is None else spec[d] + (name,)
    return tuple(e[0] if e is not None and len(e) == 1 else e for e in spec)


def make_dtensor(local: torch.Tensor, spec: tuple, mesh, shape) -> DTensor:
    """A DTensor over ``mesh`` from this rank's shard (no communication)."""
    full = torch.Size(shape)
    stride = tuple(torch.empty(full, device="meta").stride())
    return DTensor.from_local(local, mesh, shrules.placements_for(spec, mesh),
                              run_check=False, shape=full, stride=stride)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, spec, mesh, keep, grad_sum, grad_mean):
        ctx.args = (spec, mesh, keep, grad_sum, grad_mean)
        out = local
        for d, entry in enumerate(spec):
            for a in reversed(_entries(entry)):
                if a not in keep:
                    out = _all_gather(out, d, mesh, a)
        return out

    @staticmethod
    def backward(ctx, g):
        spec, mesh, keep, grad_sum, grad_mean = ctx.args
        g = g.contiguous()
        sharded = {}
        for d, entry in enumerate(spec):
            for a in _entries(entry):
                sharded[a] = d
        for a in axis_names(mesh):
            if a in keep:
                continue
            reduce = a in grad_sum or a in grad_mean
            if a in sharded:
                g = (_reduce_scatter(g, sharded[a], mesh, a) if reduce
                     else _chunk(g, sharded[a], mesh, a).contiguous())
            elif reduce:
                g = all_reduce(g, mesh, a)
            if a in grad_mean:
                g = g / axis_size(mesh, a)
        return g, None, None, None, None, None


def gather_param(p, mesh, *, keep: Sequence[str] = (),
                 model: str = "mean", split: Sequence[str] | None = None):
    """The tensor a rank computes with from a sharded parameter ``p`` (a
    DTensor): gathered over every axis but those in ``keep``. Its
    gradient comes back as ``p``'s shard: summed over the axes the batch
    is split on (``split``, every batch axis of the mesh by default: each
    rank's rows add their part), averaged over the batch axes it is kept
    whole on (those ranks hold the same rows), and, where the batch is
    not split on ``"model"``,
    summed there for ``model="sum"`` (the ranks worked on different
    tokens) or averaged for ``model="mean"`` (every model rank computed
    the same part; the mean keeps replicas equal where their arithmetic
    was not bit-equal). A plain tensor is returned as it is."""
    if not isinstance(p, DTensor):
        return p
    names = axis_names(mesh)
    split = dp_axes(mesh) if split is None else tuple(split)
    grad_sum = tuple(a for a in names if a in split)
    grad_mean = tuple(a for a in dp_axes(mesh) if a not in split)
    if "model" in names and "model" not in split:
        if model == "sum":
            grad_sum += ("model",)
        elif model == "mean":
            grad_mean += ("model",)
        else:
            raise ValueError(f"model={model!r}: 'sum' or 'mean'")
    return _GatherParam.apply(p.to_local(), spec_of(p), mesh, tuple(keep),
                              grad_sum, grad_mean)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def shard_map(f: Callable, mesh, in_specs, out_specs):
    """``f`` on every rank's local shards: each input a DTensor (taken as
    its local tensor, which must already have the spec's layout) or a
    plain tensor every rank holds whole (sliced by its spec); each output
    of ``f`` wrapped as a DTensor by its out spec. Specs are tuples with
    one entry per tensor dim, as ``rules.pspec_for`` gives them."""
    def run(*args):
        local = []
        for x, spec in zip(args, in_specs):
            if isinstance(x, DTensor):
                if spec_of(x) != tuple(spec):
                    raise ValueError(f"input laid out as {spec_of(x)}, "
                                     f"in_spec {spec}")
                local.append(x.to_local())
            else:
                local.append(local_shard(x, tuple(spec), mesh))
        outs = f(*local)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        specs = (out_specs,) if single else out_specs
        wrapped = []
        for o, spec in zip(outs, specs):
            shape = list(o.shape)
            for d, entry in enumerate(spec):
                for a in _entries(entry):
                    shape[d] *= axis_size(mesh, a)
            wrapped.append(make_dtensor(o, tuple(spec), mesh, shape))
        return wrapped[0] if single else tuple(wrapped)
    return run
