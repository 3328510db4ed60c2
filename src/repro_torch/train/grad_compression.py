"""Error-feedback int8 gradient compression for the cross-pod reduction
(the port of ``repro.train.grad_compression``).

The multi-pod mesh reduces gradients over the 'pod' axis across the
slow inter-pod network. Per-tensor symmetric int8 quantization (Seide et
al. 2014; Tang et al., arXiv:2102.02888) cuts those bytes 4x against
float32, with the quantization error fed back into the next step so
convergence holds.

``compressed_psum`` runs quantize -> all-gather -> dequantize inside
``core.shard_map.shard_map`` over the reduction axis, so the collective
payload really is int8 on the wire: ``all_gather_into_tensor`` of
``torch.int8`` on the axis' process group, counted in
``core.shard_map.COMM``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import shard_map as sm


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale)."""
    amax = torch.max(torch.abs(x.float()))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grad: torch.Tensor, error: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one tensor: returns
    (q, scale, new_error)."""
    target = grad.float() + error
    q, scale = quantize_int8(target)
    new_error = target - dequantize_int8(q, scale)
    return q, scale, new_error


def init_error_state(grads):
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)


def compressed_psum(partials, error_state, mesh=None, axis: str = "pod"):
    """Mean-reduce per-``axis`` partial gradients with int8 payloads.

    ``partials`` leaves carry a leading dim of size n_pods, sharded over
    ``axis``: DTensors, or tensors every rank holds whole (each rank takes
    its row); ``error_state`` matches. Returns (float32 mean over pods,
    new error state) as DTensors: the mean replicated, the error state
    sharded as the partials. Without the ``axis`` dimension (or without a
    mesh) there is one pod, and the partials come back unreduced, as in
    the reference.

    Exactness: a shared scale is agreed by an all-reduce (max) *before*
    quantization, so the int32-accumulated sum dequantizes exactly; only
    the per-pod quantization error remains, and that is fed back next
    step. Wire payload per tensor: 1 byte/element (+ a scalar), against
    4 for float32.
    """
    names = sm.axis_names(mesh) if mesh is not None else ()
    if axis not in names:
        return _tree_map(lambda g: sm.to_local(g)[0].float(), partials), \
            error_state
    n = sm.axis_size(mesh, axis)

    def one(g, e):
        def local(gl, el):
            gl = gl[0].float()
            el = el[0]
            target = gl + el
            amax = sm.all_reduce(torch.max(torch.abs(target)), mesh, axis,
                                 op=dist.ReduceOp.MAX)
            scale = torch.clamp(amax, min=1e-12) / 127.0
            q = torch.clamp(torch.round(target / scale), -127, 127)
            # int8 on the wire (an int8 sum would overflow; gather then
            # accumulate locally in int32)
            gathered = sm.gather(q.to(torch.int8)[None], 0, mesh, axis)
            total = torch.sum(gathered.to(torch.int32), dim=0)
            out = total.float() * scale / n
            new_e = target - q * scale
            return out, new_e[None]

        in_spec = (axis,) + (None,) * (g.ndim - 1)
        out_spec = (None,) * (g.ndim - 1)
        return sm.shard_map(local, mesh, in_specs=(in_spec, in_spec),
                            out_specs=(out_spec, in_spec))(g, e)

    outs = _tree_map(one, partials, error_state)
    return (_tree_map(lambda o: o[0], outs),
            _tree_map(lambda o: o[1], outs))
