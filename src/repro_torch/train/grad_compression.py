"""Error-feedback int8 gradient compression for the cross-pod reduction
(the port of ``repro.train.grad_compression``).

Per-tensor symmetric int8 quantization (Seide et al. 2014; Tang et al.,
arXiv:2102.02888) cuts the reduction's bytes 4x against float32, with the
quantization error fed back into the next step so convergence holds.

``compressed_psum`` is ported for a mesh without the reduction axis (one
device, or none), where the reference returns the partials unreduced.
The int8 all-gather over a real pod axis is distribution work (ROADMAP
A.5) and raises.
"""
from __future__ import annotations

import torch


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

    ``partials`` leaves carry a leading dim of size n_pods; ``error_state``
    matches. Returns (float32 mean over pods, new error state). ``mesh``
    is a ``torch.distributed.DeviceMesh`` or None; without the ``axis``
    dimension there is one pod, and the partials come back unreduced, as
    in the reference."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        return _tree_map(lambda g: g[0].float(), partials), error_state
    raise NotImplementedError(
        f"compressed_psum over the mesh axis {axis!r}: the int8 all-gather "
        "across processes is distribution work (ROADMAP A.5)")
