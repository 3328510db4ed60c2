"""Shared model infrastructure: parameter containers with logical
sharding axes, initializers, norms, rotary embeddings and the activation
constraint helper (the port of ``repro.models.common``).

Initializers return ``Param(value, axes)`` pairs, as the reference's do,
so each ``init_*`` is the one source of both a tensor and its logical
axes; ``split_tree`` separates them. The values end up in
:class:`Params`, an ``nn.Module`` that mirrors the reference's nested
parameter dicts: ``p["wq"]`` reads a tensor, ``p["attn"]`` a nested
group. On a mesh each parameter is a DTensor holding the rank's shard by
``sharding.rules`` (see ``models.transformer.init_model``).
Initializers draw from an explicit ``torch.Generator`` with the
reference's distributions; the numbers differ from ``jax.random``'s, so
parity tests load the reference's weights through ``models.convert``.
A generator of ``None`` makes shapes only (on the ``meta`` device):
``transformer.param_axes`` reads the axes of a full-size config so.

``shard`` is the reference's activation constraint. The port has no
activation tensor parallelism (the ranks of ``"model"`` compute the
dense layers of one batch shard each whole), so under a mesh it checks
what the rules leave to check: that an activation holds the rank's
batch shard.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn


class Param(NamedTuple):
    value: torch.Tensor
    axes: tuple            # logical axis names, len == value.ndim


def split_tree(tree):
    """(values, axes): nested dicts of the same structure."""
    if isinstance(tree, Param):
        return tree.value, tree.axes
    values, axes = {}, {}
    for k, v in tree.items():
        values[k], axes[k] = split_tree(v)
    return values, axes


class Params(nn.Module):
    """A nested group of parameters, indexable like the reference's dicts.

    Tensors become ``nn.Parameter``s that do not require gradients
    (serving needs none; the train step switches them on), nested
    mappings become child ``Params``."""

    def __init__(self, tree: Mapping):
        super().__init__()
        self._keys = list(tree)
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name not in self._keys:
            raise KeyError(name)
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Initializers (reference: repro.models.common:47-63)
# ---------------------------------------------------------------------------

def init_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where ``gen`` draws: its device, or ``meta`` for ``None``."""
    return torch.device("meta") if gen is None else gen.device


def _normal(gen: Optional[torch.Generator], shape) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def full_init(gen, shape, axes, value: float) -> Param:
    return Param(torch.full(shape, value, dtype=torch.float32,
                            device=init_device(gen)), axes)


def dense_init(gen, shape, axes, scale: float = 1.0,
               fan_in: Optional[int] = None) -> Param:
    fan = fan_in if fan_in is not None else shape[0]
    return Param(_normal(gen, shape) * (scale / math.sqrt(fan)), axes)


def zeros_init(gen, shape, axes) -> Param:
    return full_init(gen, shape, axes, 0.0)


def ones_init(gen, shape, axes) -> Param:
    return full_init(gen, shape, axes, 1.0)


def embed_init(gen, shape, axes) -> Param:
    return Param(_normal(gen, shape) * 0.02, axes)


# ---------------------------------------------------------------------------
# Logical-axis sharding constraints
# ---------------------------------------------------------------------------

_ACTIVATION_RULES: dict = {}
_ACTIVE: dict = {"mesh": None, "batch": 0, "split": None}


def set_activation_rules(rules: dict, mesh=None, batch: int = 0,
                         split: Optional[tuple] = None) -> None:
    """Install logical->mesh axis rules, the mesh, the global batch and
    the mesh axes the step split that batch over, in its layout's order
    (the step builders call it; ``launch.steps.batch_axes`` chooses
    ``split``)."""
    _ACTIVATION_RULES.clear()
    _ACTIVATION_RULES.update(rules)
    _ACTIVE.update(mesh=mesh, batch=batch,
                   split=None if split is None else tuple(split))


def clear_activation_rules() -> None:
    _ACTIVATION_RULES.clear()
    _ACTIVE.update(mesh=None, batch=0, split=None)


def batch_split(mesh) -> tuple:
    """The mesh axes the running step's batch is split over: what the step
    installed, else every batch axis of the mesh."""
    from repro_torch.core import shard_map as sm
    split = _ACTIVE["split"]
    return sm.dp_axes(mesh) if split is None else split


def gather_param(p, mesh, **kwargs):
    """``core.shard_map.gather_param`` with its gradient reduced over the
    running step's batch split (``batch_split``)."""
    from repro_torch.core import shard_map as sm
    return sm.gather_param(p, mesh, split=batch_split(mesh), **kwargs)


def shard(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """The reference's sharding constraint by logical axes; a no-op
    without a mesh. Under a mesh ``x`` is the rank's local tensor: its
    ``batch`` dim must hold the global batch's share of the axes the
    step split it over (``batch_split``: the rules' batch axes where they
    divide it, as ``launch.steps.batch_shardings`` chooses)."""
    mesh = _ACTIVE["mesh"]
    if not _ACTIVATION_RULES or mesh is None or not _ACTIVE["batch"]:
        return x
    from repro_torch.core import shard_map as sm
    for dim, ax in zip(x.shape, logical_axes):
        if ax != "batch":
            continue
        size = 1
        for a in batch_split(mesh):
            size *= sm.axis_size(mesh, a)
        want = _ACTIVE["batch"] // size
        if dim != want:
            raise ValueError(f"activation batch dim {dim}: the rank's shard "
                             f"of batch {_ACTIVE['batch']} is {want}")
    return x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight).to(dtype)


def group_norm_heads(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_heads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group per head over the channel dim (RWKV
    ln_x): float32 statistics, output in ``x``'s dtype."""
    *lead, d = x.shape
    xs = x.float().reshape(*lead, num_heads, d // num_heads)
    mean = xs.mean(dim=-1, keepdim=True)
    var = xs.var(dim=-1, unbiased=False, keepdim=True)
    xs = ((xs - mean) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (xs * weight + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE), split halves
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    return _rotate(x, angles[..., None, :])                 # (..., S, 1, D/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple = (16, 24, 24),
                theta: float = 1000000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the rotary halves split into temporal,
    height and width sections, each rotated by its own position stream.

    x: (B, S, H, D); positions: (3, B, S); sections sum to D/2."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.as_tensor(sections, device=x.device))
    angles = positions.float()[sec_id]                         # (D/2, B, S)
    angles = angles.movedim(0, -1) * freqs                     # (B, S, D/2)
    return _rotate(x, angles[..., None, :])


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
