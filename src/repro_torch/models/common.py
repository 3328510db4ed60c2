"""Shared model infrastructure: parameter containers, initializers, norms
and rotary embeddings (the port of ``repro.models.common``).

Parameters are plain tensors held by :class:`Params`, an ``nn.Module``
that mirrors the reference's nested parameter dicts: ``p["wq"]`` reads a
tensor, ``p["attn"]`` a nested group. The reference's logical sharding
axes (``Param``, ``split_tree``, ``shard``) have no counterpart: the port
runs on one device. Initializers draw from an explicit
``torch.Generator`` with the reference's distributions; the numbers
differ from ``jax.random``'s, so parity tests load the reference's
weights through ``models.convert``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
from torch import nn


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

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen, shape, scale: float = 1.0,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape) * (scale / math.sqrt(fan))


def zeros_init(gen, shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def ones_init(gen, shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=gen.device)


def embed_init(gen, shape) -> torch.Tensor:
    return _normal(gen, shape) * 0.02


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
