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

``shard`` is the reference's activation constraint. Under a mesh the
port runs the reference's activation tensor parallelism on ``"model"``:
a logical axis whose installed act rule maps it to ``"model"`` is split
over the model ranks where its size divides their count (the reference's
``rules.pspec_for`` degradation; none where the batch is split over
``"model"`` itself). ``model_split`` answers that question, ``tp_weight``
fetches the rank's column- or row-parallel slice of a weight (its
``"model"`` shard, FSDP axes gathered) or a weight whole, and
``enter_tp``/``leave_tp`` are Megatron's f and g around the split work.
``shard`` then checks that an activation holds the rank's share of every
axis: the batch and each split axis.
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


def installed_rules() -> tuple:
    """(act rules, mesh, batch split) of the running step; ``({}, None,
    ())`` outside one."""
    mesh = _ACTIVE["mesh"]
    if not _ACTIVATION_RULES or mesh is None:
        return {}, None, ()
    return _ACTIVATION_RULES, mesh, batch_split(mesh)


def model_split(axis: str, size: int, *, rules=None, mesh=None,
                split=None) -> bool:
    """Whether logical ``axis`` of size ``size`` is split over
    ``"model"``: the rules map it there, the mesh has more than one model
    rank, ``size`` divides over them and the batch is not split over
    ``"model"`` already (a mesh axis takes one dim of a tensor). The
    running step's rules, mesh and batch split unless given."""
    if rules is None:
        rules, mesh, split = installed_rules()
    if mesh is None or not rules:
        return False
    from repro_torch.sharding import rules as shrules
    tp = shrules.mesh_shape(mesh).get("model", 1)
    want = rules.get(axis)
    return (tp > 1 and "model" not in tuple(split or ())
            and "model" in (want if isinstance(want, tuple) else (want,))
            and size % tp == 0)


def tp_size() -> int:
    _, mesh, _ = installed_rules()
    from repro_torch.core import shard_map as sm
    return 1 if mesh is None else sm.axis_size(mesh, "model")


def tp_rank() -> int:
    _, mesh, _ = installed_rules()
    from repro_torch.core import shard_map as sm
    return 0 if mesh is None else sm.axis_index(mesh, "model")


def tp_weight(p, dim: Optional[int] = None, *, grad: str = "mean"):
    """The tensor a rank computes with from weight ``p``. With ``dim``,
    the rank's slice of ``dim`` over ``"model"`` (column- or
    row-parallel): the weight's own ``"model"`` shard where the
    parameter rules put it on ``dim`` (its gradient stays the rank's),
    else the whole weight cut (its gradient gathered back). Without
    ``dim``, the whole weight; ``grad`` says how its gradient meets over
    ``"model"``: ``"sum"`` where the model ranks use it for different
    work (inside a split region), ``"mean"`` where they all do the same.
    Outside a step a sharded weight is gathered whole, a plain tensor
    returned as it is."""
    from repro_torch.core import shard_map as sm
    _, mesh, _ = installed_rules()
    if mesh is None:
        return gather_param(p, p.device_mesh) \
            if isinstance(p, sm.DTensor) else p
    if dim is None:
        return gather_param(p, mesh, model=grad)
    if isinstance(p, sm.DTensor):
        spec = sm.spec_of(p)
        if spec[dim % p.ndim] == "model":
            return gather_param(p, mesh, keep=("model",))
    return sm.split(gather_param(p, mesh), dim, mesh, "model")


def enter_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x``, whole on every model rank, enters work the
    model ranks split; the backward sums their parts of its gradient."""
    _, mesh, _ = installed_rules()
    from repro_torch.core import shard_map as sm
    return sm.copy_in(x, mesh, "model")


def leave_tp(y: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the model ranks' partial outputs of a row-parallel
    product summed into the whole."""
    _, mesh, _ = installed_rules()
    from repro_torch.core import shard_map as sm
    return sm.reduce_out(y, mesh, ("model",))


def shard(x: torch.Tensor, logical_axes: tuple, **sizes) -> torch.Tensor:
    """The reference's sharding constraint by logical axes; a no-op
    without a mesh. Under a mesh ``x`` is the rank's local tensor: its
    ``batch`` dim must hold the global batch's share of the axes the
    step split it over (``batch_split``), and each other axis named in
    ``sizes`` (its global size) the rank's share of it: the size over
    the model ranks where ``model_split`` splits it, else all of it."""
    rules, mesh, split = installed_rules()
    if mesh is None or not _ACTIVE["batch"]:
        return x
    from repro_torch.core import shard_map as sm
    for dim, ax in zip(x.shape, logical_axes):
        if ax == "batch":
            n = 1
            for a in split:
                n *= sm.axis_size(mesh, a)
            want, full = _ACTIVE["batch"] // n, _ACTIVE["batch"]
        elif ax in sizes:
            full = sizes[ax]
            want = full // sm.axis_size(mesh, "model") \
                if model_split(ax, full) else full
        else:
            continue
        if dim != want:
            raise ValueError(f"activation {ax} dim {dim}: the rank's share "
                             f"of {full} is {want}")
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
    # The section of each rotary pair, from the host tuple (a repeat
    # count held in a tensor would make the output size data-dependent).
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)
    angles = positions.float()[sec_id]                         # (D/2, B, S)
    angles = angles.movedim(0, -1) * freqs                     # (B, S, D/2)
    return _rotate(x, angles[..., None, :])


# ---------------------------------------------------------------------------
# YaRN (arXiv:2309.00071), as DeepSeek-V2's modeling code computes it
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """0.1 mscale ln(factor) + 1 (1 at a factor of 1 or less)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_dim(rotations: float, dim: int, theta: float, max_pos: int):
    """The rotary pair index whose wavelength fits ``rotations`` turns in
    ``max_pos`` positions."""
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) \
        / (2 * math.log(theta))


def yarn_freqs(dim: int, theta: float, factor: float, max_pos: int,
               beta_fast: float, beta_slow: float,
               device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies: the plain ones for the pairs that turn
    more than ``beta_fast`` times in ``max_pos`` positions, those divided
    by ``factor`` for the pairs that turn fewer than ``beta_slow`` times,
    and a linear ramp between; in float32, operation for operation as the
    published modeling code computes them."""
    powers = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=device) / dim)
    extra, inter = 1.0 / powers, 1.0 / (factor * powers)
    low = max(math.floor(_yarn_dim(beta_fast, dim, theta, max_pos)), 0)
    high = min(math.ceil(_yarn_dim(beta_slow, dim, theta, max_pos)),
               dim - 1)
    if low == high:
        high += 0.001
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32,
                                device=device) - low)
                  / (high - low)).clamp(0, 1)
    return inter * (1 - mask) + extra * mask


def rotary_freqs(cfg, dim: int, device=None) -> torch.Tensor:
    """The config's inverse frequencies for ``dim`` rotary dims."""
    if cfg.rope_scaling == "yarn":
        return yarn_freqs(dim, cfg.rope_theta, cfg.rope_factor,
                          cfg.rope_original_max, cfg.yarn_beta_fast,
                          cfg.yarn_beta_slow, device)
    if cfg.rope_scaling != "none":
        raise ValueError(f"unknown rope_scaling {cfg.rope_scaling!r}")
    return rope_freqs(dim, cfg.rope_theta, device)


def rotary_mscale(cfg) -> float:
    """The factor on cos and sin: mscale over mscale_all_dim (1 where they
    are equal, as in DeepSeek-V2)."""
    if cfg.rope_scaling != "yarn":
        return 1.0
    return yarn_mscale(cfg.rope_factor, cfg.yarn_mscale) / \
        yarn_mscale(cfg.rope_factor, cfg.yarn_mscale_all_dim)


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor, cfg
                     ) -> torch.Tensor:
    """Rotary over adjacent pairs (dims 2i, 2i + 1), the layout of
    DeepSeek-V2's published weights, at the config's frequencies; the
    output in split-halves order (dims 2i to i, 2i + 1 to i + D/2), as its
    modeling code leaves it. x: (..., S, H, D); positions: broadcastable
    to (..., S)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    angles = positions[..., None].float() * rotary_freqs(cfg, d, x.device)
    out = _rotate(x, angles[..., None, :])
    mscale = rotary_mscale(cfg)
    return out if mscale == 1.0 else (out.float() * mscale).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
