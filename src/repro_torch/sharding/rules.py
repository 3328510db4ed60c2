"""Logical-axis -> mesh-axis sharding rules (TP / FSDP / EP / SP): a copy
of ``repro.sharding.rules`` without ``jax``.

Parameters and activations use separate rule tables (Megatron/MaxText
style). Rules degrade gracefully: a mesh axis is only applied to a tensor
dim when the dim is divisible by the axis size and the axis is not already
used by another dim of the same tensor (PartitionSpec uniqueness).

A spec is a plain tuple with one entry per tensor dim, each ``None``, a
mesh axis name or a tuple of names: the entries of the reference's
``PartitionSpec``. A mesh is a ``torch.distributed.DeviceMesh``
(``mesh_dim_names``, ``mesh.shape``) or any object with ``axis_names``
and ``devices.shape``, as the reference's tests fake one.
``placements_for`` turns a spec into DTensor placements.
"""
from __future__ import annotations

from typing import Optional, Union

from torch.distributed.tensor import Replicate, Shard

Axis = Union[None, str, tuple]

# Parameter sharding: TP on model for heads/ff/vocab/experts, FSDP (ZeRO)
# on data for the embed dim.
PARAM_RULES: dict[Optional[str], Axis] = {
    "embed": "data",
    "embed_table": "data",
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "layers": None,
    None: None,
}

# Activation constraints: batch over (pod, data); TP'd hidden dims on model.
ACT_RULES: dict[Optional[str], Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    None: None,
}


# The other activation rule sets the reference's steps run (its
# ``launch/hillclimb.py``): pure data parallelism over both mesh axes, no
# TP; and the batch on (pod, data) with only the vocabulary on model.
FSDP_ACT_RULES: dict[Optional[str], Axis] = {
    "batch": ("data", "model"), "seq": None, "embed": None, "ff": None,
    "heads": None, "kv_heads": None, "vocab": None, None: None,
}
ZERO16_ACT_RULES: dict[Optional[str], Axis] = {
    "batch": ("pod", "data"), "seq": None, "embed": None, "ff": None,
    "heads": None, "kv_heads": None, "vocab": "model", None: None,
}
# ACT_RULES without tensor parallelism: every model rank computes the
# dense layers of its batch shard whole.
NO_TP_ACT_RULES: dict[Optional[str], Axis] = {
    **ACT_RULES, "heads": None, "kv_heads": None, "ff": None, "vocab": None,
}


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a JAX-like mesh."""
    if hasattr(mesh, "mesh_dim_names") and mesh.mesh_dim_names is not None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def entry(axis: Axis) -> Axis:
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis
    name is that name, an empty tuple ``None``."""
    if isinstance(axis, (tuple, list)):
        if not axis:
            return None
        return axis[0] if len(axis) == 1 else tuple(axis)
    return axis


def _axis_size(mesh_shape: dict, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= mesh_shape.get(a, 1)
        return size
    return mesh_shape.get(axis, 1)


def _present(axis: Axis, mesh_shape: dict) -> Axis:
    """Drop mesh axes that do not exist in this mesh."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh_shape)
        return kept if kept else None
    return axis if axis in mesh_shape else None


def pspec_for(shape: tuple, logical_axes: tuple, mesh,
              rules: Optional[dict] = None) -> tuple:
    """The spec of one tensor given its logical axes."""
    rules = rules or PARAM_RULES
    shape_of = mesh_shape(mesh)
    used: set = set()
    spec = []
    for dim, logical in zip(shape, logical_axes):
        axis = _present(rules.get(logical), shape_of)
        names = axis if isinstance(axis, tuple) else \
            (axis,) if axis else ()
        size = _axis_size(shape_of, axis)
        if axis is not None and size > 1 and dim % size == 0 \
                and not (set(names) & used):
            used |= set(names)
            spec.append(entry(axis))
        else:
            spec.append(None)
    return tuple(spec)


def placements_for(spec: tuple, mesh) -> list:
    """DTensor placements (one per mesh dim) for ``spec``. A tuple entry
    such as ``("pod", "data")`` on tensor dim d shards d over both mesh
    dims; DTensor splits over the earlier mesh dim first, so the shards
    run pod-major, JAX's order for that entry."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return out


def param_shardings(shapes: dict, axes: dict, mesh,
                    rules: Optional[dict] = None) -> dict:
    """{name: placements} for parameters given {name: shape} and {name:
    logical axes}."""
    return {name: placements_for(pspec_for(tuple(shapes[name]), axes[name],
                                           mesh, rules), mesh)
            for name in shapes}


def batch_pspec(mesh) -> tuple:
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return (entry(axes),)


def activation_rules(mesh) -> dict:
    """ACT_RULES filtered to this mesh (installed via
    common.set_activation_rules)."""
    mesh_axes = set(axis_names(mesh))
    out = {}
    for k, v in ACT_RULES.items():
        if isinstance(v, tuple):
            v = tuple(a for a in v if a in mesh_axes) or None
        elif v is not None and v not in mesh_axes:
            v = None
        out[k] = v
    return out


def cache_logical_axes(kind: str) -> dict:
    """Logical axes for KV / recurrent cache leaves (stacked layer dim)."""
    if kind == "kv":
        return ("layers", "batch", "seq", "kv_heads", None)
    raise ValueError(kind)


def cache_pspec(shape: tuple, mesh) -> tuple:
    """Sharding for a stacked KV-cache leaf (layers, B, S, Hkv, Dh):
    batch -> (pod, data); kv_heads -> model when divisible, else seq ->
    model (sequence-sharded cache), else replicated."""
    shape_of = mesh_shape(mesh)
    tp = shape_of.get("model", 1)
    dp = tuple(a for a in ("pod", "data") if a in shape_of)
    layers, b, s, hkv, dh = shape
    dp_size = 1
    for a in dp:
        dp_size *= shape_of[a]
    if dp and b % dp_size != 0:
        dp = ("data",) if "data" in shape_of \
            and b % shape_of["data"] == 0 else ()
    spec = [None, entry(dp), None, None, None]
    if hkv % tp == 0 and tp > 1:
        spec[3] = "model"
    elif s % tp == 0 and tp > 1:
        spec[2] = "model"
    return tuple(spec)
