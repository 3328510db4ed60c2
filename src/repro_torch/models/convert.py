"""Weight converter: the reference's parameter tree into the port's model,
and back.

The reference (``repro.models.transformer.init_model``, values taken with
``split_tree``) keeps top-level tensors (``embed``, ``ln_f``,
``lm_head``) and a list of segments, each a dict ``sub{j}`` of parameter
trees stacked on a leading ``layers`` axis. Its scan runs a segment's
unit repeat by repeat, so layer order is: for each segment, for each
repeat r, ``sub0[r], sub1[r], ...``. ``unstack_segments`` walks that
order; every weight keeps the reference's layout (``wq`` (D, H, Dh) and
so on), so the conversion is a copy. Takes numpy arrays (convert with
``np.asarray`` first) and imports nothing of the reference.
``to_reference`` stacks the port's layers back into that tree, for the
parameters or for any dict in their layout (gradients, moments). With a
``mesh``, ``from_reference`` keeps each rank's shards by the rules
(DTensors), and ``to_reference`` gathers a sharded model whole again.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard_map as sm
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as tfm


def _index(tree: Any, r: int) -> Any:
    """``tree`` with every array replaced by its row ``r``."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):          # a cache NamedTuple
        return type(tree)(*(_index(v, r) for v in tree))
    return tree[r]


def unstack_segments(cfg: ArchConfig, segments: list) -> Iterator[tuple]:
    """Yield ``(kind, tree)`` per layer in execution order from the
    reference's stacked segments (parameters or decode caches)."""
    segs = tfm.compute_segments(cfg)
    if len(segs) != len(segments):
        raise ValueError(f"{len(segments)} segments given, the config has "
                         f"{len(segs)}")
    for (unit, repeats), seg in zip(segs, segments):
        for r in range(repeats):
            for j, kind in enumerate(unit):
                yield kind, _index(seg[f"sub{j}"], r)


def _to_torch(tree: Any, device, dtype: Optional[torch.dtype]) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _nest_axes(axes: dict, prefix: str) -> dict:
    return _nest({k[len(prefix) + 1:]: v for k, v in axes.items()
                  if k.startswith(prefix + ".")})


def from_reference(cfg: ArchConfig, params: dict, *, device="cuda",
                   dtype: Optional[torch.dtype] = None, mesh=None,
                   rules: Optional[dict] = None) -> tfm.Model:
    """The port's model holding the reference's weights ``params``
    (numpy arrays) on ``device``, optionally cast to ``dtype``. The
    default, the card, raises when there is none. With ``mesh``, each
    rank keeps its shards of every leaf by the rules, a layer at a
    time."""
    device = resolve_device(device)
    axes = tfm.param_axes(cfg) if mesh is not None else None

    def place(tree, prefix):
        values = _to_torch(tree, device, dtype)
        if mesh is None:
            return values
        return tfm.distribute(values, _nest_axes(axes, prefix), mesh, rules)

    top = place({k: params[k] for k in ("embed", "ln_f", "lm_head")
                 if k in params}, "top")
    layers = [tfm.Layer(kind, place(tree, f"layers.{i}"))
              for i, (kind, tree) in enumerate(
                  unstack_segments(cfg, params["segments"]))]
    return tfm.Model(top, layers)


def _nest(flat: dict) -> dict:
    """{"attn.wq": a, ...} -> {"attn": {"wq": a}, ...}."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _host(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, sm.DTensor):
        t = sm.gather_full(t.to_local().detach(), sm.spec_of(t),
                           t.device_mesh)
    t = t.detach().cpu()
    # numpy has no bfloat16: such leaves come back widened, exactly.
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_reference(cfg: ArchConfig, tree) -> dict:
    """The reference's parameter tree (numpy arrays, segments stacked on
    a leading layers axis) from the port's ``Model`` or from a dict in
    its ``named_parameters()`` layout (gradients, optimizer moments).
    bfloat16 leaves come back as float32. A sharded model is gathered
    whole on every rank (a collective: every rank calls it)."""
    flat = dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else tree
    out = {k: _host(flat[f"top.{k}"]) for k in ("embed", "ln_f", "lm_head")
           if f"top.{k}" in flat}
    layers = _nest({name[len("layers."):]: _host(t)
                    for name, t in flat.items()
                    if name.startswith("layers.")})
    segments, i = [], 0
    for unit, repeats in tfm.compute_segments(cfg):
        seg = {f"sub{j}": _stack([layers[str(i + r * len(unit) + j)]
                                  for r in range(repeats)])
               for j in range(len(unit))}
        segments.append(seg)
        i += len(unit) * repeats
    out["segments"] = segments
    return out
