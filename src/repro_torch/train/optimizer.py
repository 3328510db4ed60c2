"""AdamW with a cosine schedule (the port of ``repro.train.optimizer``).

The reference's arithmetic in its order: the update math in float32,
moments stored in ``moment_dtype`` (bfloat16 by default, which halves
the optimizer's memory), bias corrections from the step as float32,
decoupled weight decay on matrices only (``ndim > 1``, counted in the
reference's layout: see ``decays``) and global-norm clipping.
``torch.optim.AdamW`` differs (eps and decay placement), so it is not
used.

Parameters, gradients and moments are flat dicts of tensors by name: a
``Model``'s ``named_parameters()`` (a ``Model`` may be passed as the
parameters) or any dict of tensors. ``apply_updates`` writes the new
parameters and moments in place under ``torch.no_grad()``; the step,
learning rate and clip scale stay on the parameters' device, so an
update waits on no host read.

On a mesh the parameters, gradients and moments are DTensors of one
layout, and each rank updates its local shards. ``global_norm`` is the
norm of the whole gradient: every rank's local sum of squares, divided
by the number of ranks holding a copy of that shard, summed over the
mesh by an all-reduce.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core import shard_map as sm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "bfloat16"


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: dict
    nu: dict


def named_tensors(params) -> dict:
    """``params`` as a dict of tensors by name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    flat = named_tensors(params)
    device = next(iter(flat.values())).device if flat else None
    def zeros(p):
        if isinstance(p, DTensor):
            return sm.make_dtensor(
                torch.zeros(p.to_local().shape, dtype=dt, device=p.device),
                sm.spec_of(p), p.device_mesh, p.shape)
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    {k: zeros(p) for k, p in flat.items()},
                    {k: zeros(p) for k, p in flat.items()})


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tree) -> torch.Tensor:
    total, mesh = 0, None
    for x in named_tensors(tree).values():
        part = torch.sum(torch.square(_local(x).float()))
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            copies = 1
            for size, pl in zip(mesh.shape, x.placements):
                copies *= 1 if pl.is_shard() else size
            part = part / copies
        total = total + part
    if mesh is not None:
        for axis in sm.axis_names(mesh):
            total = sm.all_reduce(total, mesh, axis)
    return torch.sqrt(total)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay reaches ``p``: matrices only, as the reference
    decides it on its own tree, where the segments stack each layer's
    tensors on a leading layers axis. So a ``Model``'s per-layer tensors
    (names ``layers.<i>.``) count one dimension more: per-layer vectors
    (norm scales, biases, the RG-LRU's ``lam``) are decayed, the
    top-level ``top.ln_f`` is not."""
    return p.ndim + name.startswith("layers.") > 1


def update_leaf(p, g, m, v, *, lr, scale, b1c, b2c, decay: bool,
                cfg: AdamWConfig):
    """One tensor's AdamW update, written into ``p``, ``m`` and ``v``;
    ``decay`` adds the decoupled weight decay. ``lr``, ``scale``,
    ``b1c`` and ``b2c`` are float32 scalars. The
    float32 temporaries are reused in place once their value is stored
    (the same roundings as the reference's expression), so the largest
    leaf costs about four float32 copies of itself."""
    f32 = torch.float32
    g32 = g.float() * scale
    m32 = m.to(f32, copy=True).mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    v32 = v.to(f32, copy=True).mul_(cfg.b2).add_(
        g32.square_().mul_(1 - cfg.b2))
    del g32
    m.copy_(m32)
    v.copy_(v32)
    delta = m32.div_(b1c)                                   # mhat
    delta.div_(v32.div_(b2c).sqrt_().add_(cfg.eps))         # sqrt(vhat)+eps
    del v32
    if decay:
        delta.add_(cfg.weight_decay * p.float())
    p.copy_(p.float().sub_(delta.mul_(lr)))


def apply_updates(params, grads: dict, state: OptState, cfg: AdamWConfig):
    """Returns (params, new_state, metrics); ``params`` and the moments
    are updated in place, ``grads`` (a dict by the same names) is only
    read."""
    flat = named_tensors(params)
    with torch.no_grad():
        step = state.step + 1
        lr = schedule(step, cfg)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if cfg.grad_clip else 1.0
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        for name, p in flat.items():
            update_leaf(_local(p), _local(grads[name]),
                        _local(state.mu[name]), _local(state.nu[name]),
                        lr=lr, scale=scale, b1c=b1c, b2c=b2c,
                        decay=decays(name, p), cfg=cfg)
    return params, OptState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": gnorm}
