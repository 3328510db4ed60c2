"""Meta-device stand-ins for every model input of a (arch, shape) cell:
the port of ``repro.launch.inputs``.

Each function returns tensors on the ``meta`` device (shapes and dtypes,
no storage) in the reference's layout: ``param_specs`` is the
reference's parameter tree (``embed``, ``ln_f``, ``lm_head`` and the
segments, each ``sub{j}`` stacked on a leading layers axis), float32
leaves in the config's activation dtype; ``cache_specs`` the reference's
stacked decode caches. Nothing is drawn: the trees come from
``transformer._param_trees`` with no generator and from
``transformer.init_cache`` on ``meta``. Modality frontends are stubs, as
in the reference: their embeddings appear as dense (B, S, D) inputs.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.common import split_tree
from repro_torch.train import optimizer as opt_mod

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    out: dict = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = _meta((b, s, cfg.d_model), cfg.activation_dtype)
        if cfg.rope == "mrope":
            out["mrope_positions"] = _meta((3, b, s), torch.int32)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
    return out


def _stack(trees: list) -> Any:
    """Trees of equal structure stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, KVCache):           # the length as an int32 row
        return KVCache(_stack([t.k for t in trees]),
                       _stack([t.v for t in trees]),
                       _meta((len(trees),), torch.int32))
    if isinstance(first, tuple):             # a recurrent state
        return type(first)(*(_stack([t[i] for t in trees])
                             for i in range(len(first))))
    return _meta((len(trees),) + tuple(first.shape), first.dtype)


def _segments(cfg: ArchConfig, layers: list) -> list:
    """Per-layer trees (execution order) as the reference's segments."""
    out, i = [], 0
    for unit, repeats in tfm.compute_segments(cfg):
        out.append({f"sub{j}": _stack([layers[i + r * len(unit) + j]
                                       for r in range(repeats)])
                    for j in range(len(unit))})
        i += len(unit) * repeats
    return out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return _meta(tree.shape, dtype if tree.dtype == torch.float32
                 else tree.dtype)


def param_specs(cfg: ArchConfig) -> dict:
    top, layers = None, []
    for i, _, tree in tfm._param_trees(cfg, None):
        values, _ = split_tree(tree)
        values = _cast(values, cfg.activation_dtype)
        if i is None:
            top = values
        else:
            layers.append(values)
    return {**top, "segments": _segments(cfg, layers)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def opt_specs(cfg: ArchConfig, opt_cfg: opt_mod.AdamWConfig):
    params = param_specs(cfg)
    dt = torch.bfloat16 if opt_cfg.moment_dtype == "bfloat16" \
        else torch.float32

    def zeros(p):
        return _meta(p.shape, dt)
    return opt_mod.OptState(_meta((), torch.int32), _map(zeros, params),
                            _map(zeros, params))


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> list:
    caches = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                            cfg.activation_dtype, device=META)
    return _segments(cfg, caches)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                opt_cfg: opt_mod.AdamWConfig = opt_mod.AdamWConfig()
                ) -> dict:
    """All inputs for the step function of this (arch, shape) cell."""
    if shape.kind == "train":
        return {"params": param_specs(cfg),
                "opt_state": opt_specs(cfg, opt_cfg),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": param_specs(cfg), "batch": batch_specs(cfg, shape)}
    return {"params": param_specs(cfg),
            "tokens": batch_specs(cfg, shape)["tokens"],
            "caches": cache_specs(cfg, shape),
            "position": _meta((), torch.int32)}
