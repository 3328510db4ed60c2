"""Step factories for serving: prefill and decode (the port of the serve
half of ``repro.launch.steps``).

The reference bound each step to a mesh and jit-compiled it with explicit
shardings. The port runs on one device, eagerly: each factory returns a
plain closure that runs under ``torch.inference_mode()``. Sharding and
``make_train_step`` wait (ROADMAP A.11, the training slice).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg: ArchConfig, cache_len: int,
                      impl: str = "reference"):
    """``prefill_step(model, batch) -> (last logits (B, V), caches)``."""

    def prefill_step(model, batch: dict):
        with torch.inference_mode():
            return tfm.forward_prefill(model, cfg, batch, cache_len,
                                       impl=impl)

    return prefill_step


def make_decode_step(cfg: ArchConfig, batch_size: int):
    """``decode_step(model, tokens (B, 1), caches, position) -> (logits,
    caches)``; the attention caches are updated in place."""

    def decode_step(model, tokens, caches, position: int):
        if tokens.shape[0] != batch_size:
            raise ValueError(f"decode step built for batch {batch_size}, "
                             f"got {tokens.shape[0]}")
        with torch.inference_mode():
            return tfm.forward_decode(model, cfg, tokens, caches, position)

    return decode_step
