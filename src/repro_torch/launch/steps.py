"""Step factories: train, prefill and decode (the port of
``repro.launch.steps`` on one device).

The reference bound each step to a mesh and jit-compiled it with explicit
shardings. The port runs on one device, eagerly: each factory returns a
plain closure. The serving steps run under ``torch.inference_mode()``;
the train step differentiates ``forward_train`` with autograd and updates
the model in place. Meshes and shardings wait for the distribution slice
(ROADMAP A.5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_mod


def _split_microbatches(batch: dict, micro: int) -> list[dict]:
    """``micro`` consecutive slices of the batch (axis 1 of
    ``mrope_positions``, axis 0 of the rest), as the reference's reshape
    splits it."""
    def split(key, leaf, i):
        axis = 1 if key == "mrope_positions" else 0
        b = leaf.shape[axis]
        if b % micro:
            raise ValueError(f"{key}: batch {b} is not a multiple of "
                             f"{micro} microbatches")
        return leaf.narrow(axis, i * (b // micro), b // micro)
    return [{k: split(k, v, i) for k, v in batch.items()}
            for i in range(micro)]


def make_train_step(cfg: ArchConfig, opt_cfg: opt_mod.AdamWConfig,
                    impl: str = "reference"):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``:
    forward and backward over ``cfg.microbatches`` microbatches, then the
    AdamW update of ``model``'s parameters in place. With microbatches
    the gradients are summed in float32 and divided by their count; with
    one they stay in the parameters' dtype, as the reference types them.
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` (device
    scalars). The kernel routes have no backward pass (nor have the
    reference's Pallas kernels), so ``impl`` is ``"reference"`` or
    ``"blocked"``."""
    if impl not in ("reference", "blocked"):
        raise ValueError(f"impl {impl!r} runs forward-only kernels; train "
                         "with 'reference' or 'blocked'")
    micro = cfg.microbatches

    def loss_and_grads(model, params, mb):
        loss, _ = tfm.forward_train(model, cfg, mb, impl=impl)
        # A parameter the loss does not reach gets zeros, as under jax.grad.
        return loss.detach(), torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True)

    def train_step(model, opt_state, batch: dict):
        names, params = zip(*model.named_parameters())
        for p in params:
            p.requires_grad_(True)
        if micro > 1:
            acc, loss_sum = None, 0.0
            for mb in _split_microbatches(batch, micro):
                loss, grads = loss_and_grads(model, params, mb)
                if acc is None:
                    acc = [g.float() for g in grads]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                del grads
                loss_sum = loss_sum + loss
            grads = [a.div_(micro) for a in acc]
            loss = loss_sum / micro
        else:
            loss, grads = loss_and_grads(model, params, batch)
        _, opt_state, metrics = opt_mod.apply_updates(
            model, dict(zip(names, grads)), opt_state, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


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
