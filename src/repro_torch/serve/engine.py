"""Batched serving engine: prefill + decode over fixed batch slots, with
elastic-vs-provisioned cost accounting (the port of
``repro.serve.engine``).

Serving is the paper's "sporadic workload" case: the engine tracks
request-level latency and per-request cost in both deployment models and
reports the break-even request rate (Table 6's argument at serve time).

The reference's behaviour is kept as it is, quirks included: prompts are
padded on the right to ``max_prompt`` (the docstring below, copied from
the reference, says left), the first token comes from the last slot's
logits, all slots decode in lockstep from position ``max_prompt``, and
``cost_report`` prices the run with the TPU rates of ``core.pricing``,
for the mesh's chips (one without a mesh).

On a mesh every rank runs the engine on the same requests: the steps keep
the rank's prompts over the axes they split the batch on (``(pod,
data)``, or ``data``, or none where the batch does not divide them), and
each step's new tokens are all-gathered over those axes, so every rank
returns the same completions. The steps run the tensor parallelism of
``act_rules`` (the reference's ``ACT_RULES`` by default): the prefill
builds each rank's caches in the layout ``steps.cache_shardings`` gives
(its KV heads, or its block of slots, its RWKV heads, its RG-LRU
channels), so a rank allocates only its shards, and both steps return
logits gathered over the vocabulary, which are sampled as without a
mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import pricing
from repro_torch.core import shard_map as sm
from repro_torch.core import tracing
from repro_torch.core.device import resolve_device
from repro_torch.launch import steps as step_factory
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 8
    completion: Optional[np.ndarray] = None
    latency_s: float = 0.0


class ServingEngine:
    """Static-batch engine with greedy sampling; prompts are left-padded to
    the slot width, decoding advances all slots in lockstep and finished
    slots are refilled from the queue (continuous batching, lite).

    ``impl`` selects the prefill route: ``"flash"`` (the default: the
    hand-written attention, RG-LRU and RWKV-6 kernels), ``"flash_moe"``
    (the grouped-matmul kernel in the MoE layers, the flash-attention
    kernel in every layer's attention) or ``"reference"``.
    Weights are drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed`` and cast to the config's activation dtype. With ``mesh`` (this
    process one of its ranks) the rank's device takes the place of
    ``device``, and each rank keeps its shards of the same weights;
    ``act_rules`` places the activations (see the module's docstring)."""

    def __init__(self, cfg: ArchConfig, batch_size: int, max_prompt: int,
                 max_len: int, seed: int = 0, *, impl: str = "flash",
                 device="cuda", mesh=None, act_rules: Optional[dict] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = sm.mesh_device(mesh) if mesh is not None \
            else resolve_device(device)
        self.batch_size = batch_size
        self.max_prompt = max_prompt
        self.max_len = max_len
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = tfm.init_model(cfg, gen, dtype=cfg.activation_dtype,
                                    mesh=mesh)
        self.prefill = step_factory.make_prefill_step(
            cfg, cache_len=max_len, impl=impl, mesh=mesh,
            act_rules=act_rules)
        self.decode = step_factory.make_decode_step(
            cfg, batch_size, mesh=mesh, act_rules=act_rules)
        # The axes the steps split the batch over, as the decode step
        # chose them (``()`` without a mesh).
        self.batch_axes = self.decode.batch_axes
        self.step_count = 0

    def _next_tokens(self, logits) -> torch.Tensor:
        """Greedy tokens of the whole batch (under a mesh, the ranks'
        rows all-gathered over the axes the steps split the batch on,
        pod-major)."""
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if self.mesh is not None:
            for axis in reversed(self.batch_axes):
                tok = sm.gather(tok, 0, self.mesh, axis)
        return tok

    def _batch_prompts(self, reqs: list[Request]) -> torch.Tensor:
        toks = np.zeros((self.batch_size, self.max_prompt), np.int32)
        for i, r in enumerate(reqs):
            p = r.prompt[-self.max_prompt:]
            toks[i, :len(p)] = p
        return torch.from_numpy(toks).to(self.device)

    def serve(self, requests: list[Request]) -> list[Request]:
        """Process all requests in batches; returns them with completions.
        A request's ``latency_s`` runs from its batch's start to the
        moment its last token is on the host (``time.perf_counter``)."""
        done: list[Request] = []
        queue = list(requests)
        while queue:
            batch = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            with tracing.span("serve.batch", batch=batch[0].request_id,
                              size=len(batch)):
                done += self._serve_batch(batch)
        return done

    def _serve_batch(self, batch: list[Request]) -> list[Request]:
        cfg = self.cfg
        t0 = time.perf_counter()
        toks = self._batch_prompts(batch)
        batch_inputs = {"tokens": toks}
        if cfg.input_mode == "embeddings":
            embed = self.model["embed"]
            if self.mesh is not None:
                embed = sm.gather_param(embed, self.mesh)
            emb = embed[toks]
            batch_inputs = {"embeds": emb.to(cfg.activation_dtype)}
            if cfg.rope == "mrope":
                s = toks.shape[1]
                batch_inputs["mrope_positions"] = torch.arange(
                    s, dtype=torch.int32, device=self.device)[
                        None, None].expand(3, toks.shape[0], s)
        with tracing.span("serve.prefill"):
            logits, caches = self.prefill(self.model, batch_inputs)
        outs = [list() for _ in batch]
        next_tok = self._next_tokens(logits)
        max_new = max(r.max_new_tokens for r in batch)
        pos = self.max_prompt
        # on_host[n]: seconds from the batch's start until n tokens of
        # every request are on the host.
        on_host = [0.0]
        for t in range(max_new):
            with tracing.span("serve.readback"):
                host = next_tok.tolist()
            on_host.append(time.perf_counter() - t0)
            for i in range(len(batch)):
                outs[i].append(host[i])
            with tracing.span("serve.decode"):
                logits, caches = self.decode(self.model, next_tok[:, None],
                                             caches, pos + t)
            next_tok = self._next_tokens(logits)
            self.step_count += 1
        for i, r in enumerate(batch):
            r.completion = np.asarray(outs[i][: r.max_new_tokens])
            r.latency_s = on_host[r.max_new_tokens]
        return batch

    # ------------------------------------------------------------------
    def cost_report(self, wall_s: float, n_requests: int) -> dict:
        chips = sm.mesh_size(self.mesh) if self.mesh is not None else 1
        h = wall_s / 3600.0
        elastic = pricing.tpu_pod_cost(chips, h, "on_demand")
        per_req = elastic / max(n_requests, 1)
        pod_per_h = pricing.tpu_pod_cost(chips, 1.0, "reserved")
        return {
            "per_request_usd": per_req,
            "breakeven_requests_per_hour": pod_per_h / max(per_req, 1e-12),
            "chips": chips,
        }
