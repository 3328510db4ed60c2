"""Elastic, fault-tolerant training loop (the port of
``repro.train.trainer``), on one device or on a mesh.

The trainer is the paper's execution model applied to training: workers are
stateless step executors; all durable state (params, optimizer, data
position) lives in the object store. Consequences implemented here:

  * checkpoint/restart — `run()` resumes from the latest manifest; a
    preemption hook can kill the loop at any step (tests do), and a fresh
    Trainer continues bit-exactly;
  * elastic restore — a restart may restore onto another mesh, or onto
    one device: checkpoints hold whole leaves, each restored into the
    new layout;
  * cost accounting — every run reports elastic (fine-grained) vs
    provisioned (reserved pod) cost and the break-even utilisation, the
    paper's Table-6 economics applied to training jobs. As in the
    reference, the run is priced at TPU v5e rates per chip, for the
    mesh's chips (one without a mesh).

On a mesh every rank runs the loop: each draws the same global batch
from the pipeline and the step keeps its rows; rank 0's store holds the
checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import object_store_ckpt as ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.core import pricing
from repro_torch.core import shard_map as sm
from repro_torch.core.device import resolve_device
from repro_torch.core.storage_service import ObjectStore
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as step_factory
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_mod


class Preempted(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 20
    checkpoint_every: int = 5
    seed: int = 0
    log_every: int = 5


class Trainer:
    """Trains on ``mesh`` (a ``DeviceMesh`` with the reference's axis
    names, this process one of its ranks) or, without one, on ``device``:
    the card by default (raises when there is none), ``"cpu"`` when
    asked. ``initial_params``, the reference's parameter tree as numpy
    arrays, replaces the seeded draw of the initial weights."""

    def __init__(self, cfg: ArchConfig, store: ObjectStore,
                 data_cfg: DataConfig,
                 opt_cfg: opt_mod.AdamWConfig = opt_mod.AdamWConfig(),
                 tcfg: TrainerConfig = TrainerConfig(),
                 ckpt_prefix: str = "ckpt",
                 preemption_hook: Optional[Callable[[int], None]] = None,
                 device="cuda", initial_params: Optional[dict] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = sm.mesh_device(mesh) if mesh is not None \
            else resolve_device(device)
        self.store = store
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg
        self.ckpt_prefix = ckpt_prefix
        self.preemption_hook = preemption_hook
        self.initial_params = initial_params
        self.pipeline = TokenPipeline(
            dataclasses.replace(data_cfg, vocab_size=cfg.vocab_size))
        self.step_fn = step_factory.make_train_step(cfg, opt_cfg,
                                                    mesh=mesh)
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self):
        """(model, opt_state): weights drawn from a ``torch.Generator``
        seeded with ``tcfg.seed`` (or ``initial_params``), float32 cast
        to the activation dtype as the reference does."""
        dtype = self.cfg.activation_dtype
        if self.initial_params is not None:
            # Every leaf of the reference's init is float32.
            model = convert.from_reference(self.cfg, self.initial_params,
                                           device=self.device, dtype=dtype,
                                           mesh=self.mesh)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.tcfg.seed)
            model = tfm.init_model(self.cfg, gen, dtype=dtype,
                                   mesh=self.mesh)
        return model, opt_mod.init_opt_state(model, self.opt_cfg)

    def _restore_or_init(self):
        last = ckpt.latest_step(self.store, self.ckpt_prefix, self.mesh)
        model, opt_state = self.init_state()
        if last is None:
            return model, opt_state, 0
        model, _ = ckpt.restore_checkpoint(
            self.store, self.ckpt_prefix, model, step=last,
            device=self.device, mesh=self.mesh)
        opt_state, _ = ckpt.restore_checkpoint(
            self.store, f"{self.ckpt_prefix}-opt", opt_state, step=last,
            device=self.device, mesh=self.mesh)
        return model, opt_state, last

    # ------------------------------------------------------------------
    def run(self) -> dict:
        model, opt_state, start = self._restore_or_init()
        t0 = time.time()
        step = start
        try:
            for step in range(start, self.tcfg.total_steps):
                if self.preemption_hook:
                    self.preemption_hook(step)   # may raise Preempted
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.pipeline.batch_at(step).items()}
                opt_state, metrics = self.step_fn(model, opt_state, batch)
                if (step + 1) % self.tcfg.checkpoint_every == 0 or \
                        step + 1 == self.tcfg.total_steps:
                    self._checkpoint(model, opt_state, step + 1)
                if (step + 1) % self.tcfg.log_every == 0:
                    self.metrics_log.append(
                        {"step": step + 1,
                         "loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"])})
        except Preempted:
            # Stateless worker death: durable state is already in the
            # store; a new Trainer picks up from the last manifest.
            return {"status": "preempted", "at_step": step,
                    "resumable_from":
                    ckpt.latest_step(self.store, self.ckpt_prefix,
                                     self.mesh) or 0}
        wall = time.time() - t0
        return {"status": "done", "steps": self.tcfg.total_steps,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "wall_s": wall, "cost": self.cost_report(wall),
                "metrics": self.metrics_log}

    def _checkpoint(self, model, opt_state, step: int) -> None:
        ckpt.save_checkpoint(self.store, self.ckpt_prefix, step, model)
        ckpt.save_checkpoint(self.store, f"{self.ckpt_prefix}-opt", step,
                             opt_state)

    # ------------------------------------------------------------------
    def cost_report(self, wall_s: float) -> dict:
        """Elastic vs reserved pod economics for this job (paper §5.2)."""
        chips = sm.mesh_size(self.mesh) if self.mesh is not None else 1
        h = wall_s / 3600.0
        elastic = pricing.tpu_pod_cost(chips, h, "on_demand")
        reserved = pricing.tpu_pod_cost(chips, h, "reserved")
        return {"chips": chips, "elastic_usd": elastic,
                "reserved_usd_at_full_utilization": reserved,
                "utilization_breakeven":
                pricing.TPU_V5E_USD_PER_CHIP_H_RESERVED
                / pricing.TPU_V5E_USD_PER_CHIP_H,
                "storage": ckpt.checkpoint_cost(self.store)}
