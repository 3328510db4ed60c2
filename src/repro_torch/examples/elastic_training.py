"""Elastic, fault-tolerant training demo (the paper's serverless execution
model applied to training):

  1. train on one device, checkpointing to the object store,
  2. PREEMPT the worker mid-run (simulated spot reclaim),
  3. resume on every card of the machine as data ranks — restore
     re-shards the state (one card: a plain restore on one device),
  4. verify the loss trajectory continues where it left off.

    PYTHONPATH=src python -m repro_torch.examples.elastic_training \\
        [--device cuda]

The port's copy of ``examples/elastic_training.py``. Phase 2 runs on
``torch.cuda.device_count()`` data ranks (``launch.mesh.spawn``, NCCL)
where the reference uses ``jax.device_count()`` devices, and on one
device, with no mesh, where that count is one (or on ``--device cpu``).
"""
import argparse
import dataclasses

import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.core.storage_service import ObjectStore
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Preempted, Trainer, TrainerConfig

TCFG = TrainerConfig(total_steps=20, checkpoint_every=5, log_every=2)


def _resume_rank(cfg, data, store, world: int) -> dict:
    """Phase 2 on one rank of a (world, 1) mesh."""
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_local_mesh(world, 1, device_type="cuda")
    return Trainer(cfg, store, data, tcfg=TCFG, mesh=mesh).run()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of phase 1, and of phase 2 on one card "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(ARCHS["stablelm-3b"].reduced(),
                              microbatches=2)
    data = DataConfig(seq_len=32, global_batch=4, seed=7)
    store = ObjectStore()

    def preempt_at_12(step):
        if step == 12:
            print(f"  !! simulated preemption at step {step}")
            raise Preempted()

    print("phase 1: training on one device, preempted at step 12")
    t1 = Trainer(cfg, store, data, tcfg=TCFG,
                 preemption_hook=preempt_at_12, device=args.device)
    out1 = t1.run()
    print(f"  status={out1['status']} resumable_from="
          f"{out1['resumable_from']}")

    n_dev = torch.cuda.device_count() \
        if torch.device(args.device).type == "cuda" else 1
    print(f"phase 2: elastic restart on mesh ({n_dev},1) "
          f"— state re-sharded from the object store")
    if n_dev > 1:
        from repro_torch.launch import mesh as mesh_mod
        out2 = mesh_mod.spawn(_resume_rank, n_dev, cfg, data, store, n_dev,
                              backend="nccl", device="cuda")[0]
    else:
        out2 = Trainer(cfg, store, data, tcfg=TCFG,
                       device=args.device).run()
    print(f"  status={out2['status']}")
    for m in out2["metrics"]:
        print(f"  step {m['step']:4d} loss {m['loss']:.4f}")
    print("storage cost:", out2["cost"]["storage"])
    return {"phase1": out1, "phase2": out2, "ranks": n_dev}


if __name__ == "__main__":
    main()
