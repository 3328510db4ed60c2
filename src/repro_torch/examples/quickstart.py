"""Quickstart: train a reduced-config model end-to-end with the full
substrate — object-store checkpointing, burst-aware data pipeline, elastic
cost accounting.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch internlm2-1.8b] [--steps 30] [--device cuda]

The port's copy of ``examples/quickstart.py``: the ``Trainer`` runs on
one device (the card unless ``--device cpu``) where the reference builds
a (1, 1) mesh.
"""
import argparse
import dataclasses

from repro_torch.configs.registry import ARCHS
from repro_torch.core.storage_service import ObjectStore
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(ARCHS[args.arch].reduced(), microbatches=2)
    store = ObjectStore()
    trainer = Trainer(
        cfg, store,
        DataConfig(seq_len=64, global_batch=8, seed=0),
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
        tcfg=TrainerConfig(total_steps=args.steps, checkpoint_every=10,
                           log_every=5),
        device=args.device)
    out = trainer.run()
    print(f"arch={args.arch} status={out['status']}")
    for m in out["metrics"]:
        print(f"  step {m['step']:4d} loss {m['loss']:.4f} "
              f"|grad| {m['grad_norm']:.3f}")
    if out["metrics"]:      # none logged in a run shorter than log_every
        first, last = out["metrics"][0]["loss"], out["metrics"][-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    print("cost report:", out["cost"])
    manifests = [k for k in store.list() if k.endswith("MANIFEST.json")]
    print("checkpoints in store:", manifests)
    return {**out, "manifests": manifests, "store": store,
            "trainer": trainer}


if __name__ == "__main__":
    main()
