"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--full-config] [--steps N] [--seq-len L] [--global-batch B]
[--device cuda|cpu]``.

Trains the architecture's ``reduced()`` config by default, the published
one with ``--full-config``, on the card unless ``--device cpu`` is given,
with the reference launcher's schedule (warmup a tenth of the steps).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.registry import ARCHS
from repro_torch.core.storage_service import ObjectStore
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config (default: the reduced "
                         "smoke config)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch] if args.full_config else ARCHS[args.arch].reduced()
    cfg = dataclasses.replace(cfg, microbatches=min(cfg.microbatches,
                                                    args.global_batch))
    trainer = Trainer(
        cfg, ObjectStore(),
        DataConfig(seq_len=args.seq_len, global_batch=args.global_batch),
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps),
        tcfg=TrainerConfig(total_steps=args.steps,
                           checkpoint_every=args.checkpoint_every,
                           log_every=max(args.steps // 10, 1)),
        device=args.device)
    out = trainer.run()
    for m in out.get("metrics", []):
        print(f"step {m['step']:5d} loss {m['loss']:.4f}")
    print(out["status"], out.get("cost", ""))
    return out


if __name__ == "__main__":
    main()
