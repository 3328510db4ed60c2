"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--full-config] [--steps N] [--seq-len L] [--global-batch B]
[--device cuda|cpu] [--data D --model M [--pod P] --backend gloo|nccl]``.

Trains the architecture's ``reduced()`` config by default, the published
one with ``--full-config``, on the card unless ``--device cpu`` is given,
with the reference launcher's schedule (warmup a tenth of the steps).
A mesh of more than one rank (``--data`` x ``--model``, x ``--pod``
when given) starts its ranks on this host through ``launch.mesh.spawn``
with the backend named by ``--backend``: ``nccl`` needs a card a rank,
``gloo`` takes CPU ranks or several ranks on one card.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.registry import ARCHS
from repro_torch.core.storage_service import ObjectStore
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def mesh_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=0)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend of a mesh of more than "
                         "one rank (required there)")


def world_of(args) -> int:
    return args.data * args.model * (args.pod or 1)


def _train(args) -> dict:
    mesh = None
    if world_of(args) > 1:
        mesh = mesh_mod.make_local_mesh(args.data, args.model, args.pod,
                                        device_type=args.device)
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
        device=args.device, mesh=mesh)
    return trainer.run()


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
    mesh_args(ap)
    args = ap.parse_args(argv)

    world = world_of(args)
    if world > 1:
        if args.backend is None:
            ap.error(f"a mesh of {world} ranks needs --backend gloo|nccl")
        out = mesh_mod.spawn(_train, world, args, backend=args.backend,
                             device=args.device)[0]
    else:
        out = _train(args)
    for m in out.get("metrics", []):
        print(f"step {m['step']:5d} loss {m['loss']:.4f}")
    print(out["status"], out.get("cost", ""))
    return out


if __name__ == "__main__":
    main()
