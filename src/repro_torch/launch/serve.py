"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--device cuda|cpu] [--data D --model M [--pod P] --backend gloo|nccl]``.
Serves the architecture's ``reduced()`` config, as the reference launcher
does; a mesh of more than one rank starts its ranks through
``launch.mesh.spawn`` (see ``launch.train``), and rank 0 prints."""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import mesh_args, world_of
from repro_torch.serve.engine import Request, ServingEngine


def _serve(args) -> tuple:
    mesh = None
    if world_of(args) > 1:
        mesh = mesh_mod.make_local_mesh(args.data, args.model, args.pod,
                                        device_type=args.device)
    cfg = ARCHS[args.arch].reduced()
    engine = ServingEngine(cfg, batch_size=args.batch_size, max_prompt=16,
                           max_len=32, device=args.device, mesh=mesh)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, rng.integers(4, 16)),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    done = engine.serve(reqs)
    wall = time.time() - t0
    return ([(r.request_id, r.completion.tolist()) for r in done], wall,
            engine.cost_report(wall, len(done)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    mesh_args(ap)
    args = ap.parse_args(argv)

    world = world_of(args)
    if world > 1:
        if args.backend is None:
            ap.error(f"a mesh of {world} ranks needs --backend gloo|nccl")
        done, wall, cost = mesh_mod.spawn(_serve, world, args,
                                          backend=args.backend,
                                          device=args.device)[0]
    else:
        done, wall, cost = _serve(args)
    for rid, completion in done:
        print(f"req {rid}: {completion}")
    print(f"{len(done)} requests, {wall:.2f}s,", cost)


if __name__ == "__main__":
    main()
