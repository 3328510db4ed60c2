"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--device cuda|cpu]``. Serves the architecture's ``reduced()`` config,
as the reference launcher does."""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCHS
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced()
    engine = ServingEngine(cfg, batch_size=args.batch_size, max_prompt=16,
                           max_len=32, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, rng.integers(4, 16)),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    done = engine.serve(reqs)
    wall = time.time() - t0
    for r in done:
        print(f"req {r.request_id}: {r.completion.tolist()}")
    print(f"{len(done)} requests, {wall:.2f}s,",
          engine.cost_report(wall, len(done)))


if __name__ == "__main__":
    main()
