"""End-to-end serving driver: batched requests through prefill + decode on
a small model, with per-request latency and elastic-vs-reserved cost
break-even (the paper's Table-6 economics at serve time).

    PYTHONPATH=src python -m repro_torch.examples.serverless_serving \\
        [--device cuda]

The port's copy of ``examples/serverless_serving.py``: the port's
``ServingEngine`` on one device (the card unless ``--device cpu``), on
its default kernel route (``impl="flash"``: the flash-attention kernel).
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCHS
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    cfg = ARCHS["internlm2-1.8b"].reduced()
    engine = ServingEngine(cfg, batch_size=4, max_prompt=16, max_len=32,
                           device=args.device)

    rng = np.random.default_rng(0)
    requests = [
        Request(i, rng.integers(0, cfg.vocab_size, rng.integers(4, 16)),
                max_new_tokens=8)
        for i in range(10)
    ]
    t0 = time.time()
    done = engine.serve(requests)
    wall = time.time() - t0

    for r in done[:5]:
        print(f"req {r.request_id}: prompt[{len(r.prompt)}] -> "
              f"completion {r.completion.tolist()} "
              f"({r.latency_s:.2f}s batch latency)")
    print(f"{len(done)} requests in {wall:.2f}s "
          f"({len(done) / wall:.1f} req/s)")
    cost = engine.cost_report(wall, len(done))
    print("cost:", cost)
    return {"done": done, "cost": cost, "vocab_size": cfg.vocab_size}


if __name__ == "__main__":
    main()
