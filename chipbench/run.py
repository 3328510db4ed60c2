"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).

Exits with another code than 0, printing no result, where no CUDA device
is there or fewer than the cell asks for, where the port cannot be
imported, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed place inside the checkout, so
# only a checkout's first run builds.
CACHES = {"TORCH_EXTENSIONS_DIR": "build/chipbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/chipbench/triton",
          "CUDA_CACHE_PATH": "build/chipbench/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from chipbench.harness import forbidden_modules, run_cell
    from chipbench.manifest import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
