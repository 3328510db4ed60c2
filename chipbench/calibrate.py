"""Readings that a cell's limits are set from, in one process.

    python3 chipbench/calibrate.py --workload <cell> --seeds <n> \
        --control-seeds <m> [--first-seed <s>]

Builds the cell's engine once; then for each of ``n`` seeds draws that
seed's weights into it, serves the first batches of the seed's window
(as many as a run judges, at the cell's own batch and prompt lengths),
and judges them against the reference as a run does. For the first ``m``
seeds it also judges the control: the reference in float8 put in the
program's place, its highest logits and the tokens it puts first read at
the same prompts and fed tokens. Each side's readings go through the
run's own verdict (``harness.decide``, with the cell's limits and its
request checks): ``correct`` and ``control_correct``. Prints one JSON
line a seed, then the lower reading (the program's largest of each
number), the upper one (the control's smallest), and the verdicts.

Not run by the benchmark's runs; ``calibrate`` also runs at a tiny size
in the CPU tests.
"""
import argparse
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def calibrate(cell, seeds, control_seeds, device, log=print) -> dict:
    import torch
    from repro_torch.serve.engine import ServingEngine
    from chipbench import check
    from chipbench.harness import StepProbe, _serve_batch, arch_config, \
        decide
    from chipbench.traffic import Traffic
    from chipbench.weights import Weights

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    arch, ref = cell.config["arch"], cell.reference()
    first = Traffic(cell.traffic, arch["vocab_size"], seeds[0])
    engine = ServingEngine(
        arch_config(arch), first.batch, first.prompt_len,
        first.prompt_len + first.new_tokens, seed=0,
        impl=cell.config["impl"], device=dev)
    probes = (StepProbe(engine.prefill, "prefill", sync),
              StepProbe(engine.decode, "decode", sync))
    engine.prefill, engine.decode = probes
    batches_needed = math.ceil(int(cell.traffic["check"]["requests"])
                               / first.batch)
    lows, highs, verdicts, control_verdicts = {}, {}, [], []
    for seed in seeds:
        t0 = time.perf_counter()
        weights = Weights(ref.weight_groups(arch), seed, dev,
                          getattr(torch, arch["dtype"]))
        weights.load_into(engine.model)
        traffic = Traffic(cell.traffic, arch["vocab_size"], seed)
        batches = [_serve_batch(engine, traffic, "window", i, probes, sync)
                   for i in range(batches_needed)]
        got = check.judge(cell, arch, weights, traffic, batches, seed, dev,
                          control=seed in control_seeds)
        got["seconds"] = time.perf_counter() - t0
        got["seed"] = seed
        got["correct"] = decide(cell, batches, got)["correct"]
        if "control" in got:
            got["control_correct"] = decide(
                cell, batches, dict(got, program=got["control"]))["correct"]
        log(json.dumps(got))
        verdicts.append(got["correct"])
        if "control_correct" in got:
            control_verdicts.append(got["control_correct"])
        for k, v in got["program"].items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in got.get("control", {}).items():
            highs[k] = min(highs.get(k, math.inf), v)
    summary = {"lower": lows, "upper": highs, "seeds": len(seeds),
               "control_seeds": len(control_seeds), "correct": verdicts,
               "control_correct": control_verdicts}
    log(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 77_000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from chipbench.manifest import load_cell
    if not torch.cuda.is_available():
        print("calibrate runs on a CUDA device", file=sys.stderr)
        return 2
    seeds = [args.first_seed + i for i in range(args.seeds)]
    calibrate(load_cell(args.workload, ROOT), seeds,
              set(seeds[:args.control_seeds]), "cuda",
              log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
