#!/usr/bin/env python3
"""Time the one-device serving path of two or more checkouts on one GPU,
in turns.

    git archive 23c19d4 src | tar -x -C build/serve_probe/23c19d4
    git archive 9b7c98d src | tar -x -C build/serve_probe/9b7c98d
    python3 scripts/probe_serve_path.py build/serve_probe/23c19d4 \\
        build/serve_probe/9b7c98d [.] [--rounds 5]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; each TREE needs only its ``src/``. Every round runs one process
per tree, in the order given (A B A B ... over the rounds), each
importing ``repro_torch`` from its own ``src/`` and building its own
kernels (into ``TREE/build/``, so only a tree's first turn compiles).
A process serves, on one card and no mesh, each of the three models
``chip_smoke.py``'s ``serve`` phase serves, at full width and depth on
the same kernel routes (RecurrentGemma-2B and RWKV-6 1.6B on
``impl="flash"``, DeepSeekMoE-16B on ``impl="flash_moe"``; random bf16
weights, seed 0): 8 requests of 1,024-4,096 prompt tokens (numpy seed
0), right-padded to 4,096, in batches of 4, 32 new tokens each. For each
model it records

- ``serve_s``: the wall of one ``ServingEngine.serve`` of the 8 requests
  (after one warm-up batch), as ``chip_smoke.py`` times it;
- per prefill (3 calls of the first batch) and per decode step (16 steps
  after it): the wall (synchronised before and after) and the host time
  until the step returned (``perf_counter``, not synchronised inside);
- one prefill and one decode step under ``torch.profiler``: the device's
  kernel time and the number of kernels; for the decode step also each
  kernel name's device time.

It prints the card's name and power limit, one JSON line per turn, and
one line per (model, metric): each tree's median over the rounds of the
turn's median, with the spread (the fastest and slowest turn), and
whether each later tree's median lies beyond the first tree's spread;
then, per model, the decode step's kernels whose device time moved most
from the first tree's (each tree's median µs of each kernel name).

``--device cpu --small`` rehearses the turns on the CPU with the
``reduced()`` configs and short prompts; its times are no device times.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVINGS = {"recurrentgemma-2b": "flash", "rwkv6-1.6b": "flash",
            "deepseek-moe-16b": "flash_moe"}
BATCH, PROMPT, MIN_PROMPT, NEW_TOKENS, REQUESTS = 4, 4096, 1024, 32, 8
PREFILLS, DECODE_STEPS = 3, 16
KERNEL_NAME = 120          # characters of a kernel's name kept
TOP_KERNELS = 8            # kernels listed by their change in device time


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    """(result, wall s, host s until the call returned)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    host = time.perf_counter() - t0
    _sync(device)
    return out, time.perf_counter() - t0, host


def _profiled(fn, device) -> dict:
    """Device kernel seconds and kernel count of one call of ``fn``, and
    each kernel name's device µs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        fn()
        _sync(device)
    kernel_s, kernels, by_kernel = 0.0, 0, {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or "Memcpy" in evt.key \
                or "Memset" in evt.key:
            continue
        kernel_s += evt.self_device_time_total / 1e6
        kernels += evt.count
        name = evt.key[:KERNEL_NAME]
        by_kernel[name] = by_kernel.get(name, 0.0) \
            + evt.self_device_time_total
    return {"device_s": kernel_s, "kernels": kernels, "by_kernel": by_kernel}


def serve_arch(arch: str, device: str, small: bool) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serve.engine import Request, ServingEngine
    cfg = ARCHS[arch]
    prompt, min_prompt, new = PROMPT, MIN_PROMPT, NEW_TOKENS
    if small:
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
        prompt, min_prompt, new = 32, 8, 4
    eng = ServingEngine(cfg, BATCH, prompt, prompt + new, seed=0,
                        impl=SERVINGS[arch], device=device)
    rng = np.random.default_rng(0)
    lengths = rng.integers(min_prompt, prompt + 1, REQUESTS)

    def requests():
        r = np.random.default_rng(1)
        return [Request(i, r.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=new) for i, n in enumerate(lengths)]

    eng.serve(requests()[:BATCH])                  # warm-up batch
    _, serve_s, _ = _timed(lambda: eng.serve(requests()), device)
    toks = eng._batch_prompts(requests()[:BATCH])
    out = {"serve_s": serve_s, "prefill_s": [], "prefill_host_s": [],
           "decode_ms": [], "decode_host_us": []}
    for _ in range(PREFILLS):
        (logits, caches), wall, host = _timed(
            lambda: eng.prefill(eng.model, {"tokens": toks}), device)
        out["prefill_s"].append(wall)
        out["prefill_host_s"].append(host)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    for t in range(DECODE_STEPS):
        (logits, caches), wall, host = _timed(
            lambda: eng.decode(eng.model, nxt, caches, prompt + t), device)
        out["decode_ms"].append(wall * 1e3)
        out["decode_host_us"].append(host * 1e6)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
    prof = _profiled(lambda: eng.prefill(eng.model, {"tokens": toks}),
                     device)
    out["prefill_device_s"], out["prefill_kernels"] = prof["device_s"], \
        prof["kernels"]
    prof = _profiled(lambda: eng.decode(eng.model, nxt, caches,
                                        prompt + DECODE_STEPS), device)
    out["decode_device_ms"], out["decode_kernels"] = \
        prof["device_s"] * 1e3, prof["kernels"]
    out["decode_by_kernel_us"] = prof["by_kernel"]
    del eng, logits, caches
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def worker(tree: pathlib.Path, device: str, small: bool, archs) -> dict:
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch
    if device == "cuda":
        from repro_torch.kernels import build as kbuild
        kbuild.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
    return {"tree": str(tree), "models": {a: serve_arch(a, device, small)
                                          for a in archs}}


METRICS = ("serve_s", "prefill_s", "prefill_host_s", "decode_ms",
           "decode_host_us", "prefill_device_s", "prefill_kernels",
           "decode_device_ms", "decode_kernels")


def _turn_value(values):
    return statistics.median(values) if isinstance(values, list) else values


def summarize(turns: list[dict], trees: list[str], archs) -> list[dict]:
    rows = []
    for arch in archs:
        for metric in METRICS:
            row = {"model": arch, "metric": metric}
            per = {}
            for t in trees:
                vals = sorted(_turn_value(x["models"][arch][metric])
                              for x in turns if x["tree"] == t)
                per[t] = vals
                row[t] = {"median": statistics.median(vals),
                          "min": vals[0], "max": vals[-1], "turns": vals}
            a = per[trees[0]]
            row["beyond_first_spread"] = {
                t: "slower" if statistics.median(per[t]) > a[-1]
                else "faster" if statistics.median(per[t]) < a[0]
                else "within" for t in trees[1:]}
            rows.append(row)
        rows.append(kernel_changes(turns, trees, arch))
    return rows


def kernel_changes(turns: list[dict], trees: list[str], arch: str) -> dict:
    """The decode step's kernels whose device µs (each tree's median over
    its turns) differ most from the first tree's, with each tree's
    median."""
    med = {}
    for t in trees:
        runs = [x["models"][arch]["decode_by_kernel_us"] for x in turns
                if x["tree"] == t]
        names = set().union(*runs)
        med[t] = {n: statistics.median(r.get(n, 0.0) for r in runs)
                  for n in names}
    names = set().union(*med.values())
    change = {n: max(abs(med[t].get(n, 0.0) - med[trees[0]].get(n, 0.0))
                     for t in trees[1:]) for n in names}
    top = sorted(names, key=change.get, reverse=True)[:TOP_KERNELS]
    return {"model": arch, "metric": "decode_kernel_us_median",
            "kernels": [{"name": n, **{t: med[t].get(n, 0.0)
                                       for t in trees}} for n in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--archs", default=",".join(SERVINGS))
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    archs = args.archs.split(",")
    if args.worker:
        print(json.dumps(worker(pathlib.Path(args.trees[0]), args.device,
                                args.small, archs)))
        return 0
    if len(args.trees) < 2:
        ap.error("give two trees or more")
    smi = "not measured (cpu)"
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = []
    for rnd in range(args.rounds):
        for tree in args.trees:
            cmd = [sys.executable, __file__, tree, "--worker",
                   "--device", args.device, "--archs", args.archs]
            if args.small:
                cmd.append("--small")
            t0 = time.perf_counter()
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=ROOT)
            if done.returncode != 0:
                print(done.stderr[-4000:], file=sys.stderr)
                return done.returncode
            turn = json.loads(done.stdout.strip().splitlines()[-1])
            turn.update(round=rnd, process_s=time.perf_counter() - t0)
            turns.append(turn)
            print(json.dumps(turn), flush=True)
    for row in summarize(turns, args.trees, archs):
        print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
