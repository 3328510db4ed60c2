#!/usr/bin/env python3
"""Bandwidth of the port's collectives between 4 ranks on one card.

    python3 scripts/collective_bandwidth.py [--device cuda|cpu]

Starts 4 ranks on a (data 2, model 2) mesh through ``launch.mesh.spawn``
with the gloo backend twice: once moving CUDA tensors through gloo
itself, once through the device mailboxes (``transport="cuda_ipc"``).
Each rank times ``core.shard_map``'s all-gather of a 138 MiB bf16 shard
over ``"data"`` (an expert weight's half), an all-to-all of 64 MiB over
``"model"`` and an all-reduce of 4 MiB, three calls each after a warm-up,
the device synchronised around them, and reports the bytes received or
sent a rank per second. Prints the card's name and power limit first.
``--device cpu`` runs the gloo half on CPU ranks (no card needed).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _timed(fn, x, calls: int = 3) -> float:
    import torch
    fn(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def rank_main(device: str) -> dict:
    import torch
    from repro_torch.core import shard_map as sm
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_local_mesh(2, 2, device_type=device)
    dev = mesh_mod.local_device()
    out = {}
    shard = torch.ones(138 * 2 ** 20 // 2, dtype=torch.bfloat16, device=dev)
    t = _timed(lambda x: sm._all_gather(x, 0, mesh, "data"), shard)
    out["all_gather_data_138MiB_s"] = t
    out["all_gather_GB_per_s"] = shard.numel() * 2 / t / 1e9
    buf = torch.ones(64 * 2 ** 20 // 2, dtype=torch.bfloat16, device=dev)
    t = _timed(lambda x: sm._exchange(x, mesh, "model"), buf)
    out["all_to_all_model_64MiB_s"] = t
    out["all_to_all_GB_per_s"] = buf.numel() * 2 / 2 / t / 1e9
    small = torch.ones(2 ** 20, dtype=torch.float32, device=dev)
    t = _timed(lambda x: sm.all_reduce(x, mesh, "data"), small)
    out["all_reduce_data_4MiB_s"] = t
    out["mailboxes"] = sm.mailboxes_open()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    from repro_torch.launch import mesh as mesh_mod
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    transports = [None, "cuda_ipc"] if args.device == "cuda" else [None]
    for transport in transports:
        res = mesh_mod.spawn(rank_main, 4, args.device, backend="gloo",
                             device=args.device, transport=transport,
                             timeout=600)
        print(json.dumps({"transport": transport or "gloo",
                          "device": args.device, "ranks": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
