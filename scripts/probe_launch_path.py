#!/usr/bin/env python3
"""Time the probe wrappers of two checkouts on one GPU, in turns.

    python3 scripts/probe_launch_path.py OTHER_CHECKOUT

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It runs one process per turn, this checkout, OTHER_CHECKOUT,
OTHER_CHECKOUT, this checkout, each importing ``repro_torch`` from its own
``src/`` (and building its own ``csrc/hash_join.cu``). Each makes, from a
numpy seed, inputs at the query path's shapes (the probe: 5,265 keys, all
present, into 187,500 sorted distinct keys; the range probe: 187,500 keys
into 5,059 sorted keys with duplicates), prepares each build side once as
the engine does (``probe_table`` where the checkout has it, else
``prepare_buckets`` with the starts copied to the card), checks that the
wrappers' results equal their plain versions', and times with CUDA events
(median of five batches of 20 calls after warm-up) each wrapper call, and
``torch.searchsorted`` on the same inputs (two calls for the range
probe). Then, in one more process of this checkout, it times on the host
(``perf_counter`` around 500 calls of each, nothing synchronised inside)
each step of ``sorted_probe``'s launch path, the whole wrapper call, the
steps the launch path no longer takes (``was_*``: the starts copied to
the device, the scalars through numpy, a device context, a uint8 match
viewed as bool) and forms it does not take (``alt_*``). Prints the card's
name and power limit, then one JSON line per turn and one for the steps.

``--device cpu`` runs the turns on the CPU (plain versions, host clock,
no host steps), to rehearse them; its times are no device times.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0


def inputs(np):
    rng = np.random.default_rng(SEED)
    build = np.sort(rng.choice(6_000_000, 187_500, replace=False)
                    ).astype(np.int32)
    keys = rng.choice(build, 5_265).astype(np.int32)
    dup_build = np.sort(rng.choice(build[:20_000], 5_059)).astype(np.int32)
    dup_keys = np.concatenate([rng.choice(dup_build, 5_002),
                               rng.integers(0, 6_000_000, 182_498)]
                              ).astype(np.int32)
    return (build, keys), (dup_build, dup_keys)


def time_ms(fn, device: str) -> float:
    import torch
    for _ in range(3):
        fn()
    per = []
    for _ in range(5):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            per.append(start.elapsed_time(end) / 20)
        else:
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            per.append((time.perf_counter() - t0) / 20 * 1e3)
    return sorted(per)[2]


def worker(tree: pathlib.Path, device: str) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import hash_join as hj
    out = {"tree": str(tree), "prepared": "probe_table"
           if hasattr(hj, "probe_table") else "prepare_buckets"}
    for kind, (b, k) in zip(("probe", "probe_range"), inputs(np)):
        build = torch.from_numpy(b).to(device)
        keys = torch.from_numpy(k).to(device)
        if hasattr(hj, "probe_table"):
            kw = {"table": hj.probe_table(b, device)}
            scalars, starts = (kw["table"].bias, kw["table"].shift), \
                kw["table"].starts
        else:
            scalars, starts_np = hj.prepare_buckets(b)
            starts = torch.from_numpy(starts_np).to(device)
            kw = {"scalars": scalars, "starts": starts}
        if kind == "probe":
            call = lambda: hj.sorted_probe(build, keys, **kw)  # noqa: E731
            plain = hj.sorted_probe_plain(build, keys, scalars, starts)
            lib = lambda: torch.searchsorted(build, keys)  # noqa: E731
        else:
            call = lambda: hj.sorted_probe_range(build, keys, **kw)  # noqa: E731
            plain = hj.sorted_probe_range_plain(build, keys, scalars, starts)
            lib = lambda: (torch.searchsorted(build, keys),  # noqa: E731
                           torch.searchsorted(build, keys, right=True))
        if not all(torch.equal(g, w) for g, w in zip(call(), plain)):
            raise SystemExit(f"probe_launch_path.py: {kind} differs from "
                             f"its plain version in {tree}")
        out[f"{kind}_ms"] = time_ms(call, device)
        out[f"{kind}_searchsorted_ms"] = time_ms(lib, device)
        out[f"{kind}_n"], out[f"{kind}_build"] = len(k), len(b)
    return out


def host_steps(tree: pathlib.Path, reps: int = 500) -> dict:
    """Host microseconds per call of each step of this checkout's
    ``sorted_probe`` launch path at the probe's inputs (see the module
    docstring)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import hash_join as hj
    (b, k), _ = inputs(np)
    build, keys = torch.from_numpy(b).cuda(), torch.from_numpy(k).cuda()
    table = hj.probe_table(b, "cuda")
    n, s, dev = len(k), len(b), table.device_index
    probe = hj._fns()[0]
    pos = torch.empty(n, dtype=torch.int32, device=keys.device)
    match = torch.empty(n, dtype=torch.bool, device=keys.device)
    match_u8 = match.view(torch.uint8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (table.starts.data_ptr(), build.data_ptr(), keys.data_ptr(),
            pos.data_ptr(), match.data_ptr())
    scalars = np.asarray([table.bias, table.shift], np.int32)

    def device_context():
        with torch.cuda.device(keys.device):
            pass

    def one_empty():
        buf = torch.empty(n + (n + 3) // 4, dtype=torch.int32,
                          device=keys.device)
        return buf[:n], buf[n:].view(torch.bool)[:n]
    steps = {
        "checks": lambda: hj._resolve(build, keys, table),
        "outputs": lambda: (torch.empty_like(keys),
                            torch.empty_like(keys, dtype=torch.bool)),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptrs": lambda: (table.starts.data_ptr(), build.data_ptr(),
                              keys.data_ptr(), pos.data_ptr(),
                              match.data_ptr()),
        "ctypes_launch": lambda: probe(*ptrs, n, s, table.bias, table.shift,
                                       dev, stream),
        "whole_call": lambda: hj.sorted_probe(build, keys, table=table),
        "was_as_tensor_starts": lambda: torch.as_tensor(
            table.starts, dtype=torch.int32, device=keys.device),
        "was_np_asarray_scalars": lambda: (np.asarray(scalars),
                                           int(scalars[0]), int(scalars[1])),
        "was_device_context": device_context,
        "was_view_bool": lambda: match_u8.view(torch.bool),
        "alt_outputs_sized": lambda: (
            torch.empty(n, dtype=torch.int32, device=keys.device),
            torch.empty(n, dtype=torch.bool, device=keys.device)),
        "alt_one_empty_two_views": one_empty,
    }
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw_stream is not None:
        steps["alt_raw_stream"] = lambda: raw_stream(dev)
    out = {}
    for name, fn in steps.items():
        for _ in range(20):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[f"{name}_us"] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return {"tree": str(tree), "n": n, "build": s, "reps": reps, **out}


def main(argv) -> int:
    device = "cpu" if "--device" in argv and \
        argv[argv.index("--device") + 1] == "cpu" else "cuda"
    if "--worker" in argv:
        print(json.dumps(worker(pathlib.Path(argv[argv.index("--worker")
                                                 + 1]), device)))
        return 0
    if "--steps" in argv:
        print(json.dumps(host_steps(ROOT)))
        return 0
    others = [a for a in argv if not a.startswith("--") and a != device]
    if len(others) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("probe_launch_path.py: no CUDA device available",
                  file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    other = pathlib.Path(others[0]).resolve()
    runs = [["--worker", str(tree), "--device", device]
            for tree in (ROOT, other, other, ROOT)]
    if device == "cuda":
        runs.append(["--steps"])
    for args in runs:
        proc = subprocess.run([sys.executable, __file__, *args],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
