#!/usr/bin/env python3
"""Time the probe wrappers of two checkouts on one GPU, in turns.

    python3 scripts/probe_launch_path.py OTHER_CHECKOUT [--rounds R]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It runs one process per turn, in R rounds (1 by default) of
this checkout, OTHER_CHECKOUT, OTHER_CHECKOUT, this checkout, each
importing ``repro_torch`` from its own
``src/`` (and building its own ``csrc/hash_join.cu``). Each makes, from a
numpy seed, inputs at the query path's shapes (the probe: 5,265 keys, all
present, into 187,500 sorted distinct keys; the range probe: 187,500 keys
into 5,059 sorted keys with duplicates), prepares each build side once as
the engine does (``probe_table``, passing the table's own build keys
where its table holds them, else ``prepare_buckets`` with the starts
copied to the card), checks that the wrappers' results equal their plain
versions', and times each wrapper call with CUDA events (median of five
batches of 20 calls after warm-up) beside ``torch.searchsorted`` on the
same inputs (two calls for the range probe); on the card also the host
µs a call (``perf_counter`` over 500 calls, one wait at the end) and the
device µs a call (``torch.profiler`` over 200 calls), with
``chip_smoke.host_device_us``. Then, in one more process of this
checkout, it times on the host (``perf_counter`` around 500 calls of
each, nothing synchronised inside; five rounds, the median and fastest
kept) each step of the probes' launch path (the checks, an output tensor
each by ``new_empty``, the raw stream, the pointers, the ctypes call and
launch, the whole wrapper call) and forms it does not take (``alt_*``:
one buffer viewed as the outputs, the outputs by ``torch.empty`` or
``empty_like``, the public stream getter). Prints the card's name and
power limit, then one JSON line per turn and one for the steps.

``--device cpu`` runs the turns on the CPU (plain versions, host clock,
no host or device split, no steps), to rehearse them; its times are no
device times.
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
            # A table that holds its build keys is called with them.
            build = getattr(kw["table"], "build", None)
            build = torch.from_numpy(b).to(device) if build is None \
                else build
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
        if device == "cuda":
            sys.path.insert(0, str(ROOT))
            from chip_smoke import host_device_us
            for name, fn in ((kind, call), (f"{kind}_searchsorted", lib)):
                split = host_device_us(fn)
                out[f"{name}_host_us"] = split["host_us_per_call"]
                out[f"{name}_device_us"] = sum(
                    split["device_us_per_call"].values())
                out[f"{name}_device_us_by_kernel"] = \
                    split["device_us_per_call"]
    return out


def host_steps(tree: pathlib.Path, reps: int = 500, rounds: int = 5) -> dict:
    """Host microseconds per call of each step of this checkout's probe
    launch path at the probes' inputs (see the module docstring)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import hash_join as hj
    (b, k), (rb, rk) = inputs(np)
    table, rtable = hj.probe_table(b, "cuda"), hj.probe_table(rb, "cuda")
    build, keys = table.build, torch.from_numpy(k).cuda()
    rbuild, rkeys = rtable.build, torch.from_numpy(rk).cuda()
    n, s, dev = len(k), len(b), table.device_index
    fn = hj._fns()[False]
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    match = torch.empty(n, dtype=torch.bool, device=dev)
    stream = hj._STREAM(dev)
    ptrs = (keys.data_ptr(), pos.data_ptr(), match.data_ptr())

    def checks():
        hj._checked(build, keys, table)
        hj._cuda_checked(keys, n, table)

    def one_buffer(m, ints):
        out = torch.empty((4 * ints + 1) * m, dtype=torch.uint8, device=dev)
        *parts, flags = out.split_with_sizes((4 * m,) * ints + (m,))
        return [x.view(torch.int32) for x in parts] + [flags.view(torch.bool)]
    m = len(rk)
    steps = {
        "checks": checks,
        "outputs": lambda: (keys.new_empty(n),
                            keys.new_empty(n, dtype=torch.bool)),
        "raw_stream": lambda: hj._STREAM(dev),
        "data_ptrs": lambda: (keys.data_ptr(), pos.data_ptr(),
                              match.data_ptr()),
        "ctypes_launch": lambda: fn(table.args_ptr, *ptrs, n, stream),
        "whole_call": lambda: hj.sorted_probe(build, keys, table=table),
        "range_outputs": lambda: (rkeys.new_empty(m), rkeys.new_empty(m),
                                  rkeys.new_empty(m, dtype=torch.bool)),
        "range_whole_call": lambda: hj.sorted_probe_range(
            rbuild, rkeys, table=rtable),
        "alt_outputs_one_buffer": lambda: one_buffer(n, 1),
        "alt_outputs_empty": lambda: (
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev)),
        "alt_outputs_empty_like": lambda: (
            torch.empty_like(keys), torch.empty_like(keys, dtype=torch.bool)),
        "alt_range_outputs_one_buffer": lambda: one_buffer(m, 2),
        "alt_public_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
    }
    # Rounds over every step in turn: the host's noise moves whole
    # rounds, so each step reports its median and fastest round.
    per = {name: [] for name in steps}
    for _ in range(rounds):
        for name, step in steps.items():
            for _ in range(20):
                step()
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            per[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    out = {}
    for name, us in per.items():
        us.sort()
        out[f"{name}_us"] = us[len(us) // 2]
        out[f"{name}_us_min"] = us[0]
    return {"tree": str(tree), "n": n, "build": s, "range_n": len(rk),
            "range_build": len(rb), "reps": reps, "rounds": rounds, **out}


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
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv \
        else 1
    others = [a for i, a in enumerate(argv) if not a.startswith("--")
              and argv[i - 1] not in ("--device", "--rounds")]
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
            for _ in range(rounds) for tree in (ROOT, other, other, ROOT)]
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
