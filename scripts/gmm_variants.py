#!/usr/bin/env python3
"""Check and time variants of the tensor-core grouped matmul on one GPU.

    python3 scripts/gmm_variants.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds ``src/repro_torch/csrc/moe_gmm_wgmma.cu`` as it is and
a few variants made by editing its text (one ``nvcc`` each, all at once,
into ``build/gmm_variants/``), prints ptxas' report for each and the
HGMMA count of the one as it is, then holds every variant against the
float32 einsum of the same bf16 inputs (within one bf16 rounding plus
1e-5 of the summed terms' size, the bound of ``chip_smoke.check_gmm``,
with the largest error of each 64-column half of the 128-column tiles)
at DeepSeekMoE-16B's two serving shapes and ragged ones, and times them
with CUDA events at the serving shapes, in turns (all variants, then all
again in reverse order), beside the ``mma.sync`` kernel
(``csrc/moe_gmm.cu``) and ``torch.bmm`` (whose device kernels it names):

- ``as_is``: one block per SM walking the tiles, a 4-stage ring, tiles
  256 columns wide and clusters of two CTAs that share their B boxes by
  multicast, at both serving shapes;
- ``no_pair``: no clusters, every CTA loads its own B boxes;
- ``tile_128``: tiles 128 columns wide at every shape;
- ``wait_hint``: the mbarrier waits with a suspend-time hint, so waiting
  warps sleep instead of polling;
- ``m_fastest``: the tiles walked with rows fastest instead of columns;
- ``one_per_tile``: one block (one cluster) per tile (pair of tiles)
  instead of one per SM;
- ``ring_3``: 3 ring stages (5 of 48 KB no longer fit beside 256-wide
  tiles);
- ``wait_0``: each slab's products waited for before the next slab is
  issued (``wgmma.wait_group 0``), as the flash kernel does: what keeping
  one group in flight is worth.

(Two resident blocks an SM do not build: two 384-thread blocks leave 80
registers a thread, and ptxas needs 90 for an m64n128k16 ``wgmma``.)

Then it reads the SM clock and power draw (``nvidia-smi``) while
``as_is`` and ``torch.bmm`` each run back to back at the gate/up shape.
Prints the card's name and power limit, then one JSON line per variant.
"""
from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "moe_gmm_wgmma.cu"
OUT = ROOT / "build" / "gmm_variants"
# (E, C, D, F): shapes ragged in C, D and F on 128- and 256-wide tiles,
# and DeepSeekMoE-16B's gate/up and down at the serving capacity.
SHAPES = {"ragged": (3, 200, 200, 136), "ragged_wide": (2, 200, 200, 1000),
          "ragged_odd": (2, 840, 136, 264),
          "gate_up": (64, 1920, 2048, 1408),
          "down": (64, 1920, 1408, 2048)}
TIMED = ("gate_up", "down")
BF16_ROUND, F32_TOL = 2.0 ** -8, 1e-5
STAGES = "constexpr int kStages = 4;"


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"gmm_variants.py: the kernel no longer holds "
                         f"{old[:60]!r}; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, str]:
    src = SOURCE.read_text()
    return {"as_is": src,
            "ring_3": edit(src, STAGES, STAGES.replace("4", "3")),
            "wait_0": edit(src, "wgmma_wait<1>();", "wgmma_wait<0>();"),
            "tile_128": edit(src, "return 8 * (covered - f) <= covered;",
                             "return false;"),
            "wait_hint": edit(src, "b64 p, [%1], %2;", "b64 p, [%1], %2, "
                              "1000000;"),
            "m_fastest": edit(edit(src, "(MC * (r / n_tiles) + rank)",
                                   "(MC * (r % m_steps) + rank)"),
                              "(r % n_tiles) * BN;", "(r / m_steps) * BN;"),
            "no_pair": edit(src, "return tiles >= 2 && 8 * (tiles % 2) <= "
                            "tiles + 1;", "return false;"),
            "one_per_tile": edit(src, "clusters = steps < blocks / MC ? "
                                 "steps : blocks / MC;", "clusters = steps;")}


def build(texts: dict[str, str]) -> dict[str, list[str]]:
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kbuild.cuda_tool("nvcc"), *kbuild.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"gmm_variants.py: {name} failed to build:\n"
                             f"{log}")
        reports[name] = [ln.strip() for ln in log.splitlines()
                         if "Used" in ln or "spill" in ln]
    return reports


def load(name: str):
    fn = ctypes.CDLL(str(OUT / f"{name}.so")).repro_gmm_wgmma
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p] + [ctypes.c_int] * 4 + [p]
    fn.restype = ctypes.c_int
    return fn


def finish_within(seconds: float, what: str) -> None:
    """Waits for the card's queued work; a kernel still running after
    ``seconds`` (a ring that never fills) ends the process."""
    import torch
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"gmm_variants.py: {what} still running after {seconds} s",
                  flush=True)
            os._exit(3)
        time.sleep(0.01)


def under_load(fn, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    while ``fn`` runs back to back for ``seconds``."""
    import threading
    import torch
    readings, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split(",")
            readings.append((float(out[0]), float(out[1])))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    clocks, watts = sorted(r[0] for r in readings), sorted(r[1] for r in
                                                            readings)
    return {"sm_clock_mhz": clocks[len(clocks) // 2],
            "power_w": watts[len(watts) // 2], "samples": len(readings)}


def time_ms(fn, iters: int = 10) -> float:
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("gmm_variants.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import moe_gmm as mg
    texts = variants()
    reports = build(texts)
    tool = kbuild.cuda_tool("cuobjdump")
    hgmma = None if tool is None else subprocess.run(
        [tool, "-sass", str(OUT / "as_is.so")], capture_output=True,
        text=True, check=True).stdout.count("HGMMA")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"as_is_hgmma_instructions": hgmma}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for case, (e, c, d, f) in SHAPES.items():
        x = torch.randn((e, c, d), dtype=torch.bfloat16, device="cuda",
                        generator=gen)
        w = (torch.randn((e, d, f), device="cuda", generator=gen)
             / d ** 0.5).to(torch.bfloat16)
        want = mg.gmm_plain(x.float(), w.float())
        size = mg.gmm_plain(x.float().abs(), w.float().abs())
        data[case] = (x, w, want, size)
    fns = {name: load(name) for name in texts}
    results = {name: {"ptxas": reports[name]} for name in texts}

    def call(name, x, w, y):
        e, c, d = x.shape
        rc = fns[name](x.data_ptr(), w.data_ptr(), y.data_ptr(), e, c, d,
                       w.shape[2], torch.cuda.current_stream().cuda_stream)
        kbuild.check(rc, f"gmm variant {name}")

    for name in texts:
        for case, (x, w, want, size) in data.items():
            y = torch.empty(want.shape, dtype=torch.bfloat16, device="cuda")
            call(name, x, w, y)
            finish_within(20.0, f"{name} at {case}")
            over = (y.float() - want).abs() - BF16_ROUND * want.abs() \
                - F32_TOL * size
            right = torch.arange(want.shape[2], device="cuda") % 128 >= 64
            results[name][f"{case}_excess_cols_0_63"] = float(
                over[..., ~right].max())
            results[name][f"{case}_excess_cols_64_127"] = float(
                over[..., right].max()) if right.any() else None
    for name in [*texts, *reversed(texts)]:
        for case in TIMED:
            x, w, want, _ = data[case]
            y = torch.empty(want.shape, dtype=torch.bfloat16, device="cuda")
            results[name].setdefault(f"{case}_ms", []).append(
                time_ms(lambda: call(name, x, w, y)))
    for case in TIMED:
        x, w, want, _ = data[case]
        e, c, d = x.shape
        flops = 2.0 * e * c * d * w.shape[2]
        for name, row in results.items():
            row[f"{case}_tflops_per_s"] = flops / min(row[f"{case}_ms"]) / 1e9
        with_route = mg._route
        try:
            mg._route = lambda *a: "mma"
            mma = [time_ms(lambda: mg.gmm(x, w)) for _ in range(2)]
        finally:
            mg._route = with_route
        bmm = [time_ms(lambda: torch.bmm(x, w)) for _ in range(2)]
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.bmm(x, w)
            torch.cuda.synchronize()
        names = sorted({evt.key for evt in prof.key_averages()})
        print(json.dumps({"case": case, "shape": list(SHAPES[case]),
                          "mma_route_ms": mma, "torch_bmm_ms": bmm,
                          "torch_bmm_kernels": names,
                          "bound_ms": flops / 989e12 * 1e3}))
    x, w, want, _ = data["gate_up"]
    y = torch.empty(want.shape, dtype=torch.bfloat16, device="cuda")
    print(json.dumps({"case": "gate_up", "under_load": {
        "as_is": under_load(lambda: call("as_is", x, w, y)),
        "torch_bmm": under_load(lambda: torch.bmm(x, w))}}))
    for name, row in results.items():
        print(json.dumps({"variant": name, **row}))
    bad = sorted(name for name, row in results.items()
                 if any(v is not None and v > 0 for k, v in row.items()
                        if "excess" in k))
    if bad:
        print(f"gmm_variants.py: beyond the bound: {bad}", file=sys.stderr)
    return 1 if "as_is" in bad else 0


if __name__ == "__main__":
    sys.exit(main())
