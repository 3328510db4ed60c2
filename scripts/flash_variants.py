#!/usr/bin/env python3
"""Time text variants of the tensor-core flash-attention kernel on one GPU.

    python3 scripts/flash_variants.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds ``src/repro_torch/csrc/flash_attention_wgmma.cu`` as it
is and a few variants made by editing its text (one ``nvcc`` each, all at
once, into ``build/flash_variants/``), then times every variant with CUDA
events at the three bf16 shapes of ``chip_smoke.py``'s flash checks
(RecurrentGemma-2B's serving shape, InternLM2-1.8B's and
MusicGen-medium's), in turns: all variants, then all again in reverse
order. Each variant asks one question about where the kernel's time goes;
only ``as_is`` must compute the right result, and every variant's excess
over one bf16 rounding of float32 attention is printed beside its times:

- ``no_lo``: P V with the hi half of P alone: what the P split costs;
- ``pingpong``: the two consumer warpgroups take turns issuing Q K^T
  (named barriers), so that one's softmax overlaps the other's products;
- ``ring_4`` and ``ring_deep``: 4, and 6 (D = 128) or 8 (D = 64), K/V ring
  stages below D = 256 instead of 3: whether loads wait on L2.

Prints the card's name and power limit, then one JSON line per variant.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_wgmma.cu"
OUT = ROOT / "build" / "flash_variants"
# (B, S, H, D), Hkv, window; all causal.
SHAPES = {"serve": ((4, 4096, 10, 256), 1, 2048),
          "internlm2": ((1, 4096, 16, 128), 8, 0),
          "musicgen": ((1, 4096, 24, 64), 24, 0)}
STAGES = "static constexpr int kStages = D == 256 ? 2 : 3;"


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_variants.py: the kernel no longer holds "
                         f"{old[:60]!r}; update the variant")
    return text.replace(old, new)


def pingpong(src: str) -> str:
    """Consumer warpgroup w waits on named barrier 1 + w before issuing
    Q K^T and then lets the other one go; the last arrival is left out so
    that every barrier ends balanced."""
    src = edit(src, "// 2^x (the hardware's approximation", (
        "__device__ __forceinline__ void named_sync(int id) {\n"
        "  asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(id) : \"memory\");\n"
        "}\n"
        "__device__ __forceinline__ void named_arrive(int id) {\n"
        "  asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(id) : \"memory\");\n"
        "}\n\n// 2^x (the hardware's approximation"))
    src = edit(src, "    if (n_tiles > 0) mbar_wait(q_full, 0);\n",
               "    if (n_tiles > 0) mbar_wait(q_full, 0);\n"
               "    if (n_tiles > 0 && cw == 1) named_arrive(1);\n")
    turn = ("named_sync(1 + cw);\n"
            "      if (!(cw == 1 && it == n_tiles - 1)) named_arrive(2 - cw);\n")
    src = edit(src, "      mbar_wait(k_full + 8 * s, parity);\n      if (!skip) {",
               "      mbar_wait(k_full + 8 * s, parity);\n"
               "      if (skip) {\n        " + turn + "      }\n"
               "      if (!skip) {")
    src = edit(src, "        float sc[32];\n        wgmma_fence();",
               "        float sc[32];\n        named_sync(1 + cw);\n"
               "        wgmma_fence();")
    return edit(src, "        wgmma_commit();\n        wgmma_wait_all();\n"
                     "        fence_acc(sc);",
                "        wgmma_commit();\n"
                "        if (!(cw == 1 && it == n_tiles - 1)) "
                "named_arrive(2 - cw);\n"
                "        wgmma_wait_all();\n        fence_acc(sc);")


def variants() -> dict[str, str]:
    src = SOURCE.read_text()
    return {
        "as_is": src,
        "no_lo": edit(src, "wgmma_rs(acc[c], plo[kk], dvk);", ""),
        "pingpong": pingpong(src),
        "ring_4": edit(src, STAGES, STAGES.replace(": 3;", ": 4;")),
        "ring_deep": edit(src, STAGES, STAGES.replace(
            ": 3;", ": (D == 128 ? 6 : 8);")),
    }


def build(texts: dict[str, str]) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kbuild.cuda_tool("nvcc"), *kbuild.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"flash_variants.py: {name} failed to build:\n"
                             f"{log}")


def use(name: str) -> None:
    """Make the flash wrapper's tensor-core route call variant ``name``."""
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    fn = lib.repro_flash_attention_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fa._LIBS["tc"] = lib


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
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
    import torch
    if not torch.cuda.is_available():
        print("flash_variants.py: no CUDA device available", file=sys.stderr)
        return 1
    texts = variants()
    build(texts)
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for case, ((b, s, h, d), hkv, window) in SHAPES.items():
        q, k, v = (torch.randn(shape, dtype=torch.bfloat16, device="cuda",
                               generator=gen)
                   for shape in ((b, s, h, d), (b, s, hkv, d),
                                 (b, s, hkv, d)))
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=True, window=window)
        data[case] = (q, k, v, window, want)
    results = {name: {} for name in texts}
    for name in [*texts, *reversed(texts)]:
        use(name)
        for case, (q, k, v, window, want) in data.items():
            run = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, causal=True, window=window)
            results[name].setdefault(f"{case}_ms", []).append(time_ms(run))
            got = run().float()
            results[name][f"{case}_excess"] = float(
                ((got - want).abs() - 2.0 ** -8 * want.abs()).max())
    for name, row in results.items():
        print(json.dumps({"variant": name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
