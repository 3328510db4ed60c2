#!/usr/bin/env python3
"""Check and time the mma.sync flash-attention kernel on one GPU.

    python3 scripts/flash_mma_check.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. Every call names the mma.sync route (``_flash_cuda(...,
route="mma")``), which bf16 takes by itself only at head dims that are no
multiple of 16 (the others take the wgmma kernel, checked by
``scripts/flash_tc_check.py``). It builds
``src/repro_torch/csrc/flash_attention_mma.cu`` as it is and two
variants made by editing its text (one ``nvcc`` each, all at once, into
``build/flash_mma_variants/``) and prints, per library, ptxas' registers
and spills of each head-dim instance (DP). Then, with the kernel as it
is:

- bf16 q, k, v at head dims 6 to 255 (every padded width, GQA and MHA,
  causal, windowed and full, Sq != Skv, D = 37 with its one-element
  copies, and views of one qkv tensor), each against the plain version
  within ``chip_smoke.BF16_TOL`` and against float32 attention within one
  bf16 rounding plus 1e-4 (``chip_smoke.check_flash_f32``);
- at StableLM-3B's prefill shape, q, k, v (4, 4096, 32, 80) bf16 causal:
  the kernel, the CUDA-core kernel on the same inputs (the route it
  replaced), ``scaled_dot_product_attention`` and the plain version, in
  turns, five CUDA-event batches each, beside the bound (the wgmma
  route's time there: ``scripts/flash_tc_check.py``);
- the variants at the same shape, in turns (all, then all in reverse):
  ``four_blocks`` (``__launch_bounds__`` asking four blocks an SM up to
  DP = 96: whether occupancy holds the kernel back) and ``no_lo_half`` (P
  V with the hi half of P alone: what the P split costs; its error is
  printed, it need not pass).

Prints the card's name and power limit and one JSON line per result;
exits 1 if a check fails or an instance of the kernel as it is spills.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_mma.cu"
OUT = ROOT / "build" / "flash_mma_variants"
LAUNCH = "__global__ void __launch_bounds__(kThreads)\n" \
    "flash_attention_mma_kernel"
VARIANTS = {
    "as_is": [],
    "four_blocks": [(LAUNCH, "__global__ void __launch_bounds__(kThreads, "
                     "DP <= 96 ? 4 : 1)\nflash_attention_mma_kernel")],
    "no_lo_half": [
        ("          mma_bf16(acc[2 * n2], plo, bv[0], bv[1]);\n", ""),
        ("          mma_bf16(acc[2 * n2 + 1], plo, bv[2], bv[3]);\n", "")],
}
# (B, Sq, Skv, H, Hkv, D, causal, window)
CASES = [(4, 4096, 4096, 32, 32, 80, True, 0),
         (1, 4096, 4096, 8, 2, 6, True, 0),
         (1, 4096, 4096, 8, 2, 36, True, 1024),
         (1, 300, 300, 4, 2, 16, True, 0), (2, 333, 340, 6, 3, 96, False, 100),
         (1, 517, 517, 4, 1, 112, True, 64), (1, 200, 200, 4, 4, 160, True, 0),
         (2, 333, 301, 4, 2, 193, True, 0), (2, 333, 301, 4, 2, 200, False, 17),
         (2, 333, 301, 4, 2, 240, True, 64), (1, 257, 257, 4, 2, 250, True, 0),
         (2, 333, 301, 4, 2, 255, False, 0), (1, 130, 130, 4, 2, 37, True, 0),
         (2, 64, 71, 2, 1, 80, False, 0), (1, 1, 1, 4, 2, 80, True, 0)]
STABLELM = (4, 4096, 32, 80)


def out(**fields) -> None:
    print(json.dumps(fields), flush=True)


def build() -> dict:
    """Every variant's library path, built all at once; ptxas' report."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: its edit no longer "
                                 "matches the source")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [kbuild.cuda_tool("nvcc"), *kbuild.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spilled = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        per_dp, dp = {}, None
        for ln in log.splitlines():
            m = re.search(r"mma_kernelILi(\d+)E", ln)
            if m and "Compiling" in ln:
                dp = int(m[1])
            elif dp is not None and "registers" in ln:
                per_dp.setdefault(dp, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", ln)[1])
            elif dp is not None and "spill" in ln:
                per_dp.setdefault(dp, {})["spilled_bytes"] = sum(
                    int(b) for b in re.findall(
                        r"(\d+) bytes spill (?:stores|loads)", ln))
        spilled[name] = sum(v.get("spilled_bytes", 0)
                            for v in per_dp.values())
        out(library=name, instances=per_dp)
    if spilled["as_is"]:
        raise SystemExit(f"ptxas spilled {spilled['as_is']} bytes")
    return {name: OUT / f"{name}.so" for name in VARIANTS}


def use(path) -> None:
    """Route the wrapper's mma launches to the library at ``path``."""
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(str(path))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.repro_flash_attention_mma
    fn.argtypes = [p] * 5 + [i32] * 8 + [ctypes.c_float, i32, p]
    fn.restype = ctypes.c_int
    fa._LIBS["mma"] = lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("flash_mma_check.py: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    use(libs["as_is"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device="cuda", generator=gen)
    failed = []
    for b, sq, skv, h, hkv, d, causal, window in CASES:
        q = torch.randn((b, sq, h, d), **bf)
        k, v = (torch.randn((b, skv, hkv, d), **bf) for _ in range(2))
        n0 = fa.FLASH_ATTENTION_MMA_LAUNCHES
        got = fa._flash_cuda(q, k, v, causal, window, route="mma")
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        case = [b, sq, skv, h, hkv, d, causal, window]
        try:
            if fa.FLASH_ATTENTION_MMA_LAUNCHES != n0 + 1:
                raise AssertionError("not the mma route")
            err = cs.within(got, want, cs.BF16_TOL)
            out(case=case, max_abs_err=err,
                **cs.check_flash_f32(q, k, v, got, causal, window))
        except AssertionError as e:
            failed.append(case)
            out(case=case, failed=str(e)[:400])
    qkv = torch.randn((2, 300, 3, 8, 80), **bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = fa._flash_cuda(q, k, v, True, 0, route="mma")
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    out(case="qkv_views", copy_bytes=fa._copy_bytes(80, (q, k, v)),
        max_abs_err=cs.within(got, want, cs.BF16_TOL))

    b, s, h, d = STABLELM
    q, k, v = (torch.randn((b, s, h, d), **bf) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    funcs = {
        "mma": lambda: fa._flash_cuda(q, k, v, True, 0, route="mma"),
        "cuda_core": lambda: fa._flash_cuda(q, k, v, True, 0, route="fma"),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
        "plain": lambda: fa.flash_attention_plain(q, k, v, causal=True)}
    times = {n: [] for n in funcs}
    for order in (list(funcs), list(reversed(funcs))):
        for name in order:
            times[name] += cs.time_spread(funcs[name])
    flops = 4.0 * b * h * d * cs.band_pairs(s, s, True, 0)
    out(shape=list(STABLELM), causal=True,
        bound_ms=flops / cs.BF16_FLOPS_PER_S * 1e3, bound_by="operations",
        ms={n: sorted(t) for n, t in times.items()})

    want = funcs["plain"]()
    times = {n: [] for n in VARIANTS}
    for order in (list(VARIANTS), list(reversed(VARIANTS))):
        for name in order:
            use(libs[name])
            got = funcs["mma"]()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            times[name] += cs.time_spread(funcs["mma"])
            out(variant=name, max_abs_err=err)
    out(shape=list(STABLELM), variants_ms={n: sorted(t)
                                           for n, t in times.items()})
    use(libs["as_is"])
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
