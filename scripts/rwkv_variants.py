#!/usr/bin/env python3
"""Check and time variants of the tensor-core RWKV-6 scan on one GPU.

    python3 scripts/rwkv_variants.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds ``src/repro_torch/csrc/rwkv6_scan_tc.cu`` as it is and
variants made by editing its text (one ``nvcc`` each, all at once, into
``build/rwkv_variants/``), prints ptxas' report for each, then runs them
at RWKV-6 1.6B's prefill shape (r/k/v (4, 4096, 32, 64) bf16, log_w
float32 from the model's decay form) on the same seeded inputs:

- ``as_is``: the kernel as it is, and ``phases``: the same with
  ``clock64`` read at each barrier by one thread of block 0, which prints
  the cycles a chunk spends in each phase (waiting for the chunk's copies,
  P1 the decay products, P2 the sub-chunk scores, P3 the chunk products
  and the state, the state's store);
- variants that keep the result: ``fast_exp`` (``__expf`` for the
  per-step decays);
- knock-outs that drop one phase's work and so change the result (timed
  only, to read what that work costs): ``no_diag`` (the exact scores
  within half sub-chunks, CUDA cores), ``no_offdiag`` (the sub-chunk pair
  products), ``no_inter`` (the chunk's products with the state),
  ``unsplit`` (one bf16 product in place of three, or of two with v).

Every variant that keeps the result is held against the plain version
(``rwkv6_scan_plain``) within ``chip_smoke.BF16_TOL`` plus
``RWKV_TOL`` of the summed terms' size (``chip_smoke.within_scan``). All
are timed with CUDA events in turns (all variants, then all again in
reverse order), beside the one-step-at-a-time kernel
(``csrc/rwkv6_scan.cu``). Prints the card's name and power limit, then one
JSON line per variant.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "rwkv6_scan_tc.cu"
OUT = ROOT / "build" / "rwkv_variants"
SHAPE = (4, 4096, 32, 64)      # (B, S, H, K = V): RWKV-6 1.6B's prefill
PHASES = ("wait", "p1", "p2", "p3", "store")
KEEPS_RESULT = ("as_is", "phases", "fast_exp")


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"rwkv_variants.py: the kernel no longer holds "
                         f"{old[:60]!r}; update the variant")
    return text.replace(old, new)


def phases(src: str) -> str:
    """``clock64`` at each barrier of the chunk loop, summed by thread 0
    of block 0 into a device array that ``rwkv_tc_phases`` copies out."""
    src = edit(src, "namespace {\n", "__device__ unsigned long long "
               "g_phase[5];\nnamespace {\n")
    src = edit(src, "    cp_async_commit();\n    cp_async_wait<1>();\n"
               "    __syncthreads();\n",
               "    cp_async_commit();\n    const long long c0 = clock64();\n"
               "    cp_async_wait<1>();\n    __syncthreads();\n"
               "    const long long c1 = clock64();\n")
    src = edit(src, "    __syncthreads();\n\n    // P2a",
               "    __syncthreads();\n    const long long c2 = clock64();\n"
               "\n    // P2a")
    src = edit(src, "    __syncthreads();\n\n    // P3",
               "    __syncthreads();\n    const long long c3 = clock64();\n"
               "\n    // P3")
    src = edit(src, "    __syncthreads();   // every read",
               "    __syncthreads();\n    const long long c4 = clock64();"
               "   // every read")
    src = edit(src, "  }\n  cp_async_wait<0>();",
               "    const long long c5 = clock64();\n"
               "    if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
               "      g_phase[0] += c1 - c0; g_phase[1] += c2 - c1;\n"
               "      g_phase[2] += c3 - c2; g_phase[3] += c4 - c3;\n"
               "      g_phase[4] += c5 - c4;\n    }\n"
               "  }\n  cp_async_wait<0>();")
    return src + (
        "\nextern \"C\" int rwkv_tc_phases(unsigned long long* out, "
        "int reset) {\n  if (reset) {\n    unsigned long long z[5] = {};\n"
        "    return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, "
        "sizeof(z)));\n  }\n  return static_cast<int>(cudaMemcpyFromSymbol("
        "out, g_phase, sizeof(g_phase)));\n}\n")


def variants() -> dict[str, str]:
    src = SOURCE.read_text()
    return {
        "as_is": src,
        "phases": phases(src),
        "fast_exp": edit(src, "w[j] = expf(*p);", "w[j] = __expf(*p);"),
        "no_diag": edit(src, "for (int i = 0; i < kH - 1; ++i) {\n"
                        "        if (i == jj) {",
                        "for (int i = 0; i < 0; ++i) {\n"
                        "        if (i == jj) {"),
        "no_offdiag": edit(src, "          float2 g01 = make_float2(1.f, 1.f), "
                           "g89 = g01;\n",
                           "          if (kk >= 0) continue;\n"
                           "          float2 g01 = make_float2(1.f, 1.f), "
                           "g89 = g01;\n"),
        "no_inter": edit(src, "            mma16x3(oc[nt], occ[nt], rh, rl, sh0, "
                         "sh1, sl0, sl1);\n", ""),
        "unsplit": edit(edit(edit(src, "  mma16(dc, al, bh0, bh1);\n"
                                  "  mma16(dc, ah, bl0, bl1);\n", ""),
                             "            mma16(sc[nt], kl, vb0, vb1);\n", ""),
                        "              mma16(occ[nt], al, vb0, vb1);\n", ""),
    }


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
            raise SystemExit(f"rwkv_variants.py: {name} failed to build:\n"
                             f"{log}")
        reports[name] = [ln.strip() for ln in log.splitlines()
                         if "Used" in ln or "spill" in ln]
    return reports


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("rwkv_variants.py: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import rwkv6_scan as rs
    texts = variants()
    reports = build(texts)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)

    b, s, h, kd = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = dict(dtype=torch.float32, device="cuda", generator=gen)
    r, k, v = (torch.randn(SHAPE, **f32).bfloat16() for _ in range(3))
    lw = -torch.exp(torch.randn(SHAPE, **f32) - 2.0)
    u = torch.randn((h, kd), **f32) * 0.3
    s0 = torch.randn((b, h, kd, kd), **f32) * 0.1
    want_o, want_s = rs.rwkv6_scan_plain(r, k, v, lw, u, s0)
    _, _, o_mag, s_mag = cs.rwkv6_truth(r, k, v, lw, u, s0)

    fns = {}
    for name in texts:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.repro_rwkv6_scan_tc
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (lib, fn)
    o = torch.empty_like(v)
    s_fin = torch.empty_like(s0)
    st = (ctypes.c_int64 * 15)(*[t.stride(i) for t in (r, k, v, lw, o)
                                 for i in range(3)])

    def runner(fn):
        def run():
            rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                    u.data_ptr(), s0.data_ptr(), o.data_ptr(),
                    s_fin.data_ptr(), st, b, h, s, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return run

    results = {name: {"ptxas": reports[name]} for name in texts}
    for name, (lib, fn) in fns.items():
        runner(fn)()
        torch.cuda.synchronize()
        if name in KEEPS_RESULT:
            results[name]["max_abs_err"] = max(
                cs.within_scan(o, want_o, o_mag, cs.BF16_TOL),
                cs.within_scan(s_fin, want_s, s_mag, 0.0))
    lib, fn = fns["phases"]
    lib.rwkv_tc_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cycles = (ctypes.c_ulonglong * 5)()
    lib.rwkv_tc_phases(None, 1)
    runner(fn)()
    torch.cuda.synchronize()
    if lib.rwkv_tc_phases(ctypes.addressof(cycles), 0):
        raise RuntimeError("reading the phase cycles failed")
    chunks = -(-s // 64)
    results["phases"]["cycles_per_chunk"] = {
        p: cycles[i] / chunks for i, p in enumerate(PHASES)}

    def seq():
        rs.rwkv6_scan(r, k, v, lw, u, s0)
    order = list(fns) + ["seq_route"]
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            if name == "seq_route":
                with cs.replaced(rs, "_route", lambda f: lambda *a: "seq"):
                    per = cs.time_spread(seq)
            else:
                per = cs.time_spread(runner(fns[name][1]))
            results.setdefault(name, {})[f"ms_turn{turn + 1}"] = \
                per[len(per) // 2]
    for name, row in results.items():
        print(json.dumps({"variant": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
