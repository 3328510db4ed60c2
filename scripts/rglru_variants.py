#!/usr/bin/env python3
"""Check and time variants of the TMA-fed RG-LRU scan on one GPU.

    python3 scripts/rglru_variants.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds ``src/repro_torch/csrc/rglru_scan_tma.cu`` as it is
and variants made by editing its text (and that of the one-thread-a-lane
kernel, ``csrc/rglru_scan.cu``), one ``nvcc`` each, all at once, into
``build/rglru_variants/``, prints ptxas' report for each, then runs them
at RecurrentGemma-2B's prefill shape, log_a and b (4, 4096, 2560)
float32, and at one batch row, (1, 4096, 2560), on the same seeded inputs
(log_a = -exp(N(0, 1)), as the model's gates give):

- ``as_is``: the kernel with ``_plan``'s launch (128-channel tiles at
  the serving shape, 64 at one batch row); ``stagesN``: 32-channel tiles
  with a ring of N stages (2, 3, 4, 6); ``lanesN``: tiles of N channels
  (16, 32, 64, 128) with the ring ``_plan`` would give that tile (16
  needs a text variant: a full warp for half a warp's lanes);
- ``phases``: the kernel with ``clock64`` read around each wait, by the
  first consumer lane and by the producer thread of every block; prints,
  averaged over the blocks, the cycles a block's consumer spends waiting
  for a full stage, copying it to registers, and folding it and storing
  its h, and the cycles its producer waits for an empty one. The reads
  change ptxas' schedule (compare its register count with ``as_is``'s);
- ``early_release``: the fold made to start after the warp's `empty`
  arrive, through a data dependence ptxas cannot move (h passes through a
  shuffle whose source lane adds the arrive's state times 32: a shuffle
  reads the low five bits, so each lane gets its own h back), so the
  stage is released before the fold; ``phases_early``: the same with
  ``phases``' clocks;
- ``smem_fold``: each step read from shared memory inside the fold, the
  stage released after it;
- ``direct_store``: each warp stores its h_t straight to h_all in place
  of the staging tiles and TMA stores; ``direct_relaxed``: the same with
  a relaxed `empty` arrive (a test of why direct stores are slow, not a
  sound kernel: the arrive then does not order the stage's reads before
  the refill);
- ``steps32``: stages of 32 steps, not 64, with ``_plan``'s tile and
  depth for them (more, smaller stages in the same shared memory);
- ``evict_first``: TMA loads and stores with an L2 evict-first cache
  hint (every byte is used once);
- ``l2_256``, ``l2_none``: the tensor maps' L2 promotion at 256 bytes
  or none, not 128;
- knock-outs that change the result (timed only, to read what that work
  costs): ``no_store`` (no TMA stores of h), ``no_exp`` (log_a used as
  the decay itself), ``no_fold`` (h = log_a + b, no chain);
- ``seq``: the one-thread-a-lane kernel as it is, and ``seq_db``: the
  same with the next 16 steps loaded into a second register set while it
  folds the current ones;
- ``stream_add``: ``torch.add(log_a, b, out=h_all)``, the same bytes
  less h0 and h_last streamed by PyTorch, a yardstick of the memory
  rate a plain elementwise pass reaches (not a kernel of the port).

Every variant that keeps the result is held against the plain version
(``rglru_scan_plain``) within ``chip_smoke.SCAN_TOL`` and reported
bit-equal or not; a variant that fails to build is reported and left
out. All are timed with CUDA events in turns (all variants, then all
again in reverse order), each first launch under a 20 s hang guard.
Prints the card's name and power limit, ptxas' report of each variant,
then one JSON line per variant and shape; writes the SASS of
``as_is`` to ``build/rglru_variants/as_is.sass`` where the toolkit has
``cuobjdump``.
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
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "rglru_variants"
SHAPES = {"serve": (4, 4096, 2560), "b1": (1, 4096, 2560)}
PHASES = ("wait_full", "copy", "fold", "wait_empty")
KEEPS_RESULT = ("as_is", "stages2", "stages3", "stages4", "stages6",
                "lanes16", "lanes64", "phases", "smem_fold", "direct_store",
                "direct_relaxed", "l2_256", "l2_none", "lanes32", "lanes128",
                "steps32", "evict_first", "early_release", "phases_early",
                "seq", "seq_db")
# Variants that launch a kernel with a plan of their own: (lanes,
# stages); None for ``_plan``'s tile, or for the depth ``_plan`` gives
# the tile. ``steps32``'s stages are half as large, so its ring is as deep
# as ``_plan`` ever goes.
PLANS = {"stages2": (32, 2), "stages3": (32, 3), "stages4": (32, 4),
         "stages6": (32, 6), "lanes16": (16, None), "lanes32": (32, None),
         "lanes64": (64, None), "lanes128": (128, None),
         "steps32": (None, 4)}
SASS = ("as_is", "early_release")


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"rglru_variants.py: the kernel no longer holds "
                         f"{old[:60]!r}; update the variant")
    return text.replace(old, new)


COPY = """    float a[kSteps], x[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      a[t] = mine[2 * slot * kTile + t * L];
      x[t] = mine[(2 * slot + 1) * kTile + t * L];
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
"""
STEP = "      h = __fadd_rn(__fmul_rn(expf(a[t]), h), x[t]);\n"
STORE = """    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    consumers_sync<L>();
    if (threadIdx.x == 32) {
      tma_store(&map_h, smem_u32(tile), c0, i * kSteps, bi);
      asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
      // The store two stages back has read the other tile.
      asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");
    }
    consumers_sync<L>();
  }
"""
FOLD = """    float* tile = stg + (i & 1) * kTile;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
""" + STEP + """      tile[t * L + l] = h;
    }
""" + STORE


def phases(src: str) -> str:
    """``clock64`` around the consumer's wait, copy and fold (its first
    lane) and the producer's waits, summed per block into a device array
    that ``rglru_phases`` copies out."""
    src = edit(src, "namespace {\n", "__device__ unsigned long long "
               "g_phase[4096 * 4];\nnamespace {\n")
    src = edit(src, "        if (i >= stages) mbar_wait(empty + 8 * slot, "
               "(i / stages - 1) & 1);\n",
               "        const long long p0 = clock64();\n"
               "        if (i >= stages) mbar_wait(empty + 8 * slot, "
               "(i / stages - 1) & 1);\n"
               "        pw += clock64() - p0;\n")
    src = edit(src, "    if (threadIdx.x == 0) {\n      for (int i = 0; "
               "i < chunks; ++i) {\n",
               "    if (threadIdx.x == 0) {\n      long long pw = 0;\n"
               "      for (int i = 0; i < chunks; ++i) {\n")
    src = edit(src, "      }\n    }\n    return;\n",
               "      }\n      g_phase[4 * (blockIdx.y * gridDim.x + "
               "blockIdx.x) + 3] = pw;\n    }\n    return;\n")
    src = edit(src, "  for (int i = 0; i < chunks; ++i) {\n"
               "    const int slot = i % stages;\n"
               "    mbar_wait(full + 8 * slot, (i / stages) & 1);\n",
               "  long long cw = 0, cc = 0, cf = 0;\n"
               "  for (int i = 0; i < chunks; ++i) {\n"
               "    const int slot = i % stages;\n"
               "    const long long k0 = clock64();\n"
               "    mbar_wait(full + 8 * slot, (i / stages) & 1);\n"
               "    const long long k1 = clock64();\n")
    src = edit(src, COPY, COPY + "    const long long k2 = clock64();\n")
    src = edit(src, STORE, STORE[:-4] + "    cw += k1 - k0; cc += k2 - k1; "
               "cf += clock64() - k2;\n  }\n")
    src = edit(src, "  if (live) h_last[row] = h;\n",
               "  if (live) h_last[row] = h;\n  if (threadIdx.x == 32) {\n"
               "    unsigned long long* g = g_phase + 4 * (blockIdx.y * "
               "gridDim.x + blockIdx.x);\n"
               "    g[0] = cw; g[1] = cc; g[2] = cf;\n  }\n")
    return src + (
        "\nextern \"C\" int rglru_phases(unsigned long long* out, int n) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, "
        "n * 4 * sizeof(unsigned long long)));\n}\n")


def lanes16(src: str) -> str:
    """Tiles of 16 channels: a consumer warp of which half the lanes
    fold, and a launch for them."""
    src = edit(src, "  if (lanes == 32)\n", "  if (lanes == 16)\n    return "
               "launch<16>(log_a, b_in, h0, h_all, h_last, batch, s, w, "
               "stages,\n                      st);\n  if (lanes == 32)\n")
    src = edit(src, "__launch_bounds__(32 + L, 1)", "__launch_bounds__(64, 1)")
    src = edit(src, "kernel<<<grid, 32 + L, smem", "kernel<<<grid, 64, smem")
    src = edit(src, "mbar_init(empty + 8 * slot, L / 32);",
               "mbar_init(empty + 8 * slot, 1);")
    src = edit(src, "const bool live = c < w;",
               "const bool live = l < L && c < w;")
    src = edit(src, "const float* mine = ring + l;",
               "const float* mine = ring + (l < L ? l : 0);")
    return edit(src, "      tile[t * L + l] = h;\n",
                "      if (l < L) tile[t * L + l] = h;\n")


def early_release(src: str) -> str:
    """The fold starts after the warp's `empty` arrive: lane 0's arrive
    returns the barrier's state, every lane takes it by a shuffle, and h
    comes back to each lane through a shuffle whose source lane is the
    lane's own plus 32 times that state (a shuffle reads five bits)."""
    src = edit(src, "// Returns once the phase", """\
__device__ __forceinline__ uint32_t mbar_arrive_state(uint32_t bar) {
  uint32_t state;
  asm volatile("{\\n.reg .b64 st;\\n"
               "mbarrier.arrive.shared::cta.b64 st, [%1];\\n"
               "cvt.u32.u64 %0, st;\\n}\\n"
               : "=r"(state) : "r"(bar) : "memory");
  return state;
}

// Returns once the phase""")
    return edit(src, "    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * "
                "slot);\n", """\
    uint32_t state = 0;
    if ((threadIdx.x & 31) == 0) state = mbar_arrive_state(empty + 8 * slot);
    state = __shfl_sync(0xffffffffu, state, 0);
    h = __shfl_sync(0xffffffffu, h, (threadIdx.x & 31) + (state << 5));
""")


def smem_fold(src: str) -> str:
    """Each step read from shared memory inside the fold; the stage goes
    back to the producer after it."""
    src = edit(src, COPY, "")
    src = edit(src, STEP, "      h = __fadd_rn(__fmul_rn(expf(mine[2 * slot "
               "* kTile + t * L]), h),\n                    mine[(2 * slot + "
               "1) * kTile + t * L]);\n")
    return edit(src, STORE, "    __syncwarp();\n    if ((threadIdx.x & 31) "
                "== 0) mbar_arrive(empty + 8 * slot);\n" + STORE)


def direct_store(src: str, relaxed: bool = False) -> str:
    """Each warp stores its h_t straight to h_all (one 128-byte line a
    step at 32 lanes), no staging tiles; with ``relaxed``, the `empty`
    arrive is relaxed, so its release waits for no pending store (a test
    of why direct stores are slow: the arrive then no longer orders the
    stage's reads before the refill)."""
    src = edit(src, "                      const float* __restrict__ h0,\n",
               "                      const float* __restrict__ h0, "
               "float* __restrict__ h_all,\n")
    src = edit(src, "      ma, mb, mh, static_cast<const float*>(h0),\n",
               "      ma, mb, mh, static_cast<const float*>(h0), "
               "static_cast<float*>(h_all),\n")
    src = edit(src, FOLD, """    const int n = live ? min(kSteps, s - i * kSteps) : 0;
    float* o = h_all + (static_cast<int64_t>(bi) * s + i * kSteps) * w + c;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
""" + STEP + """      if (t < n) o[static_cast<int64_t>(t) * w] = h;
    }
  }
""")
    if relaxed:
        src = edit(src, "mbarrier.arrive.shared::cta.b64 _, [%0];",
                   "mbarrier.arrive.relaxed.cta.shared::cta.b64 _, [%0];")
    return src


def evict_first(src: str) -> str:
    """The TMA loads and stores with an L2 evict-first cache hint."""
    policy = ("  uint64_t policy;\n  asm volatile(\"createpolicy.fractional."
              "L2::evict_first.b64 %0, 1.0;\\n\" : \"=l\"(policy));\n")
    src = edit(src, """                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");""", """                                         int c2) {
""" + policy + """  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(bar), "l"(policy)
      : "memory");""")
    return edit(src, """                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");""", """                                          int c2) {
""" + policy + """  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2), "l"(policy)
      : "memory");""")


def seq_db(src: str) -> str:
    """The one-thread-a-lane kernel with its next 16 steps loaded into a
    second register set while it folds the current ones."""
    return edit(src, """  int t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(t + u) * w;
      a[u] = __ldg(log_a + i);
      x[u] = __ldg(b_in + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      h_all[base + static_cast<int64_t>(t + u) * w] = h;
    }
  }
""", """  int t = 0;
  float a[kUnroll], x[kUnroll];
  if (s >= kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * w;
      a[u] = __ldg(log_a + i);
      x[u] = __ldg(b_in + i);
    }
  }
  for (; t + kUnroll <= s; t += kUnroll) {
    float an[kUnroll], xn[kUnroll];
    const bool more = t + 2 * kUnroll <= s;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(t + kUnroll + u) * w;
      an[u] = more ? __ldg(log_a + i) : 0.f;
      xn[u] = more ? __ldg(b_in + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      h_all[base + static_cast<int64_t>(t + u) * w] = h;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = an[u];
      x[u] = xn[u];
    }
  }
""")


def variants() -> dict[str, tuple[str, str]]:
    """name -> (library kind, source text); kind "tma" or "seq"."""
    src = (CSRC / "rglru_scan_tma.cu").read_text()
    seq = (CSRC / "rglru_scan.cu").read_text()
    return {"as_is": ("tma", src), "phases": ("tma", phases(src)),
            "smem_fold": ("tma", smem_fold(src)),
            "direct_store": ("tma", direct_store(src)),
            "direct_relaxed": ("tma", direct_store(src, relaxed=True)),
            "l2_256": ("tma", edit(src, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                                   "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")),
            "l2_none": ("tma", edit(src, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                                    "CU_TENSOR_MAP_L2_PROMOTION_NONE")),
            "evict_first": ("tma", evict_first(src)),
            "lanes16": ("tma", lanes16(src)),
            "early_release": ("tma", early_release(src)),
            "phases_early": ("tma", early_release(phases(src))),
            "steps32": ("tma", edit(src, "constexpr int kSteps = 64;",
                                    "constexpr int kSteps = 32;")),
            "no_store": ("tma", edit(src, "      tma_store(&map_h, smem_u32"
                                     "(tile), c0, i * kSteps, bi);\n", "")),
            "no_exp": ("tma", edit(src, "__fmul_rn(expf(a[t]), h)",
                                   "__fmul_rn(a[t], h)")),
            "no_fold": ("tma", edit(src, STEP, "      h = a[t] + x[t];\n")),
            "seq": ("seq", seq), "seq_db": ("seq", seq_db(seq))}


# SASS opcodes a consumer's loop is read by: shared loads and stores, the
# exp, the fold's product and sum, mbarrier arrives and waits, shuffles,
# TMA stores and named barriers.
LANDMARKS = ("LDS", "STS", "MUFU.EX2", "FMUL", "FADD", "SYNCS.ARRIVE",
             "SYNCS.PHASECHK", "SHFL", "UTMASTG", "BAR")


def sass_order(sass: str) -> dict[str, str]:
    """For each kernel in ``sass`` (cuobjdump's text), its landmark
    opcodes in program order, run-length coded ("LDS*128 SYNCS.ARRIVE
    MUFU.EX2*64 ..."): where the `empty` arrive sits among the copy's
    loads and the fold's arithmetic."""
    out, name, runs = {}, None, []
    for line in sass.splitlines() + ["Function : <end>"]:
        if "Function : " in line:
            if name is not None:
                out[name] = " ".join(op if n == 1 else f"{op}*{n}"
                                     for op, n in runs)
            name, runs = line.split("Function : ")[1].strip(), []
            continue
        fields = line.split("*/")
        if len(fields) < 2:
            continue
        opcode = fields[1].split()[0] if fields[1].split() else ""
        if opcode.startswith("@"):
            opcode = fields[1].split()[1]
        op = next((m for m in LANDMARKS if opcode.startswith(m)), None)
        if op is None:
            continue
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return out


def build(texts: dict[str, tuple[str, str]]) -> dict[str, list[str]]:
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, text) in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kbuild.cuda_tool("nvcc"), *kbuild.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if name == "as_is":
                raise SystemExit(f"rglru_variants.py: the kernel failed to "
                                 f"build:\n{log}")
            print(json.dumps({"variant": name, "build_failed": log[-2000:]}),
                  flush=True)
            continue
        reports[name] = [ln.strip() for ln in log.splitlines()
                         if "Used" in ln or "spill" in ln]
    return reports


def finish_within(seconds: float, what: str) -> None:
    """Waits for the card's queued work; a kernel still running after
    ``seconds`` (a ring that never fills) ends the process."""
    import torch
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"rglru_variants.py: {what} still running after {seconds} "
                  "s", flush=True)
            os._exit(3)
        time.sleep(0.01)


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("rglru_variants.py: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import rglru_scan as rg
    texts = variants()
    reports = build(texts)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    for name, report in reports.items():
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
    tool = kbuild.cuda_tool("cuobjdump")
    for name in SASS if tool is not None else ():
        sass = subprocess.run([tool, "-sass", str(OUT / f"{name}.so")],
                              capture_output=True, text=True,
                              timeout=300).stdout
        (OUT / f"{name}.sass").write_text(sass)
        for function, order in sass_order(sass).items():
            print(json.dumps({"variant": name, "function": function,
                              "consumer_order": order}), flush=True)

    libs = {}
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (kind, _) in texts.items():
        if name not in reports:
            continue
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if kind == "tma":
            fn = lib.repro_rglru_scan_tma
            fn.argtypes = [p] * 5 + [i32] * 5 + [p]
        else:
            fn = lib.repro_rglru_scan
            fn.argtypes = [p] * 5 + [i32] * 3 + [p]
        fn.restype = ctypes.c_int
        libs[name] = (kind, lib, fn)
    for name in PLANS:     # the kernel launched with other plans
        if name not in libs:
            libs[name], reports[name] = libs["as_is"], reports["as_is"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for case, shape in SHAPES.items():
        b, s, w = shape
        la = -torch.exp(torch.randn(shape, device="cuda", generator=gen))
        bb = torch.randn(shape, device="cuda", generator=gen)
        h0 = torch.randn((b, w), device="cuda", generator=gen)
        want_all, want_last = rg.rglru_scan_plain(la, bb, h0)
        h_all, h_last = torch.empty_like(la), torch.empty_like(h0)

        def runner(name, la=la, bb=bb, h0=h0, h_all=h_all, h_last=h_last,
                   b=b, s=s, w=w):
            kind, _, fn = libs[name]
            plan = rg._plan(b, s, w, sms=sms)
            if name in PLANS:
                lanes, stages = PLANS[name]
                lanes = lanes or plan.lanes
                grid = (-(-w // lanes), b)
                plan = {"lanes": lanes, "grid": grid, "stages": stages
                        or rg._depth(grid[0] * b, s, lanes, sms)}
            else:
                plan = plan._asdict()
            plan["steps"] = 32 if name == "steps32" else rg.STEPS
            args = (la.data_ptr(), bb.data_ptr(), h0.data_ptr(),
                    h_all.data_ptr(), h_last.data_ptr(), b, s, w)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                if kind == "tma":
                    rc = fn(*args, plan["lanes"], plan["stages"], stream)
                else:
                    rc = fn(*args, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed, CUDA error "
                                       f"{rc}")
            return run, plan

        for name in libs:
            run, plan = runner(name)
            row = results.setdefault((name, case), {
                "variant": name, "case": case, "shape": list(shape)})
            if libs[name][0] == "tma":
                row["plan"] = plan
            h_all.fill_(float("nan"))
            run()
            finish_within(20.0, f"{name} at {case}")
            if name in KEEPS_RESULT:
                try:
                    row["max_abs_err"] = max(
                        cs.within(h_all, want_all, cs.SCAN_TOL),
                        cs.within(h_last, want_last, cs.SCAN_TOL))
                except AssertionError as err:
                    row["failed"] = str(err)
                row["bit_equal"] = bool(torch.equal(h_all, want_all)
                                        and torch.equal(h_last, want_last))
        for name in ("phases", "phases_early"):
            if name not in libs:
                continue
            _, lib, _ = libs[name]
            lib.rglru_phases.argtypes = [p, i32]
            run, plan = runner(name)
            blocks = plan["grid"][0] * plan["grid"][1]
            cycles = (ctypes.c_ulonglong * (4 * blocks))()
            run()
            torch.cuda.synchronize()
            if lib.rglru_phases(ctypes.addressof(cycles), blocks):
                raise RuntimeError("reading the phase cycles failed")
            per = [[cycles[4 * k + j] for k in range(blocks)]
                   for j in range(4)]
            results[(name, case)]["cycles_per_block"] = {
                ph: {"mean": sum(v) / blocks, "min": min(v), "max": max(v)}
                for ph, v in zip(PHASES, per)}
        results[("stream_add", case)] = {"variant": "stream_add",
                                         "case": case, "shape": list(shape)}
        order = list(libs) + ["stream_add"]
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                if name == "stream_add":
                    per = cs.time_spread(
                        lambda: torch.add(la, bb, out=h_all))
                else:
                    per = cs.time_spread(runner(name)[0])
                results[(name, case)][f"ms_turn{turn + 1}"] = \
                    per[len(per) // 2]
        nbytes = 4 * (3 * b * s * w + 2 * b * w)
        for (name, c), row in results.items():
            if c == case:
                row["bound_ms"] = cs.bound_ms(nbytes)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
