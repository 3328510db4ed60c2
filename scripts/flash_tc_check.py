#!/usr/bin/env python3
"""Check and time the wgmma flash-attention kernel at every head dim it
takes, on one GPU.

    python3 scripts/flash_tc_check.py [--variants NAME,...] [--no-sweep]
                                      [--build-only]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds ``src/repro_torch/csrc/flash_attention_wgmma.cu`` as
it is and variants made by editing its text (one ``nvcc`` each, all at
once, into ``build/flash_tc_variants/``) and prints, per library and
head-dim instance, ptxas' registers and spills and the count of HGMMA
(``wgmma``) instructions in its SASS. Then, with the kernel as it is:

- bf16 q, k, v at every head dim the route takes (the multiples of 16
  from 16 to 256: GQA and MHA, causal, windowed and full, ragged Skv, Sq
  != Skv), each on the tc route, against the plain version within
  ``chip_smoke.BF16_TOL`` and against float32 attention within one bf16
  rounding plus 1e-4 (``chip_smoke.check_flash_f32``);
- two planted faults at D = 80 that must fail that check: S without the
  head dim's tail (q and k columns 64-79 zeroed in the plain version)
  and O's columns 64-79 zeroed;
- at StableLM-3B's prefill shape, q, k, v (4, 4096, 32, 80) bf16 causal:
  the kernel, the mma.sync route forced on the same inputs (the route
  D = 80 took before), ``scaled_dot_product_attention`` and the plain
  version, in turns, five CUDA-event batches each, beside the bound;
- the variants at StableLM's shape and at RecurrentGemma-2B's,
  InternLM2's and MusicGen's (D = 256, 128 and 64), in turns (all, then
  all in reverse), each held bit for bit against ``as_is`` where it
  keeps the arithmetic: ``no_overlap`` (neither lever: two consumer
  warpgroups, each waiting on every product), ``two_wg`` (two
  consumer warpgroups up to D = 128 too), ``three_wg_no_pipe`` (three,
  without the in-warpgroup overlap), ``pipe_192`` (both levers up to D
  = 192), ``two_blocks`` (no overlap, two blocks an SM up to a padded
  width of 128: consumers at 104 registers, 2 stages), ``no_copy`` (the
  softmax masks S in the accumulator's own registers: ptxas serialises
  the wgmmas, C7513), ``no_lo`` (P V with the hi half of P alone: what
  the P split costs; its error is printed, it need not pass).

``--variants`` builds and times only the named variants beside
``as_is``; ``--no-sweep`` leaves out the head-dim sweep and the planted
faults; ``--build-only`` stops after the build (ptxas' notes, such as
C7513, are printed with each library). Each variant's first launch runs
under a 20 s hang guard. Prints the card's name and power limit and one
JSON line per result; exits 1 if a check fails or an instance of the
kernel as it is spills or holds no HGMMA.
"""
from __future__ import annotations

import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_wgmma.cu"
OUT = ROOT / "build" / "flash_tc_variants"
STAGES = "static constexpr int kStages = kDP == 256 ? 2 : 3;"
PIPE = "static constexpr bool kPipe = D <= 128;"
WG = "static constexpr int kWG = kPipe ? 3 : 2;"
REGS = "static constexpr int kRegs = kWG == 3 ? 160 : 240;"
NO_PIPE = (PIPE, PIPE.replace("D <= 128", "false"))
VARIANTS = {
    "as_is": [],
    # The kernel without either lever (the first design for the tail).
    "no_overlap": [NO_PIPE],
    "two_wg": [(WG, WG.replace("kPipe ? 3 : 2", "2"))],
    "three_wg_no_pipe": [NO_PIPE, (WG, WG.replace("kPipe", "D <= 128"))],
    "pipe_192": [(PIPE, PIPE.replace("128", "192"))],
    "two_blocks": [NO_PIPE,
                   ("__launch_bounds__(Cfg<D>::kThreads, 1)",
                    "__launch_bounds__(Cfg<D>::kThreads, D <= 128 ? 2 : 1)"),
                   (REGS, REGS.replace("240", "(D <= 128 ? 104 : 240)")),
                   (STAGES, "static constexpr int kStages = kDP == 256 || "
                    "kDP <= 128 ? 2 : 3;")],
    "no_copy": [("          float sm[32];\n          copy_acc(sc, sm);\n",
                 "          float (&sm)[32] = sc;\n")],
    "no_lo": [("          wgmma_rs(acc[c], plo[kk], dvk);\n", ""),
              ("          wgmma_rs(acc_t, plo[kk], dvk);\n", "")],
}
# The variants that keep the kernel's arithmetic (bit-equal to as_is).
KEEPS_BITS = ("as_is", "no_overlap", "two_wg", "three_wg_no_pipe",
              "pipe_192", "two_blocks", "no_copy")
# (B, Sq, Skv, H, Hkv, D, causal, window)
CASES = [(1, 300, 300, 4, 2, 16, True, 0),
         (2, 333, 340, 6, 3, 32, False, 100),
         (1, 517, 517, 4, 1, 48, True, 64),
         (2, 260, 301, 4, 2, 64, True, 0),
         (4, 4096, 4096, 32, 32, 80, True, 0),
         (2, 64, 71, 2, 1, 80, False, 0), (1, 1, 1, 4, 2, 80, True, 0),
         (2, 333, 340, 6, 3, 96, False, 100),
         (1, 517, 517, 4, 1, 112, True, 64),
         (2, 333, 301, 4, 2, 128, True, 0),
         (1, 200, 200, 4, 4, 144, True, 0),
         (2, 333, 301, 4, 2, 160, False, 17),
         (2, 333, 301, 4, 2, 176, True, 64),
         (1, 257, 257, 4, 2, 192, True, 0),
         (2, 333, 301, 4, 2, 208, False, 0),
         (1, 300, 333, 4, 2, 224, True, 0),
         (2, 333, 301, 4, 2, 240, True, 64),
         (1, 384, 384, 4, 1, 256, True, 160)]
STABLELM = (4, 4096, 32, 80)
# (B, S, H, D), Hkv, window of the other shapes the variants are timed at
# (causal): RecurrentGemma-2B's serving shape, InternLM2-1.8B's, MusicGen-
# medium's.
OTHER_SHAPES = {"recurrentgemma": ((4, 4096, 10, 256), 1, 2048),
                "internlm2": ((1, 4096, 16, 128), 8, 0),
                "musicgen": ((1, 4096, 24, 64), 24, 0)}


def out(**fields) -> None:
    print(json.dumps(fields), flush=True)


def hgmma_by_instance(lib) -> dict:
    """HGMMA instructions in the SASS of each head-dim instance, and the
    waits on them (WARPGROUP.DEPBAR: one after each HGMMA where ptxas
    serialised the products)."""
    from repro_torch.kernels import build as kbuild
    tool = kbuild.cuda_tool("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*wgmma_kernelILi(\d+)E", part)
        if m:
            counts[int(m[1])] = (part.count("HGMMA"),
                                 part.count("WARPGROUP.DEPBAR"))
    return counts


def build(names) -> dict:
    """Each named variant's library path, built all at once; ptxas'
    report."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        edits = VARIANTS[name]
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
    t0, built, bad = time.perf_counter(), {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            out(library=name, failed_to_build=log[-3000:])
            if name == "as_is":
                raise SystemExit("the kernel as it is failed to build")
            continue
        per_d, d = {}, None
        for ln in log.splitlines():
            m = re.search(r"wgmma_kernelILi(\d+)E", ln)
            if m and "Compiling" in ln:
                d = int(m[1])
            elif d is not None and "registers" in ln:
                per_d.setdefault(d, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", ln)[1])
            elif d is not None and "spill" in ln:
                per_d.setdefault(d, {})["spilled_bytes"] = sum(
                    int(b) for b in re.findall(
                        r"(\d+) bytes spill (?:stores|loads)", ln))
        for dd, (n, waits) in hgmma_by_instance(OUT / f"{name}.so").items():
            per_d.setdefault(dd, {}).update(hgmma=n, hgmma_waits=waits)
        out(library=name, seconds=time.perf_counter() - t0,
            instances=per_d, ptxas_notes=sorted(
                {ln.strip() for ln in log.splitlines()
                 if "arning" in ln or "C75" in ln}))
        built[name] = OUT / f"{name}.so"
        if name == "as_is":
            bad = [d for d, r in per_d.items()
                   if r.get("spilled_bytes", 0) or r.get("hgmma") == 0]
    if bad:
        raise SystemExit(f"instances that spill or hold no HGMMA: {bad}")
    return built


def use(path) -> None:
    """Route the wrapper's tc launches to the library at ``path``."""
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_flash_attention_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fa._LIBS["tc"] = lib


def guarded(fn, what: str, seconds: float = 20.0):
    """``fn()``, then wait for the card with a time limit: a kernel that
    hangs ends the process."""
    import torch
    got = fn()
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"flash_tc_check.py: {what} still running after {seconds}"
                  " s", flush=True)
            os._exit(3)
        time.sleep(0.01)
    return got


def check_sweep(cs, fa, bf) -> list:
    import torch
    failed = []
    for b, sq, skv, h, hkv, d, causal, window in CASES:
        q = torch.randn((b, sq, h, d), **bf)
        k, v = (torch.randn((b, skv, hkv, d), **bf) for _ in range(2))
        n0 = fa.FLASH_ATTENTION_TC_LAUNCHES
        case = [b, sq, skv, h, hkv, d, causal, window]
        got = guarded(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                 window=window), f"D = {d}")
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        try:
            if fa.FLASH_ATTENTION_TC_LAUNCHES != n0 + 1:
                raise AssertionError("not the tc route")
            err = cs.within(got, want, cs.BF16_TOL)
            out(case=case, max_abs_err=err,
                **cs.check_flash_f32(q, k, v, got, causal, window))
        except AssertionError as e:
            failed.append(case)
            out(case=case, failed=str(e)[:400])
    return failed


def check_planted(cs, fa, bf) -> list:
    """At D = 80: S without the tail, and O's tail zeroed, must fail."""
    import torch
    q = torch.randn((2, 700, 4, 80), **bf)
    k, v = (torch.randn((2, 700, 2, 80), **bf) for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=True)
    qz, kz = q.clone(), k.clone()
    qz[..., 64:], kz[..., 64:] = 0, 0
    no_tail = fa.flash_attention_plain(qz, kz, v, causal=True)
    o_zeroed = got.clone()
    o_zeroed[..., 64:] = 0
    want = fa.flash_attention_plain(q, k, v, causal=True)
    failed = []
    for name, a, b in (("s_without_tail", got, no_tail),
                       ("o_tail_zeroed", o_zeroed, want)):
        try:
            cs.within(a, b, cs.BF16_TOL)
            failed.append(name)
            out(planted=name, seen=False)
        except AssertionError as e:
            out(planted=name, seen=True, check=str(e)[:200])
    return failed


def main(argv) -> int:
    import argparse
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_tc_check.py: no CUDA device", file=sys.stderr)
        return 1
    names = ["as_is"] + [n for n in args.variants.split(",")
                         if n != "as_is"]
    libs = build(names)
    if args.build_only:
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    use(libs["as_is"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device="cuda", generator=gen)
    failed = [] if args.no_sweep else \
        check_sweep(cs, fa, bf) + check_planted(cs, fa, bf)

    b, s, h, d = STABLELM
    q, k, v = (torch.randn((b, s, h, d), **bf) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    funcs = {
        "tc": lambda: fa.flash_attention(q, k, v, causal=True),
        "mma": lambda: fa._flash_cuda(q, k, v, True, 0, route="mma"),
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
        tflops_per_s={n: flops / min(t) / 1e9 for n, t in times.items()},
        ms={n: sorted(t) for n, t in times.items()})

    shapes = {"stablelm": (q, k, v, 0)}
    for name, ((sb, ss, sh, sd), shkv, win) in OTHER_SHAPES.items():
        shapes[name] = (torch.randn((sb, ss, sh, sd), **bf),
                        *(torch.randn((sb, ss, shkv, sd), **bf)
                          for _ in range(2)), win)
    for shape, (sq_, sk_, sv_, win) in shapes.items():
        call = lambda: fa.flash_attention(  # noqa: E731
            sq_, sk_, sv_, causal=True, window=win)
        want = fa.flash_attention_plain(sq_, sk_, sv_, causal=True,
                                        window=win)
        use(libs["as_is"])
        base = call()
        for name in libs:
            use(libs[name])
            got = guarded(call, f"variant {name} at {shape}")
            equal = bool(torch.equal(got, base))
            if name in KEEPS_BITS and not equal:
                failed.append(f"{name} at {shape}: not bit-equal to as_is")
            out(variant=name, shape=shape, bit_equal_as_is=equal,
                max_abs_err=float((got.float() - want.float()).abs().max()))
        times = {n: [] for n in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                use(libs[name])
                times[name] += cs.time_spread(call)
        out(shape=shape, variants_ms={n: sorted(t)
                                      for n, t in times.items()})
    use(libs["as_is"])
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
