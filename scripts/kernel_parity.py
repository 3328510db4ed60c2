#!/usr/bin/env python3
"""Hold this tree's kernels against another checkout's on the card, bit
for bit, on inputs both trees take: the CUDA-core flash route (float32
and bf16 at D = 64, 80 and 256, the route forced: bf16 at D = 80 takes a
tensor-core kernel otherwise), the wgmma flash route at D = 64, 128 and
256 (bf16, the serving shapes among them), the mma.sync flash route
forced at D = 80 (bf16), the RWKV-6 scan's one-step-at-a-time route (K,
V up to 64; the served K = V = 64 with the route forced) and the
segmented reduction through sorted ids and through host offsets.

    python3 scripts/kernel_parity.py OTHER_CHECKOUT

Run from the repository root on a machine with a CUDA card and ``nvcc``.
The other checkout (e.g. the parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists) runs in a child
process with its own ``src`` on the path and builds its own kernels;
both make their inputs from the same seeded ``torch.Generator``. Prints
one JSON line a case and exits 1 if any output differs.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (B, S, H, Hkv, D, dtype, causal, window) of the CUDA-core flash route.
FLASH = ((2, 700, 4, 2, 80, "float32", True, 0),
         (2, 700, 4, 2, 64, "float32", True, 128),
         (1, 513, 4, 1, 256, "float32", False, 0),
         (2, 700, 4, 2, 80, "bfloat16", True, 0))
# (B, S, H, Hkv, D, causal, window) of the wgmma route (bf16), among them
# RecurrentGemma-2B's, InternLM2-1.8B's and MusicGen-medium's serving
# shapes, and of the mma.sync route forced at D = 80 (bf16).
FLASH_TC = ((4, 4096, 10, 1, 256, True, 2048), (1, 513, 4, 1, 256, False, 0),
            (1, 4096, 16, 8, 128, True, 0), (2, 700, 6, 3, 128, False, 300),
            (1, 4096, 24, 24, 64, True, 0), (2, 700, 4, 2, 64, True, 100))
FLASH_MMA = ((2, 700, 4, 2, 80, True, 0), (1, 1000, 8, 8, 80, True, 128))
# (B, S, H, K, V, dtype) of the RWKV-6 seq route; K = V = 64 forced there.
RWKV = ((2, 1000, 3, 32, 48, "float32"), (2, 1000, 3, 32, 48, "bfloat16"),
        (1, 300, 2, 64, 16, "float32"), (2, 1000, 3, 64, 64, "bfloat16"))
# (C, n, S) of the segmented reduction over sorted ids.
SEGMENTS = ((4, 1_000_000, 1000), (5, 3_000_000, 6))


def outputs() -> dict:
    """Every case's outputs in the tree whose ``src`` is on the path."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import segment_reduce as sr
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    bf = dict(dtype=torch.bfloat16, device="cuda", generator=gen)
    for route, cases in (("tc", FLASH_TC), ("mma", FLASH_MMA)):
        for b, s, h, hkv, d, causal, window in cases:
            q = torch.randn((b, s, h, d), **bf)
            k, v = (torch.randn((b, s, hkv, d), **bf) for _ in range(2))
            out[f"flash {route} b{b} s{s} h{h}/{hkv} d{d} w{window}"] = \
                fa._flash_cuda(q, k, v, causal, window, route=route)
    fa._route = lambda *a: "fma"
    for b, s, h, hkv, d, dt, causal, window in FLASH:
        opts = dict(dtype=getattr(torch, dt), device="cuda", generator=gen)
        q = torch.randn((b, s, h, d), **opts)
        k, v = (torch.randn((b, s, hkv, d), **opts) for _ in range(2))
        out[f"flash d{d} {dt} w{window}"] = fa.flash_attention(
            q, k, v, causal=causal, window=window)
    seq = lambda *a: "seq"  # noqa: E731
    rs._route = seq
    for b, s, h, kd, vd, dt in RWKV:
        f32 = dict(dtype=torch.float32, device="cuda", generator=gen)
        r, k = (torch.randn((b, s, h, kd), **f32).to(getattr(torch, dt))
                for _ in range(2))
        v = torch.randn((b, s, h, vd), **f32).to(getattr(torch, dt))
        lw = -torch.exp(torch.randn((b, s, h, kd), **f32) - 2.0)
        u = torch.randn((h, kd), **f32) * 0.3
        s0 = torch.randn((b, h, kd, vd), **f32) * 0.1
        o, sf = rs.rwkv6_scan(r, k, v, lw, u, s0)
        out[f"rwkv6 k{kd} v{vd} {dt} o"], out[f"rwkv6 k{kd} v{vd} {dt} s"] \
            = o, sf
    for c, n, segs in SEGMENTS:
        rng = np.random.default_rng(n)
        ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
        offsets = np.searchsorted(ids, np.arange(segs + 1))
        vals = torch.as_tensor(rng.uniform(1.0, 1000.0, (c, n)),
                               dtype=torch.float32, device="cuda")
        ids_t = torch.from_numpy(ids).cuda()
        for mode in ("sum", "count", "min", "max"):
            out[f"segment c{c} n{n} s{segs} {mode} ids"] = sr.segment_reduce(
                vals, ids_t, num_segments=segs, mode=mode)
            out[f"segment c{c} n{n} s{segs} {mode} offsets"] = \
                sr.segment_reduce(vals, offsets=offsets, mode=mode)
    torch.cuda.synchronize()
    return {k: t.cpu() for k, t in out.items()}


def main(argv) -> int:
    import torch
    if len(argv) == 2 and argv[0] == "--emit":
        torch.save(outputs(), argv[1])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(argv[0]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "other.pt"
        subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                        "--emit", str(path)], check=True, cwd=other,
                       env={**os.environ, "PYTHONPATH": str(other / "src")})
        theirs = torch.load(path)
    sys.path.insert(0, str(ROOT / "src"))
    ours = outputs()
    differ = 0
    for name, got in ours.items():
        want = theirs[name]
        equal = got.dtype == want.dtype and torch.equal(got, want)
        differ += not equal
        print(json.dumps({"case": name, "bit_equal": equal,
                          "max_abs_diff": float((got.float() - want.float())
                                                .abs().max())}))
    print(json.dumps({"cases": len(ours), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
