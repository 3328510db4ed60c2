"""The flash attention kernels' share of their roofline in the traced
prefills, in %: the least time each launch could take at the chip's peaks
(causal attention over the prompts: QK^T and PV over the band at
the bf16 peak, or q, k, v and the output moved once at the HBM rate,
whichever is longer), summed over the launches, over the kernels' device
time. Only launches inside a prefill step count; none, no reading."""
import re

KERNEL = re.compile(r"flash_attention\w*_kernel")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    ops = run.trace.ops_in("chipbench.prefill", KERNEL)
    if not ops:
        return None
    a, t = run.arch, run.traffic
    b, s, dh = t.batch, t.prompt_len, a["head_dim"]
    h, hkv = a["num_heads"], a["num_kv_heads"]
    flops = 4 * b * h * dh * s * (s + 1) // 2
    nbytes = 2 * b * s * dh * (2 * h + 2 * hkv)
    bound = max(flops / run.peaks["bf16_flops"],
                nbytes / run.peaks["hbm_bytes_per_s"])
    busy = sum(e - s0 for _, s0, e in ops) / 1e9
    return 100.0 * len(ops) * bound / busy
