"""The grouped-matmul kernels' share of their roofline in the traced
prefills, in %: the least time each launch could take at the chip's peaks
(x (E, C, D) by w (E, D, F) at the capacity C the prefill's tokens fix:
2 E C D F operations at the bf16 peak, or x, w and the output moved once
at the HBM rate, whichever is longer; the gate, up and down products have
the same bound), summed over the launches, over the kernels' device time.
Only launches inside a prefill step count; none, no reading."""
import re

KERNEL = re.compile(r"(?<![A-Za-z0-9])gmm_\w*kernel")


def read(run):
    if run.trace is None or run.peaks is None or not run.arch.get("moe"):
        return None
    ops = run.trace.ops_in("chipbench.prefill", KERNEL)
    if not ops:
        return None
    mo, t = run.arch["moe"], run.traffic
    e, d, f = mo["num_experts"], run.arch["d_model"], mo["expert_d_ff"]
    c = run.reference.capacity(mo, t.batch * t.prompt_len)
    flops = 2 * e * c * d * f
    nbytes = 2 * (e * c * d + e * d * f + e * c * f)
    bound = max(flops / run.peaks["bf16_flops"],
                nbytes / run.peaks["hbm_bytes_per_s"])
    busy = sum(end - s0 for _, s0, end in ops) / 1e9
    return 100.0 * len(ops) * bound / busy
