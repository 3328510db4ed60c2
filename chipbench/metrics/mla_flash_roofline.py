"""The flash attention kernel's share of its roofline in multi-head latent
attention's traced prefills, in %: the least time each launch could take
at the chip's peaks, summed over the launches, over the kernel's device
time. The least time is the longer of the useful operations (QK^T at the
query/key width dn + dr and PV at the value width dv over the causal band
of the prompts) at the bf16 peak, and q and k at dn + dr and v and the
output at dv moved once at the HBM rate. Both read the configuration's
MLA widths, not the launch's shape, so a value width padded for the
kernel counts as no work. Only launches inside a prefill step count; none,
or a configuration without latent attention, no reading."""
import re

KERNEL = re.compile(r"flash_attention\w*_kernel")


def bound_s(arch: dict, batch: int, seq: int, peaks: dict) -> float:
    """The least seconds of one layer's launch over ``batch`` prompts of
    ``seq`` tokens."""
    h = arch["num_heads"]
    dqk = arch["qk_nope_head_dim"] + arch["qk_rope_head_dim"]
    dv = arch["v_head_dim"]
    flops = 2 * batch * h * (dqk + dv) * seq * (seq + 1) // 2
    nbytes = 2 * batch * seq * h * (2 * dqk + 2 * dv)
    return max(flops / peaks["bf16_flops"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(run):
    if run.trace is None or run.peaks is None or \
            not run.arch.get("kv_lora_rank"):
        return None
    ops = run.trace.ops_in("chipbench.prefill", KERNEL)
    if not ops:
        return None
    t = run.traffic
    busy = sum(e - s0 for _, s0, e in ops) / 1e9
    return 100.0 * len(ops) * bound_s(run.arch, t.batch, t.prompt_len,
                                      run.peaks) / busy
