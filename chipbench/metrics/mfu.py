"""Model FLOPs of the prompts the window completed (the reference's count:
the matrix products of the parameters each token activates, the causal
band of attention, the LM head at the last token), over the window and
the chip's bf16 peak, in %. Padding and the decode steps count as no
work."""


def read(run):
    if run.peaks is None:
        return None
    done = sum(sum(b.ok) for b in run.batches)
    flops = done * run.reference.prompt_flops(run.arch, run.traffic.prompt_len)
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops"]
