"""Device milliseconds of multi-head latent attention's core in a traced
prefill (the program's ``mla.core`` spans: the flash launch over the
decompressed heads, summed over the layers), mean over the traced
prefills. The spans' CUDA events, from ``repro_torch.core.tracing``; none,
or no device time, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    got = tracing.step_ms("mla.core")
    return sum(got) / len(got) if got else None
