"""Device milliseconds of multi-head latent attention's decompression in a
traced prefill (the program's ``mla.kv_up`` spans: the latent times
``w_kv_b`` into every head's keys and values, summed over the layers),
mean over the traced prefills. The spans' CUDA events, from
``repro_torch.core.tracing``; none, or no device time, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    got = tracing.step_ms("mla.kv_up")
    return sum(got) / len(got) if got else None
