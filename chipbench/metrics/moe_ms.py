"""Device milliseconds of the MoE sub-layers of a traced prefill (the
program's ``model.moe`` spans, routing, dispatch, experts, combine and
shared experts included, summed over the layers), mean over the traced
prefills. The spans' CUDA events, from ``repro_torch.core.tracing``;
none, or no device time, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    got = tracing.step_ms("model.moe")
    return sum(got) / len(got) if got else None
