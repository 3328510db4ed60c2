"""Device milliseconds of the dense feed-forward sub-layers of a traced
prefill (the program's ``model.mlp`` spans, summed over the layers:
every layer of a dense model, the first of DeepSeekMoE), mean over the
traced prefills. The spans' CUDA events, from
``repro_torch.core.tracing``; none, or no device time, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    got = tracing.step_ms("model.mlp")
    return sum(got) / len(got) if got else None
