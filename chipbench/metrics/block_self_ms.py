"""Device milliseconds of a traced prefill's layers outside their
attention, dense feed-forward and MoE sub-layers: each ``model.block``
span less its ``model.attention``, ``model.mlp`` and ``model.moe``
children (the RMSNorms and residual adds), summed over the layers, mean
over the traced prefills. The spans' CUDA events, from
``repro_torch.core.tracing``; none, or no device time, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    got = tracing.step_ms("model.block", own=True)
    return sum(got) / len(got) if got else None
