"""Device milliseconds of the MoE's routing around its experts in a
traced prefill: the program's ``moe.route`` (router, top-k),
``moe.dispatch`` (capacity positions, scatter into the experts' buffer)
and ``moe.combine`` (gather back, gate-weighted) spans, summed over the
layers, mean over the traced prefills. The spans' CUDA events, from
``repro_torch.core.tracing``; none, or no device time, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    got = tracing.step_ms(("moe.route", "moe.dispatch", "moe.combine"))
    return sum(got) / len(got) if got else None
