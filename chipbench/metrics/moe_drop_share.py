"""Routed (token, expert) assignments of the traced prefills that the
MoE's capacity dropped, in % of all the prefills' assignments: the
program's counters ``moe.assignments`` and ``moe.kept``, counted in its
capacity dispatch (``repro_torch.core.tracing``, kept only under the
profiler); none, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    rows, got = tracing.records(), {}
    for (step, name), n in tracing.counters().items():
        if step is not None and rows[step].name == "serve.prefill":
            got[name] = got.get(name, 0) + n
    if not got.get("moe.assignments"):
        return None
    return 100.0 * (got["moe.assignments"] - got["moe.kept"]) \
        / got["moe.assignments"]
