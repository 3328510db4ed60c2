"""Milliseconds from the start of a traced batch in ``serve()`` (the
program's ``serve.batch`` span) to the end of its first
``serve.readback``, when the batch's first tokens are on the host (host
clock), mean over the traced batches. Read from the program's spans
(``repro_torch.core.tracing``), which it keeps only under the profiler;
none, no reading."""


def read(run):
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    rows = tracing.records()
    first = {}
    for r in rows:
        if r.name == "serve.readback" and r.parent is not None and \
                rows[r.parent].name == "serve.batch":
            first.setdefault(r.parent, r.end_ns - rows[r.parent].start_ns)
    return sum(first.values()) / len(first) / 1e6 if first else None
