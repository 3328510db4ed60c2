"""Mean milliseconds a batch spends in ``ServingEngine.serve`` outside its
prefill and decode steps over the window (host clock): padding the
prompts and copying them in, greedy sampling, reading the tokens back,
and Python."""


def read(run):
    if not run.batches:
        return None
    rest = [b.wall - sum(b.prefill_s) - sum(b.decode_s) for b in run.batches]
    return 1e3 * sum(rest) / len(rest)
