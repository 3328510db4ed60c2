"""Mean milliseconds of one decode step of the engine over the window:
host clock between two device synchronisations around the step
callable."""


def read(run):
    s = [t for b in run.batches for t in b.decode_s]
    return 1e3 * sum(s) / len(s) if s else None
