"""The share of the traced batches' window in which no operation ran on
the device, in %: 1 - the union of the device operations' intervals in
the profiler's trace over the window."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
