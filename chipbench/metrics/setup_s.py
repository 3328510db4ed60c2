"""Seconds from the process's start to the first timed batch: imports,
the kernels' libraries (built on a checkout's first run), the engine and
the weights drawn on the device, and the warm-up batches (host clock)."""


def read(run):
    return run.setup_s
