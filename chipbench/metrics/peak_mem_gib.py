"""``torch.cuda.max_memory_allocated()`` over the run up to the window's
close, in GiB: the weights, the caches and the activations of the cell's
batch."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
