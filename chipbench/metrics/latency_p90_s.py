"""The 90th percentile, over every request the window handed to the
engine, of the seconds from when its batch was handed to ``serve()`` to
when ``serve()`` returned and the device was synchronised (host clock).
A request that failed counts as the longest wait of the window."""
import numpy as np


def read(run):
    worst = max(b.wall for b in run.batches)
    lat = [b.wall if ok else worst for b in run.batches for ok in b.ok]
    return float(np.percentile(lat, 90))
