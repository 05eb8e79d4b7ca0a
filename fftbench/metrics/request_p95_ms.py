"""The 95th percentile of every request's latency in the window (from the
issue of its first call to the synchronize that ends it); closed loops only."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
