"""95th percentile of the latency of every completed request in the window
(the call until its poses are on the host), linear between order statistics."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
