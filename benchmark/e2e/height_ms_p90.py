"""The 90th percentile of the milliseconds from an ODS handed over on the
host to its committed entry, over every height of the window (numpy's
linear percentile). A mix that hands over batches has no heights."""

import numpy as np


def read(win):
    if win.batched or not win.latencies_s:
        return None
    return float(np.percentile(np.asarray(win.latencies_s), 90)) * 1e3
