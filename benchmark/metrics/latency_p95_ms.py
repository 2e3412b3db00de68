"""latency_p95_ms: the 95th percentile of the host-clock latency of every
call of the window, from its send to its answers on the host."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return 1000.0 * float(np.percentile(np.asarray(run.latencies_s), 95))
