"""dispatch_ms_p95: the 95th percentile, over every dispatch consumed in the
window, of the milliseconds from the start of its issue (its draws and the
round call) to its flags on the host (host clock)."""
import numpy as np


def read(run):
    lat = [d.latency_s for d in run.dispatches]
    return float(np.percentile(lat, 95)) * 1e3
