"""``recommend_p50_ms``: the median latency of all requests of the window,
each from when it was due to when its DataFrame was returned (host
clock)."""

import numpy as np


def read(run):
    lat = run.record.get("latency_s")
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 50)) * 1e3
