"""latency_p50_ms: the median of every pair's latency in the window, from
its call or send to its map in host memory (harness clock)."""

import numpy as np


def read(obs):
    lat = [r.latency_s for r in obs.requests if r.error is None]
    return float(np.percentile(lat, 50) * 1e3) if lat else None
