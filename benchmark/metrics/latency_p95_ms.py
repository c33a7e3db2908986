"""latency_p95_ms: the 95th percentile of every pair's latency in the
window (harness clock)."""

import numpy as np


def read(obs):
    lat = [r.latency_s for r in obs.requests if r.error is None]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
