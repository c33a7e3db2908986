"""serve.wire_ms_p50: the median over the window's requests of the client's
round trip less the daemon's ``elapsed_ms``: the wire both ways, the
daemon's request parse and response assembly, and the wait for a handler
thread."""

import numpy as np


def read(obs):
    ms = [r.latency_s * 1e3 - r.elapsed_ms for r in obs.requests if r.elapsed_ms is not None]
    return float(np.percentile(ms, 50)) if ms else None
