"""pipeline.call_ms_p50: the median over the window's pairs of
``StereoMatcher.__call__`` until it returned, before the host fetch
(harness clock): the host's enqueue of the pair, with whatever waits for
the card inside it.  Read in the traced run, so the profiler's cost on the
host is in it."""

import numpy as np


def read(obs):
    ms = [r.call_s * 1e3 for r in obs.requests if r.call_s is not None]
    return float(np.percentile(ms, 50)) if ms else None
