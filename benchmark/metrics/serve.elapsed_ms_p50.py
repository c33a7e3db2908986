"""serve.elapsed_ms_p50: the median of the daemon's own ``elapsed_ms`` over
every answer of the window (host-to-device copy, pipeline, encoding and the
device-to-host copy that waits for the card)."""

import numpy as np


def read(obs):
    ms = [r.elapsed_ms for r in obs.requests if r.elapsed_ms is not None]
    return float(np.percentile(ms, 50)) if ms else None
