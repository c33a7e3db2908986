"""sgm_roofline: the SGM scan kernel's share of its roofline, in percent: the
least time of SGM's function at the configuration's shapes
(``roofline.sgm_bound``: by bytes, one read of the raw volume and one write
of S) over the device time per pair of the configuration's
``aggregation_kernels`` (profiler trace).  Silent where no such kernel ran."""

from types import SimpleNamespace

from benchmark import roofline, tracing


def read(obs):
    if obs.trace is None or not obs.requests:
        return None
    busy = obs.trace.seconds(tracing.kernel_pattern(obs.config["aggregation_kernels"]))
    if busy <= 0:
        return None
    cfg = SimpleNamespace(**obs.config["stereo_config"])
    bound_ms, _ = roofline.sgm_bound(obs.config["height"], obs.config["width"], cfg)
    return 100.0 * bound_ms / (1e3 * busy / len(obs.requests))
