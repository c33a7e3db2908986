"""k1_roofline: K1's share of its roofline, in percent: the least time of
K1's function at the configuration's shapes (``roofline.k1_bound``) over
the device time per pair of the kernels named here as K1's (profiler
trace).  Silent where no such kernel ran."""

from types import SimpleNamespace

from benchmark import roofline, tracing

KERNELS = ("asw_wta_kernel", "unpack_right_wide_kernel")


def read(obs):
    if obs.trace is None or not obs.requests:
        return None
    busy = obs.trace.seconds(tracing.kernel_pattern(KERNELS))
    if busy <= 0:
        return None
    cfg = SimpleNamespace(**obs.config["stereo_config"])
    bound_ms, _ = roofline.k1_bound(obs.config["height"], obs.config["width"], cfg)
    return 100.0 * bound_ms / (1e3 * busy / len(obs.requests))
