"""sgm_wide_roofline: the SGM scan's share of its roofline at a disparity
range past the register path's, in percent: ``roofline.sgm_bound`` at the
configuration's shapes (by bytes, one read of the raw volume and one write
of S) over the device time per pair of the configuration's
``aggregation_kernels`` (profiler trace), as ``sgm_roofline`` reads it.
Whichever of the scan's paths runs the range, the share reads the same
kernels.  Silent where no such kernel ran."""

from benchmark import harness


def read(obs):
    return harness.metric_reader("sgm_roofline").read(obs)
