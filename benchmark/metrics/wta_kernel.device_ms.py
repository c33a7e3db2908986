"""wta_kernel.device_ms: device time per pair, in ms, of the WTA kernel
(``aswstereomatch_torch/ops/cuda/wta_kernel.cu``: the device operations
whose names hold ``wta_planes_kernel``), read from the profiler trace: the
eager volume's WTA planes, one launch a pair in span ``pipeline.wta``.
Silent where no such kernel ran (a program without it takes the planes in
plain ops, which ``plain_ops.device_ms`` counts)."""

from benchmark import tracing

KERNELS = ["wta_planes_kernel"]


def read(obs):
    if obs.trace is None or not obs.requests:
        return None
    busy = obs.trace.seconds(tracing.kernel_pattern(KERNELS))
    return 1e3 * busy / len(obs.requests) if busy > 0 else None
