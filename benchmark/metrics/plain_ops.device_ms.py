"""plain_ops.device_ms: device time per pair of every kernel and copy that
is not the aggregation kernel (the configuration's ``aggregation_kernels``):
the preprocess, the post-process and the copies (profiler trace)."""

from benchmark import tracing


def read(obs):
    if obs.trace is None or not obs.requests:
        return None
    other = obs.trace.seconds(tracing.kernel_pattern(obs.config["aggregation_kernels"]),
                              exclude=True)
    return 1e3 * other / len(obs.requests) if other > 0 else None
