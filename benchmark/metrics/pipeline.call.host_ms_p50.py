"""pipeline.call.host_ms_p50: the median over the window's requests of the
program's own ``pipeline.call`` span, ``StereoMatcher.__call__`` from
inside (``benchmark/stages.py``): the twin of ``pipeline.call_ms_p50``
without the harness's call and span around it.  Read in the traced run."""

from benchmark import stages


def read(obs):
    return stages.host_ms_p50(obs, stages.ROOT)
