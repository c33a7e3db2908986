"""pipeline.cost.idle_ms: device idle time per cycle, in ms, while
``pipeline.cost`` is the innermost program span on the caller's thread: the
host's dispatch of the eager raw cost volume (``ops/cost.py::cost_volume``,
~10 ops per disparity) ahead of the SGM scan.  A cycle runs from one
``pipeline.call`` to the next (``benchmark/stages.py``: the program's spans
against the profiler trace).  Silent where the window holds no such span.
Read in the traced run, so the profiler's cost on the host is in it."""

from benchmark import stages


def read(obs):
    return stages.idle_ms(obs, "pipeline.cost")
