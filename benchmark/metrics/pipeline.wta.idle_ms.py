"""pipeline.wta.idle_ms: device idle time per cycle, in ms, while
``pipeline.wta`` is the innermost program span on the caller's thread: the
host's dispatch of the eager volume's WTA planes (``ops/wta.py::planes``:
the argmin and its triple, the right view's argmin, the second best), with
whatever waits on the card inside it.  A cycle runs from one
``pipeline.call`` to the next (``benchmark/stages.py``).  Silent where the
window holds no such span (a program without it logs none).  Read in the
traced run, so the profiler's cost on the host is in it."""

from benchmark import stages


def read(obs):
    return stages.idle_ms(obs, "pipeline.wta")
