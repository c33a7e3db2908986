"""pipeline.aggregate.idle_ms: device idle time per cycle, in ms, while
``pipeline.aggregate`` is the innermost program span on the caller's thread:
the kernel wrapper's own host work (plan, tables, the library's load, the launch) or the eager volume: ``pipeline.aggregate``'s self time.  A cycle runs from one ``pipeline.call`` to the next
(``benchmark/stages.py``: the program's spans against the profiler trace).
Read in the traced run, so the profiler's cost on the host is in it."""

from benchmark import stages


def read(obs):
    return stages.idle_ms(obs, "pipeline.aggregate")
