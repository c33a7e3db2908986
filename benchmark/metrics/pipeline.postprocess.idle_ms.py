"""pipeline.postprocess.idle_ms: device idle time per cycle, in ms, while
``pipeline.postprocess`` is the innermost program span on the caller's thread:
the post-process's dispatch: subpixel, LR check, fill, median.  A cycle runs from one ``pipeline.call`` to the next
(``benchmark/stages.py``: the program's spans against the profiler trace).
Read in the traced run, so the profiler's cost on the host is in it."""

from benchmark import stages


def read(obs):
    return stages.idle_ms(obs, "pipeline.postprocess")
