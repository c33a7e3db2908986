"""pipeline.input.idle_ms: device idle time per cycle, in ms, while
``pipeline.input`` is the innermost program span on the caller's thread:
the input's copy to the card and its widening to float32 (``StereoMatcher._as_input``), and the pipeline's routing between stages (``pipeline.call`` itself innermost).  A cycle runs from one ``pipeline.call`` to the next
(``benchmark/stages.py``: the program's spans against the profiler trace).
Read in the traced run, so the profiler's cost on the host is in it."""

from benchmark import stages


def read(obs):
    return stages.idle_ms(obs, "pipeline.input")
