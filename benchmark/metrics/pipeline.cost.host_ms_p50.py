"""pipeline.cost.host_ms_p50: the median over the window's requests of each
request's summed ``pipeline.cost`` span time (``benchmark/stages.py``): the
host's dispatch of the eager raw cost volume, with whatever waits on the
card inside it.  Silent where the window holds no such span (a program
without it logs none).  Read in the traced run."""

from benchmark import stages

NAME = "pipeline.cost"


def read(obs):
    if stages.idle_ms(obs, NAME) is None:  # no such span in the window
        return None
    return stages.host_ms_p50(obs, NAME)
