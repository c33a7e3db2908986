"""pipeline.wta.host_ms_p50: the median over the window's requests of each
request's summed ``pipeline.wta`` span time (``benchmark/stages.py``): the
host's dispatch of the eager volume's WTA planes, with whatever waits on the
card inside it.  Silent where the window holds no such span (a program
without it logs none).  Read in the traced run.

Where the uniqueness gate is on, ``ops/wta.py::second_best_excl_neighbors``
copies an ``inf`` scalar from pageable host memory, and the host waits there
for the card to finish the SGM scan queued before it.  So in
``middeval3_h_sgm.stream`` this reads that wait (~41 ms of a ~47 ms pair on
an H100), not the WTA's dispatch.  When that copy goes, this metric drops by
about the scan's time with almost no change end to end: a drop then is
accounting, not a gain."""

from benchmark import stages

NAME = "pipeline.wta"


def read(obs):
    if stages.idle_ms(obs, NAME) is None:  # no such span in the window
        return None
    return stages.host_ms_p50(obs, NAME)
