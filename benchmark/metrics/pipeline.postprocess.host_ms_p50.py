"""pipeline.postprocess.host_ms_p50: the median over the window's requests
of each request's summed ``pipeline.postprocess`` span time
(``benchmark/stages.py``): the host's dispatch of subpixel, LR check, fill
and median, with whatever waits on the card inside it.  Read in the traced
run."""

from benchmark import stages


def read(obs):
    return stages.host_ms_p50(obs, "pipeline.postprocess")
