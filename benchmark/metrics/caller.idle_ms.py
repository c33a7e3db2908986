"""caller.idle_ms: device idle time per cycle, in ms, while no program
span is open on the caller's thread: the caller's fetch of the map and its
loop, outside the program (``benchmark/stages.py``).  Read in the traced
run."""

from benchmark import stages


def read(obs):
    return stages.idle_ms(obs, stages.OUTSIDE)
