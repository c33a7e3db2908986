"""Faults planted in the timed path, for the tests that see ``correct`` come
out false: each replaces ``StereoMatcher.__call__`` with a broken one.

  - "altered": an answer altered where it is produced: the top eighth of
    the rows off by one pixel;
  - "stale": the state not updated: each answer is the previous call's;
  - "half": half of the pair left out: the lower half of the rows zero.
"""

from __future__ import annotations

FAULTS = ("altered", "stale", "half")


def broken_call(name: str, original):
    """``original`` (``StereoMatcher.__call__``) with fault ``name``."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    previous: list = []

    def call(self, left, right):
        disp = original(self, left, right).clone()
        h = disp.shape[0]
        if name == "altered":
            disp[: max(1, h // 8)] += 1.0
        elif name == "half":
            disp[h // 2:] = 0.0
        else:
            answer = previous[0] if previous else disp
            previous[:] = [disp]
            disp = answer
        return disp

    return call


def plant(name: str) -> None:
    """Plant fault ``name`` in this process's ``StereoMatcher``."""
    from aswstereomatch_torch.models import pipeline

    pipeline.StereoMatcher.__call__ = broken_call(name, pipeline.StereoMatcher.__call__)
