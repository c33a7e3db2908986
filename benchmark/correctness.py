"""The comparison that decides ``correct``: a sample of the window's answers,
drawn from the run's seed, against the plain reference
(``benchmark/reference/``).

Each answer is drawn for the check with probability ``RATE``, per client
from the seed (``Sample``).  A drawn answer equal, bit for bit, to one
already kept for its input pair counts against that one and is let go at
once, so the window holds a few maps (a new map held per drawn answer would
make the next answers' host copies fault in fresh pages).  After the window
each kept variant is compared with the reference's float32 map of its
pair.

The numbers are shares of a map's pixels whose answer lies farther from
the reference's disparity than the answer form's own rounding allows, plus
a margin: ``share_off_<margin>`` is the share with
|answer - reference| > half_step(form) + margin, where the half step is 0
for a "float32" answer and 1/512 px for a "uint16_x256" one (1/256 px
steps, rounded to nearest).  An answer rounded from a value within the
margin of the reference never counts.  The configuration's file gives each
compared number's limit for each answer form.
"""

from __future__ import annotations

import threading

import numpy as np

RATE = 0.25  # the share of the window's answers kept for the check

HALF_STEP = {"float32": 0.0, "uint16_x256": 1.0 / 512.0}

# The numbers every run prints, so that limits can be set from readings;
# only those with a limit in the configuration's file decide ``correct``.
MARGINS = (0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.5)
READINGS = tuple(f"share_off_{m:g}" for m in MARGINS) + ("q0.999_abs_px",)


class Sample:
    """The answers kept for the check, each with probability ``RATE``: one
    stream of draws per client, from the run's seed."""

    def __init__(self, seed: int):
        self.seed = seed & (2**64 - 1)
        self.drawn = 0
        self.variants: dict = {}  # input pair -> its distinct drawn answers
        self._lock = threading.Lock()

    def drawer(self, client: int):
        rng = np.random.default_rng([self.seed, client])
        return lambda: rng.random() < RATE

    def keep(self, request, answer: np.ndarray) -> None:
        """Count a drawn answer: set ``request.variant`` to its index among
        its pair's distinct answers, keeping it where it is new."""
        with self._lock:
            self.drawn += 1
            kept = self.variants.setdefault(request.key, [])
            for i, v in enumerate(kept):
                if np.array_equal(v, answer):
                    request.variant = i
                    return
            kept.append(answer)
            request.variant = len(kept) - 1


def readings(answer: np.ndarray, ref: np.ndarray, form: str) -> dict:
    """Each of ``READINGS`` for one answer of ``form`` (decoded to float32
    disparities) against the reference's float32 map.  A map of another
    shape or with non-finite values reads 1.0 on every share."""
    if answer.shape != ref.shape or not np.isfinite(answer).all():
        return {name: (1.0 if name.startswith("share") else float("inf")) for name in READINGS}
    diff = np.abs(answer.astype(np.float64) - ref.astype(np.float64)).ravel()
    out = {f"share_off_{m:g}": float(np.mean(diff > HALF_STEP[form] + m)) for m in MARGINS}
    out["q0.999_abs_px"] = float(np.quantile(diff, 0.999))
    return out


def judge(readings_by_answer: dict, limits: dict) -> tuple:
    """``(checks, bad)``: each limited number's worst reading over the
    answers beside its limit, and the keys of the answers over a limit."""
    checks, bad = {}, set()
    for name, limit in limits.items():
        worst = max((r[name] for r in readings_by_answer.values()), default=0.0)
        checks[name] = {"value": worst, "limit": limit}
        bad |= {k for k, r in readings_by_answer.items() if r[name] > limit}
    return checks, bad
