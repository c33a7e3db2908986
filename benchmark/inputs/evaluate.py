"""bad-delta, the share of pixels whose disparity is off by more than delta.

Copied from ``aswstereomatch_torch/utils/evaluate.py`` (``bad_delta``), so
that a change to the program cannot move the benchmark's arithmetic.  The
harness prints each checked pair's bad-2.0 of the reference's map against
the synthetic ground truth, over the pixels that are not occluded.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def bad_delta(
    disp: np.ndarray,
    gt: np.ndarray,
    delta: float = 2.0,
    valid: Optional[np.ndarray] = None,
) -> float:
    """Fraction of valid GT pixels with |disp - gt| > delta, in [0, 1]."""
    disp = np.asarray(disp, dtype=np.float32)
    gt = np.asarray(gt, dtype=np.float32)
    if valid is None:
        valid = np.isfinite(gt)
    n = int(valid.sum())
    if n == 0:
        return float("nan")
    return float((np.abs(disp - gt)[valid] > delta).mean())
