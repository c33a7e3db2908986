"""Disparity-map evaluation: bad-delta pixel-error rates and deltas.

A NumPy copy of ``aswstereomatch_tpu.utils.evaluate`` (that package cannot
be imported without jax): ``bad = mean(|disp - gt| > delta)`` over valid GT
pixels, and the same metric between two implementations' maps.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def bad_report(
    disp: np.ndarray,
    gt: np.ndarray,
    valid: Optional[np.ndarray] = None,
    deltas: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
) -> Dict[str, float]:
    """bad-delta at several thresholds plus end-point error statistics."""
    out = {f"bad_{d:g}": bad_delta(disp, gt, d, valid) for d in deltas}
    disp = np.asarray(disp, dtype=np.float32)
    gt = np.asarray(gt, dtype=np.float32)
    if valid is None:
        valid = np.isfinite(gt)
    err = np.abs(disp - gt)[valid]
    out["epe"] = float(err.mean()) if err.size else float("nan")
    out["density"] = float(np.isfinite(disp).mean())
    return out


def bad_delta_between(
    disp_a: np.ndarray,
    disp_b: np.ndarray,
    delta: float = 2.0,
    valid: Optional[np.ndarray] = None,
) -> float:
    """bad-2.0-style disagreement between two implementations' maps."""
    return bad_delta(disp_a, disp_b, delta, valid)


def exact_match_rate(disp_a: np.ndarray, disp_b: np.ndarray) -> float:
    """Fraction of pixels where two maps agree exactly (f32 bit-equality)."""
    a = np.asarray(disp_a, dtype=np.float32)
    b = np.asarray(disp_b, dtype=np.float32)
    return float((a == b).mean())
