"""Post-processing in PyTorch: right view by volume reuse, LR check, hole
filling, 3x3 (weighted) median.

Counterpart of ``aswstereomatch_tpu.ops.postprocess``.  The reference
rewrote these gather-free for the TPU; on the GPU a plain ``torch.gather``
is the direct form, and results are the same (pure selection).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import StereoConfig
from . import preprocess


def right_volume(vol: torch.Tensor) -> torch.Tensor:
    """C_R(x', d) = C_L(x' + d, d) by volume reuse; candidates with
    x' + d > W - 1 have no left pixel and are excluded (+inf).  vol: (H, W, D)."""
    h, w, D = vol.shape
    inf_cols = torch.full((h, D - 1, D), float("inf"), dtype=vol.dtype, device=vol.device)
    m = torch.cat([vol, inf_cols], dim=1)  # (H, W + D - 1, D)
    x = torch.arange(w, device=vol.device)[:, None]
    d = torch.arange(D, device=vol.device)[None, :]
    idx = (x + d).expand(h, w, D)
    return torch.gather(m, 1, idx).to(torch.float32)


def lr_check(
    disp_l: torch.Tensor, disp_r: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """Validity mask per the pinned spec: valid iff round(dL) in [0, D),
    x - round(dL) in [0, W), and |dL(x) - dR(x - round(dL))| <= lr_tol."""
    h, w = disp_l.shape
    D = cfg.max_disparity
    dl = disp_l.to(torch.float32)
    dli = torch.round(dl).to(torch.int64)
    xr = torch.arange(w, device=dl.device)[None, :] - dli
    in_range = (xr >= 0) & (xr < w) & (dli >= 0) & (dli < D)
    dr = torch.gather(disp_r.to(torch.float32), 1, xr.clamp(0, w - 1))
    return in_range & (torch.abs(dl - dr) <= cfg.lr_tol)


def fill_holes(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Invalid pixels take min(nearest valid left, nearest valid right).

    Per-row; one-sided at row edges; rows with no valid pixel fill with 0.
    The nearest valid index comes from a running max (left) / min (right)
    of valid column indices, then a gather."""
    dispf = disp.to(torch.float32)
    h, w = dispf.shape
    cols = torch.arange(w, device=dispf.device).expand(h, w)
    left_idx = torch.where(valid, cols, torch.full_like(cols, -1)).cummax(dim=1).values
    right_idx = torch.where(valid, cols, torch.full_like(cols, w))
    right_idx = right_idx.flip(1).cummin(dim=1).values.flip(1)
    inf = torch.tensor(float("inf"), device=dispf.device)
    dl = torch.where(left_idx >= 0, torch.gather(dispf, 1, left_idx.clamp(min=0)), inf)
    dr = torch.where(right_idx < w, torch.gather(dispf, 1, right_idx.clamp(max=w - 1)), inf)
    fill = torch.minimum(dl, dr)
    fill = torch.where(torch.isinf(fill), torch.zeros_like(fill), fill)
    return torch.where(valid, dispf, fill)


def _taps3(arr: torch.Tensor) -> list:
    """The nine 3x3 taps of a 2D (or (H, W, C)) array, replicate border,
    row-major (dy, dx) order."""
    h, w = arr.shape[:2]
    pad = preprocess.pad_edge(preprocess.pad_edge(arr, 0, 1, 1), 1, 1, 1)
    return [pad[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]


def median3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median, replicate border — final smoothing stage."""
    taps = torch.stack(_taps3(disp), dim=-1)
    return torch.sort(taps, dim=-1).values[..., 4].to(torch.float32)


def weighted_median3(
    disp: torch.Tensor, guide_lab: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """Bilateral-guided 3x3 weighted median (config.py pinned spec).

    Weights ``exp(-dLab/gamma_c - |o|/gamma_p)`` from the left image's Lab
    planes; taps sorted ascending by disparity (stable); the output is the
    first value whose cumulative weight reaches half the total.  Each tap's
    cumulative weight is computed directly as a masked sum over the taps
    that precede it in (value, tap index) order — the reference's form, so
    the f32 sums are taken in the same order."""
    vals = _taps3(disp)
    gtaps = _taps3(guide_lab)
    wgts = []
    for i, (dy, dx) in enumerate((dy, dx) for dy in range(3) for dx in range(3)):
        dlab = torch.sqrt(torch.sum((gtaps[i] - guide_lab) ** 2, dim=-1))
        sp = float(np.float32(np.hypot(dy - 1, dx - 1) / cfg.gamma_spatial))
        wgts.append(torch.exp(-dlab / cfg.gamma_color - sp))
    cums = []
    for i in range(9):
        c = None
        for j in range(9):
            # stable order: ties (v_j == v_i) count only for j <= i
            sel = vals[j] <= vals[i] if j <= i else vals[j] < vals[i]
            t = torch.where(sel, wgts[j], torch.zeros_like(wgts[j]))
            c = t if c is None else c + t
        cums.append(c)
    # The lexicographically-maximal tap's cum is the full j-order sum, so
    # max(cums) as the total guarantees at least one tap qualifies.
    half = 0.5 * functools.reduce(torch.maximum, cums)
    out = torch.full_like(disp, float("inf"), dtype=torch.float32)
    for i in range(9):
        out = torch.where(cums[i] >= half, torch.minimum(out, vals[i]), out)
    return out.to(torch.float32)


def median_filter(
    disp: torch.Tensor, cfg: StereoConfig, guide_lab: torch.Tensor | None = None
) -> torch.Tensor:
    """Dispatch to the configured final median variant."""
    if cfg.median_mode == "weighted":
        if guide_lab is None:
            raise ValueError("weighted median needs the left-image Lab guide")
        return weighted_median3(disp, guide_lab, cfg)
    return median3(disp)
