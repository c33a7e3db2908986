"""Separable two-pass ASW aggregation of one block of rows: the plain
float32 reference of ``asw_separable=True``.

A frozen copy of ``aswstereomatch_torch/ops/aggregate.py``'s
``aggregate_asw_separable_from_stacks`` (with ``_bilateral_1d`` and the
fixed pairwise ``_tap_sum``), taking a block of rows with its halo:

    numv[y, u, d] = sum_dy wvL(y, u; dy) wvR(y, u-d; dy) C[y+dy-r, u, d]
    num [y, x, d] = sum_dx whL(y, x; dx) whR(y, x-d; dx) numv[y, x+dx-r, d]

and the denominators the same sums without C; the right factors only in
symmetric mode.
"""

from __future__ import annotations

import torch

from . import plain


def _tap_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis as a fixed pairwise tree of elementwise adds."""
    k = x.shape[-1]
    while k > 1:
        half = k // 2
        acc = x[..., :half] + x[..., half: 2 * half]
        if k % 2:
            acc[..., :1] += x[..., 2 * half:]
        x, k = acc, half
    return x[..., 0]


def _bilateral_1d(lab: torch.Tensor, cfg, axis: str) -> torch.Tensor:
    """1-D weights w(p, p + o e_axis) of a Lab block.  "y": ``lab`` holds
    r halo rows above and below, -> (h, W', K).  "x": ``lab`` is extended
    by r columns per side, -> (h, W' - 2r, K)."""
    r = cfg.window_radius
    k = 2 * r + 1
    if axis == "y":
        taps = [lab[..., c].unfold(0, k, 1) for c in range(3)]
        center = lab[r: lab.shape[0] - r]
    else:
        taps = [lab[..., c].unfold(1, k, 1) for c in range(3)]
        center = lab[:, r: lab.shape[1] - r]
    d2 = None
    for c in range(3):
        diff = taps[c] - center[..., c: c + 1]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    aw = torch.from_numpy(plain.axial_weights(cfg)).to(lab.device)
    return (torch.exp(-torch.sqrt(d2) / cfg.gamma_color) * aw).to(torch.float32)


def aggregate_block(ls: torch.Tensor, rs: torch.Tensor, cfg, precision: str) -> torch.Tensor:
    """(h, W, D) aggregated volume of a block: ``ls`` (7, h + 2r, W + 2r) and
    ``rs`` (7, h + 2r, W + 2r + D - 1), the block's rows with r halo rows."""
    r, D = cfg.window_radius, cfg.max_disparity
    k = 2 * r + 1
    h, we = ls.shape[1] - 2 * r, ls.shape[2]
    op = plain.tf32 if precision == "tf32" else (lambda t: t)
    lab_l = torch.movedim(ls[4:7], 0, -1)
    wvl = _bilateral_1d(lab_l, cfg, "y")
    whl = _bilateral_1d(plain.pad_edge(lab_l[r: r + h], 1, r, r), cfg, "x")[:, r: we - r]
    if cfg.asw_symmetric:
        lab_r = torch.movedim(rs[4:7], 0, -1)
        wvr = _bilateral_1d(lab_r, cfg, "y")
        whr = _bilateral_1d(plain.pad_edge(lab_r[r: r + h], 1, r, r), cfg, "x")
    out = []
    for d in range(D):
        plane = plain.cost_plane(ls, rs, d, cfg)
        start = (D - 1) - d
        wv, wh = wvl, whl
        if cfg.asw_symmetric:
            wv = wv * wvr[:, start: start + we]
            wh = wh * whr[:, start + r: start + we - r]
        wv, wh = op(wv), op(wh)
        numv = _tap_sum(wv * op(plane.unfold(0, k, 1)))
        denv = _tap_sum(wv)
        num = _tap_sum(wh * op(numv.unfold(1, k, 1)))
        den = _tap_sum(wh * op(denv.unfold(1, k, 1)))
        out.append((num / den).to(torch.float32))
    return torch.stack(out, dim=-1)
