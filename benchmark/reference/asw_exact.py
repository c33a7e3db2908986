"""Exact Yoon-Kweon adaptive-support-weight aggregation (TPAMI 2006) of one
block of rows: the plain float32 reference of ``aggregation="asw"``.

A frozen copy of ``aswstereomatch_torch/ops/aggregate.py``'s
``aggregate_asw_from_stacks`` (with ``bilateral_planes_from_lab``,
``_patches_2d`` and ``_window_sum``), taking a block of rows with its halo
instead of the whole image: the left weight planes are built once per
block, the right ones on the x-extended right domain, and step d reads the
right window starting at (D-1) - d.  Each (pixel, d) sums its (2r+1)^2 taps
as 2r+1 rows of dx taps, then over dy.
"""

from __future__ import annotations

import torch

from . import plain


def _patches(arr: torch.Tensor, k: int) -> torch.Tensor:
    """(h + k - 1, w + k - 1) -> (h, w, k * k) window taps in (dy, dx) order."""
    h, w = arr.shape[0] - k + 1, arr.shape[1] - k + 1
    return arr.unfold(0, k, 1).unfold(1, k, 1).reshape(h, w, k * k)


def _window_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    if k * k < 128:
        return x.sum(dim=-1)
    return x.unflatten(-1, (k, k)).sum(dim=-1).sum(dim=-1)


def _weights(lab: torch.Tensor, cfg) -> torch.Tensor:
    """w(p, p + o) = exp(-dLab / gamma_c) * exp(-|o|_2 / gamma_p) for the
    centers of a (h + 2r, We + 2r, 3) Lab block -> (h, We, K * K)."""
    r = cfg.window_radius
    k = 2 * r + 1
    d2 = None
    for c in range(3):
        diff = _patches(lab[..., c], k) - lab[r: lab.shape[0] - r, r: lab.shape[1] - r, c: c + 1]
        d2 = diff * diff if d2 is None else d2 + diff * diff
        del diff
    sw = torch.from_numpy(plain.spatial_weights(cfg).reshape(-1)).to(lab.device)
    d2.sqrt_().neg_().div_(cfg.gamma_color).exp_().mul_(sw)
    return d2.to(torch.float32)


def aggregate_block(ls: torch.Tensor, rs: torch.Tensor, cfg, precision: str) -> torch.Tensor:
    """(h, W, D) aggregated volume of a block: ``ls`` (7, h + 2r, W + 2r) and
    ``rs`` (7, h + 2r, W + 2r + D - 1), the block's rows with r halo rows."""
    r, D = cfg.window_radius, cfg.max_disparity
    k = 2 * r + 1
    w = ls.shape[2] - 2 * r
    wl = _weights(torch.movedim(ls[4:7], 0, -1), cfg)
    if cfg.asw_symmetric:
        wr = _weights(torch.movedim(rs[4:7], 0, -1), cfg)
    else:
        wl_op = plain.tf32(wl) if precision == "tf32" else wl
        den_left = _window_sum(wl_op, k)
    out = []
    for d in range(D):
        taps = _patches(plain.cost_plane(ls, rs, d, cfg), k)
        if cfg.asw_symmetric:
            start = (D - 1) - d
            wgt = wl * wr[:, start: start + w]
            if precision == "tf32":
                wgt, taps = plain.tf32(wgt), plain.tf32(taps)
            num = _window_sum(taps.mul_(wgt), k)
            den = _window_sum(wgt, k)
            del wgt
        else:
            if precision == "tf32":
                taps = plain.tf32(taps)
            num = _window_sum(taps.mul_(wl_op), k)
            den = den_left
        del taps
        out.append((num / den).to(torch.float32))
    return torch.stack(out, dim=-1)
