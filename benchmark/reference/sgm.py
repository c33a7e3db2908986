"""Semi-global matching (Hirschmueller, TPAMI 2008) of the whole image: the
plain float32 reference of ``aggregation="sgm"``.

A frozen copy of the program's SGM mathematics:

  - the raw cost: ``aswstereomatch_torch/ops/cost.py::cost_volume`` at
    ``x_extend=0``, here ``plain.cost_plane`` over the stacks it is handed
    with their halo rows and columns cropped;
  - the paths: ``aswstereomatch_torch/ops/cuda/sgm_kernel.py``'s
    ``aggregate_reference`` (with ``_sgm_scan``, ``_sgm_scan_diag`` and
    ``_best``), per direction r with predecessor q = p - r:

        L_r(p, d) = C(p, d) + min(L_r(q, d), L_r(q, d - 1) + P1,
                                  L_r(q, d + 1) + P1, min_d' L_r(q, d') + P2)
                    - min_d' L_r(q, d')

    with L_r = C where p has no in-image predecessor and the d - 1, d + 1
    terms +inf past either end of d.  S sums l2r, r2l, t2b, b2t in that
    order, then for 8 paths the diagonals (1, 1), (1, -1), (-1, 1),
    (-1, -1).  Each step is adds and mins only, so that order fixes every
    bit.

The vertical and diagonal paths run across every row, so the module takes
the whole image as one block (``WHOLE_IMAGE``).  ``precision="tf32"``
rounds the operands of every step, C and the previous step's L, to TF32.
"""

from __future__ import annotations

import torch

from . import plain

WHOLE_IMAGE = True
PATHS = (4, 8)


def cost_volume(ls: torch.Tensor, rs: torch.Tensor, cfg) -> torch.Tensor:
    """The raw (H, W, D) cost on [0, H) x [0, W) x [0, D) of the image's
    stacks ``ls`` (7, H + 2r, W + 2r) and ``rs`` (7, H + 2r, W + 2r + D - 1),
    which carry r halo rows and columns."""
    r, D = cfg.window_radius, cfg.max_disparity
    h, w = ls.shape[1] - 2 * r, ls.shape[2] - 2 * r
    ls = ls[:, r: r + h, r: r + w]
    rs = rs[:, r: r + h, r: r + w + D - 1]
    return torch.stack([plain.cost_plane(ls, rs, d, cfg) for d in range(D)], dim=-1)


def _best(ps: torch.Tensor, pmin: torch.Tensor, p1: torch.Tensor,
          p2: torch.Tensor) -> torch.Tensor:
    """min(L(q, d), min(L(q, d-1), L(q, d+1)) + P1, pmin + P2) over the
    previous step's (lines, D) plane ``ps``, +inf past either end of d."""
    inf = torch.full_like(ps[..., :1], float("inf"))
    up = torch.cat([inf, ps[..., :-1]], dim=-1)
    dn = torch.cat([ps[..., 1:], inf], dim=-1)
    return torch.minimum(torch.minimum(ps, pmin + p2), torch.minimum(up, dn) + p1)


def _scan(vol: torch.Tensor, p1, p2, op) -> torch.Tensor:
    """One pass along axis 0 of ``vol`` (N, M, D), carrying the previous
    step's (M, D) plane; the first step is C."""
    out = [vol[0]]
    prev = vol[0]
    for i in range(1, vol.shape[0]):
        q = op(prev)
        pmin = torch.amin(q, dim=-1, keepdim=True)
        prev = (vol[i] + _best(q, pmin, p1, p2)) - pmin
        out.append(prev)
    return torch.stack(out)


def _scan_diag(vol2: torch.Tensor, p1, p2, w: int, op) -> torch.Tensor:
    """The packed diagonal pass along axis 0 of ``vol2`` (N, 2W, D): the
    predecessor shifts +1 column per step for the first W columns and -1
    for the last W; a column with no in-image predecessor takes L = C (its
    +inf predecessor makes pmin non-finite)."""
    inf = torch.full((1, vol2.shape[-1]), float("inf"), dtype=vol2.dtype, device=vol2.device)
    out = [vol2[0]]
    prev = vol2[0]
    for i in range(1, vol2.shape[0]):
        q = op(prev)
        ps = torch.cat([inf, q[:w][:-1], q[w:][1:], inf], dim=0)
        pmin = torch.amin(ps, dim=-1, keepdim=True)
        c = vol2[i]
        prev = torch.where(torch.isfinite(pmin), (c + _best(ps, pmin, p1, p2)) - pmin, c)
        out.append(prev)
    return torch.stack(out)


def aggregate(vol: torch.Tensor, cfg, precision: str = "float32") -> torch.Tensor:
    """S of a raw (H, W, D) cost volume over ``cfg.sgm_paths`` paths, the
    opposed directions of each axis packed into one scan."""
    if cfg.sgm_paths not in PATHS:
        raise ValueError(f"the plain reference computes SGM over {PATHS} paths only")
    op = plain.tf32 if precision == "tf32" else (lambda t: t)
    vol = op(vol)
    p1 = torch.tensor(cfg.sgm_p1, dtype=torch.float32, device=vol.device)
    p2 = torch.tensor(cfg.sgm_p2, dtype=torch.float32, device=vol.device)
    h, w, _ = vol.shape
    volx = vol.transpose(0, 1)  # (W, H, D): scan along x
    sx = _scan(torch.cat([volx, volx.flip(0)], dim=1), p1, p2, op)
    l2r = sx[:, :h].transpose(0, 1)
    r2l = sx.flip(0)[:, h:].transpose(0, 1)
    sy = _scan(torch.cat([vol, vol.flip(0)], dim=1), p1, p2, op)
    s = ((l2r + r2l) + sy[:, :w]) + sy.flip(0)[:, w:]
    del sy, l2r, r2l
    if cfg.sgm_paths == 8:
        dvol = torch.cat([vol, vol], dim=1)
        dt = _scan_diag(dvol, p1, p2, w, op)
        db = _scan_diag(dvol.flip(0), p1, p2, w, op).flip(0)
        s = (((s + dt[:, :w]) + dt[:, w:]) + db[:, :w]) + db[:, w:]
    return s.to(torch.float32).contiguous()


def aggregate_block(ls: torch.Tensor, rs: torch.Tensor, cfg, precision: str) -> torch.Tensor:
    """(H, W, D) aggregated volume of the whole image: ``ls`` (7, H + 2r,
    W + 2r) and ``rs`` (7, H + 2r, W + 2r + D - 1), every row with r halo
    rows."""
    return aggregate(cost_volume(ls, rs, cfg), cfg, precision)
