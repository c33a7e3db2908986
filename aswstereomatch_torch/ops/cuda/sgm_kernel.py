"""Semi-global aggregation (``aggregation="sgm"``): wrapper and plain version.

Counterpart of the reference's ``aggregate_sgm`` (``aswstereomatch_tpu/ops/
aggregate.py``), which runs its scans as XLA ``lax.scan``s, not Pallas.  The
kernel is hand-written CUDA (``sgm_kernel.cu``, bound as
``torch.ops.asw_torch.sgm_aggregate`` by ``asw_binding.cpp``, built by
``build.py``): one warp per scanline of one direction, the directions
launched in the pinned order, each adding its L into S.

The recurrence, per path direction r with predecessor q = p - r (pinned in
the reference's config.py):

    L_r(p, d) = (C(p, d) + min(L_r(q, d), L_r(q, d-1) + P1,
                               L_r(q, d+1) + P1, min_d' L_r(q, d') + P2))
                - min_d' L_r(q, d')

with L_r = C where p has no in-image predecessor and out-of-range d+-1
terms +inf.  S sums l2r, r2l, t2b, b2t in that order, then for 8 paths
(1,1), (1,-1), (-1,1), (-1,-1).  Each step is adds and mins only, so the
order of the path sum fixes every bit: the kernel equals the plain version
(and the reference) bit for bit.

On a CUDA tensor ``aggregate`` launches the kernel (and raises if it
cannot); on a CPU tensor it computes the plain version.
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from . import build
from .common import f32

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).  One per aggregated volume.
launches = 0

# The directions in the pinned summation order, as (dy, dx): the step from
# a pixel to the next one on its scanline (the predecessor is p - (dy, dx)).
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def _check(vol: torch.Tensor, cfg: StereoConfig) -> None:
    if vol.dtype != torch.float32 or vol.ndim != 3 or not vol.is_contiguous():
        raise ValueError(
            "sgm aggregation takes a contiguous float32 (H, W, D) cost volume, "
            f"got {vol.dtype} {tuple(vol.shape)}"
        )
    if vol.shape[2] != cfg.max_disparity:
        raise ValueError(
            f"cost volume has {vol.shape[2]} disparities, config says {cfg.max_disparity}"
        )
    if cfg.sgm_paths not in (4, 8):
        raise ValueError("sgm_paths must be 4 or 8")


def _best(ps: torch.Tensor, pmin: torch.Tensor, p1: torch.Tensor,
          p2: torch.Tensor) -> torch.Tensor:
    """min(L(q, d), min(L(q, d-1), L(q, d+1)) + P1, pmin + P2) over the
    previous step's (lines, D) plane ``ps``, +inf past either end of d."""
    inf = torch.full_like(ps[..., :1], float("inf"))
    up = torch.cat([inf, ps[..., :-1]], dim=-1)  # L(q, d-1)
    dn = torch.cat([ps[..., 1:], inf], dim=-1)   # L(q, d+1)
    return torch.minimum(torch.minimum(ps, pmin + p2), torch.minimum(up, dn) + p1)


def _penalties(cfg: StereoConfig, device) -> tuple:
    return (torch.tensor(f32(cfg.sgm_p1), dtype=torch.float32, device=device),
            torch.tensor(f32(cfg.sgm_p2), dtype=torch.float32, device=device))


def _sgm_scan(vol: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """One directional pass along axis 0 of ``vol`` (N, M, D): the
    reference's ``_sgm_scan``, its ``lax.scan`` a Python loop carrying the
    previous step's (M, D) plane.  The first step is C."""
    out = [vol[0]]
    prev = vol[0]
    for i in range(1, vol.shape[0]):
        pmin = torch.amin(prev, dim=-1, keepdim=True)
        prev = (vol[i] + _best(prev, pmin, p1, p2)) - pmin
        out.append(prev)
    return torch.stack(out)


def _sgm_scan_diag(vol2: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   w: int) -> torch.Tensor:
    """The reference's packed diagonal pass along axis 0 of ``vol2`` (N, 2W,
    D): the predecessor shifts +1 column per step for the first W columns
    and -1 for the last W; a column with no in-image predecessor takes
    L = C (its +inf predecessor makes pmin non-finite)."""
    inf = torch.full((1, vol2.shape[-1]), float("inf"), dtype=vol2.dtype, device=vol2.device)
    out = [vol2[0]]
    prev = vol2[0]
    for i in range(1, vol2.shape[0]):
        a = torch.cat([inf, prev[:w][:-1]], dim=0)
        b = torch.cat([prev[w:][1:], inf], dim=0)
        ps = torch.cat([a, b], dim=0)
        pmin = torch.amin(ps, dim=-1, keepdim=True)
        c = vol2[i]
        prev = torch.where(torch.isfinite(pmin), (c + _best(ps, pmin, p1, p2)) - pmin, c)
        out.append(prev)
    return torch.stack(out)


def aggregate_reference(vol: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Plain PyTorch version on any device: the reference's
    ``aggregate_sgm``, line for line (the opposed directions of each axis
    packed into one scan, the path sum in the pinned order)."""
    _check(vol, cfg)
    p1, p2 = _penalties(cfg, vol.device)
    h, w, _ = vol.shape
    volx = vol.transpose(0, 1)  # (W, H, D): scan along x
    sx = _sgm_scan(torch.cat([volx, volx.flip(0)], dim=1), p1, p2)
    l2r = sx[:, :h].transpose(0, 1)
    r2l = sx.flip(0)[:, h:].transpose(0, 1)
    sy = _sgm_scan(torch.cat([vol, vol.flip(0)], dim=1), p1, p2)
    t2b = sy[:, :w]
    b2t = sy.flip(0)[:, w:]
    s = ((l2r + r2l) + t2b) + b2t
    if cfg.sgm_paths == 8:
        dvol = torch.cat([vol, vol], dim=1)
        dt = _sgm_scan_diag(dvol, p1, p2, w)
        db = _sgm_scan_diag(dvol.flip(0), p1, p2, w).flip(0)
        s = (((s + dt[:, :w]) + dt[:, w:]) + db[:, :w]) + db[:, w:]
    return s.to(torch.float32).contiguous()


def aggregate(vol: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Semi-global aggregation of a raw (H, W, D) float32 cost volume:
    the plain version for a CPU tensor, the kernel for a CUDA tensor; any
    other device raises."""
    _check(vol, cfg)
    if vol.device.type == "cpu":
        return aggregate_reference(vol, cfg)
    if vol.device.type != "cuda":
        raise ValueError(f"no kernel for device {vol.device}")
    return _launch(vol, cfg)


def _launch(vol: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    global launches
    build.load()
    out = torch.ops.asw_torch.sgm_aggregate(
        vol, cfg.sgm_paths, f32(cfg.sgm_p1), f32(cfg.sgm_p2))
    launches += 1
    return out
