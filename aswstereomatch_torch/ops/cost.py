"""Cost-volume construction in PyTorch.

Counterpart of ``aswstereomatch_tpu.ops.cost``.  Per the pinned spec
(config.py, virtual padded-plane semantics):
  AD:        C(x, d) = mean_c |Lp_c(x) - Rp_c(x - d)|
  TAD+grad:  C = alpha * min(AD, tau1) + (1-alpha) * min(|gLp - gRp(x-d)|, tau2)
defined on the x-extended domain x in [-rx, W-1+rx] that aggregation taps,
where Lp/Rp are the edge-padded virtual planes (Rp by rx + D - 1 on the left).

``cost_volume`` materializes the whole volume: for CPU tensors by the plain
loop over d (``cuda/cost_kernel.py::reference``), for CUDA tensors in one
launch of the hand-written kernel (``cuda/cost_kernel.cu``), which raises if
it cannot take the planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import StereoConfig
from . import preprocess
from .cuda import cost_kernel

# Materialized raw volumes since the last reset (``cost_volume`` calls), beside
# the kernels' ``launches`` counters.
volumes = 0


class CostPlanes(NamedTuple):
    lc: torch.Tensor   # (H, W + 2*rx, C) left color, edge-padded by rx
    rc: torch.Tensor   # (H, W + 2*rx + D - 1, C) right color, padded rx+D-1 / rx
    gl: torch.Tensor   # (H, W + 2*rx) left x-gradient, same padding as lc
    gr: torch.Tensor   # like rc for the right x-gradient
    x_extend: int


def _pad_x(arr: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return preprocess.pad_edge(arr, 1, left, right)


def _as_chw(img: torch.Tensor) -> torch.Tensor:
    if img.ndim == 2:
        img = img[..., None]
    return img.to(torch.float32)


def precompute(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig, x_extend: int = 0
) -> CostPlanes:
    """Edge-padded per-pair planes shared across disparities."""
    D = cfg.max_disparity
    lc = _pad_x(_as_chw(left), x_extend, x_extend)
    rc = _pad_x(_as_chw(right), x_extend + D - 1, x_extend)
    gl = _pad_x(preprocess.x_gradient(preprocess.rgb_to_gray(left)), x_extend, x_extend)
    gr = _pad_x(
        preprocess.x_gradient(preprocess.rgb_to_gray(right)), x_extend + D - 1, x_extend
    )
    return CostPlanes(lc, rc, gl, gr, x_extend)


def planes_from_stacks(
    l_stack: torch.Tensor, r_stack: torch.Tensor, x_extend: int
) -> CostPlanes:
    """CostPlanes from pre-extended (7, H, W') channel stacks: l_stack covers
    the cost domain [-x_extend, W-1+x_extend]; r_stack has D-1 more left
    columns."""
    def chw(stack):
        return torch.movedim(stack[0:3], 0, -1)

    return CostPlanes(chw(l_stack), chw(r_stack), l_stack[3], r_stack[3], x_extend)


def cost_plane(planes: CostPlanes, d: int, cfg: StereoConfig) -> torch.Tensor:
    """(H, W + 2*x_extend) raw cost for disparity d."""
    D = cfg.max_disparity
    we = planes.gl.shape[1]
    start = (D - 1) - d
    rs = planes.rc[:, start : start + we]
    ad = torch.abs(planes.lc - rs).mean(dim=-1)
    if cfg.cost == "ad":
        return ad.to(torch.float32)
    gs = planes.gr[:, start : start + we]
    out = cfg.alpha * torch.clamp(ad, max=cfg.tau_color) + (
        1.0 - cfg.alpha
    ) * torch.clamp(torch.abs(planes.gl - gs), max=cfg.tau_grad)
    return out.to(torch.float32)


def cost_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig, x_extend: int = 0
) -> torch.Tensor:
    """Materialized (H, W + 2*x_extend, D) raw cost volume: the plain loop
    for CPU tensors, the cost kernel for any other."""
    global volumes
    volumes += 1
    planes = precompute(left, right, cfg, x_extend)
    if planes.lc.device.type == "cpu":
        return cost_kernel.reference(planes, cfg)
    return cost_kernel.cost_volume(planes, cfg)
