"""Fused cost + exact ASW/box aggregation + dual-view WTA: wrapper and plain
version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_kernel.py``.  The kernel
is hand-written CUDA (``asw_kernel.cu``, bound as
``torch.ops.asw_torch.asw_wta`` by ``asw_binding.cpp``, built by
``build.py``).  Both entry points return the same dict of (H, W) planes:

  bestd, bestc, cm, cp — left-view integer WTA + parabola triple
  rbestd               — right-view WTA (volume reuse), for the LR check
  ubest                — second-best cost excluding bestd +- 1

On a CUDA tensor the wrapper launches the kernel (and raises if it cannot);
on a CPU tensor it computes the plain PyTorch version from the materialized
aggregated volume.  ``wta_outputs_reference`` (``reference_from_stacks``
over pre-extended stacks) is that plain version on any device: the tests
and chip_smoke.py compare the kernel against it.
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from .. import aggregate
from ...utils.convert import spatial_weights_np
from . import build
from .common import PLANES, device_table, dispatch, f32, stacks, wta_planes

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).
launches = 0


def supports(cfg: StereoConfig) -> bool:
    """The fused kernel covers exact ASW (both weight modes) and box
    aggregation, for both costs; aggregation='none' and SGM are not its
    function, and the separable approximation is ``asw_sep_kernel``'s."""
    return cfg.aggregation in ("asw", "box") and not cfg.asw_separable


def _mode(cfg: StereoConfig) -> int:
    """The kernel's Mode (asw_kernel.cu): 0 symmetric ASW, 1 left-only, 2 box."""
    if cfg.aggregation == "box":
        return 2
    return 0 if cfg.asw_symmetric else 1


def reference_from_stacks(ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig) -> dict:
    """The kernel's function in plain PyTorch over pre-extended channel
    stacks, on any device, from the materialized aggregated volume (the
    forms ``aggregate.aggregated_volume`` uses)."""
    _check(cfg)
    if cfg.aggregation == "box":
        vol = aggregate.aggregate_box(aggregate.cost_volume_from_stacks(ls_ext, rs_ext, cfg), cfg)
    else:
        vol = aggregate.aggregate_asw_from_stacks(ls_ext, rs_ext, cfg)
    return wta_planes(vol)


def _check(cfg: StereoConfig) -> None:
    if not supports(cfg):
        raise ValueError(
            "the fused kernel requires exact aggregation 'asw' or 'box' "
            "(separable ASW is asw_sep_kernel's)"
        )


def wta_outputs_reference(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> dict:
    """Plain PyTorch version of the kernel's function, on any device."""
    _check(cfg)
    return reference_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Run the fused kernel over one pair of (H, W[, 3]) float32 images."""
    _check(cfg)
    return wta_outputs_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs_from_stacks(
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig
) -> dict:
    """Fused kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule.
    """
    _check(cfg)
    return dispatch(ls_ext, rs_ext, cfg, reference_from_stacks, _launch)


def _launch(ls_ext, rs_ext, cfg) -> dict:
    global launches
    build.load()
    sw = device_table(spatial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        sw,
        cfg.window_radius,
        cfg.max_disparity,
        _mode(cfg),
        int(cfg.cost == "ad"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
    )
    launches += 1
    return dict(zip(PLANES, outs))
