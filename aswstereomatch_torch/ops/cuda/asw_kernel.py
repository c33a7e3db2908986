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
aggregated volume.  ``wta_outputs_reference`` is that plain version on any
device: the tests and chip_smoke.py compare the kernel against it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import StereoConfig
from .. import aggregate, postprocess, preprocess, wta
from ...utils.convert import constant_tables
from . import build

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).
launches = 0


def supports(cfg: StereoConfig) -> bool:
    """The fused kernel covers ASW (both weight modes) and box aggregation,
    for both costs; aggregation='none', SGM and the separable approximation
    are not its function."""
    return cfg.aggregation in ("asw", "box") and not cfg.asw_separable


def _mode(cfg: StereoConfig) -> int:
    """The kernel's Mode (asw_kernel.cu): 0 symmetric ASW, 1 left-only, 2 box."""
    if cfg.aggregation == "box":
        return 2
    return 0 if cfg.asw_symmetric else 1


def _stacks(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig):
    """Edge-extended channel stacks: (7, H, W + 2r) and (7, H, W + 2r + D - 1)."""
    r = cfg.window_radius
    D = cfg.max_disparity
    ls_ext = preprocess.pad_edge(preprocess.channel_stack(left), 2, r, r)
    rs_ext = preprocess.pad_edge(preprocess.channel_stack(right), 2, r + D - 1, r)
    return ls_ext, rs_ext


def _plain_from_stacks(ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig) -> dict:
    """The kernel's function in plain PyTorch, from the materialized
    aggregated volume (the forms ``aggregate.aggregated_volume`` uses)."""
    if cfg.aggregation == "box":
        vol = aggregate.aggregate_box(aggregate.cost_volume_from_stacks(ls_ext, rs_ext, cfg), cfg)
    else:
        vol = aggregate.aggregate_asw_from_stacks(ls_ext, rs_ext, cfg)
    out = wta.wta_with_triple(vol)
    out["rbestd"] = wta.wta(postprocess.right_volume(vol))
    out["ubest"] = wta.second_best_excl_neighbors(vol, out["bestd"])
    return out


def _check(cfg: StereoConfig) -> None:
    if not supports(cfg):
        raise ValueError("the fused kernel requires aggregation 'asw' or 'box'")


def wta_outputs_reference(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> dict:
    """Plain PyTorch version of the kernel's function, on any device."""
    _check(cfg)
    return _plain_from_stacks(*_stacks(left, right, cfg), cfg)


def wta_outputs(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Run the fused kernel over one pair of (H, W[, 3]) float32 images."""
    _check(cfg)
    return wta_outputs_from_stacks(*_stacks(left, right, cfg), cfg)


def wta_outputs_from_stacks(
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig
) -> dict:
    """Fused kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule.
    """
    _check(cfg)
    if ls_ext.device.type == "cpu":
        return _plain_from_stacks(ls_ext, rs_ext, cfg)
    if ls_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {ls_ext.device}")
    return _launch(ls_ext, rs_ext, cfg)


def _f32(v: float) -> float:
    """A kernel constant, rounded to float32 as the Pallas kernel rounds it."""
    return float(np.float32(v))


def _launch(ls_ext, rs_ext, cfg) -> dict:
    global launches
    build.load()
    sw = constant_tables(cfg, ls_ext.device)["spatial_weights"]
    bestd, bestc, cm, cp, ubest, rbestd = torch.ops.asw_torch.asw_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        sw,
        cfg.window_radius,
        cfg.max_disparity,
        _mode(cfg),
        int(cfg.cost == "ad"),
        _f32(cfg.alpha),
        _f32(1.0 - cfg.alpha),
        _f32(cfg.tau_color),
        _f32(cfg.tau_grad),
        _f32(1.0 / cfg.gamma_color),
    )
    launches += 1
    return {
        "bestd": bestd, "bestc": bestc, "cm": cm, "cp": cp,
        "ubest": ubest, "rbestd": rbestd,
    }
