"""Left-only exact ASW or box aggregation + dual-view WTA with the weights
reused across d: wrapper, routing rules and plain version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_dlanes.py``.  The kernel
is hand-written CUDA (``asw_dlanes_kernel.cu``, bound as
``torch.ops.asw_torch.asw_dlanes_wta`` by ``asw_binding.cpp``, built by
``build.py``).  Both entry points return the same dict of (H, W) planes as
``asw_kernel``: bestd, bestc, cm, cp, rbestd, ubest.

Its function is the one K1 (``asw_kernel``) computes for left-only ASW and
box aggregation, so the plain version is K1's (``asw_kernel.
reference_from_stacks``).  On a CUDA tensor the wrapper launches the kernel
(and raises if it cannot); on a CPU tensor it computes that plain version.
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from ...utils.convert import spatial_weights_np
from . import asw_kernel, build
from .common import PLANES, device_table, dispatch, f32, stacks

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).
launches = 0

# The reference kernel's tile width and band extent, which bound its window
# (asw_dlanes.py: TILE_XS + window_size - 1 <= XW).
TILE_XS = 64
XW = 128


def supports(cfg: StereoConfig) -> bool:
    """Left-only ASW, or box, with 2 <= D <= 128 and K <= 65: the reference
    kernel's bounds (asw_dlanes.supports)."""
    if not (2 <= cfg.max_disparity <= 128):
        return False
    if TILE_XS + cfg.window_size - 1 > XW:
        return False
    if cfg.asw_separable:
        return False  # separable ASW belongs to asw_sep_kernel
    if cfg.aggregation == "box":
        return True
    return cfg.aggregation == "asw" and not cfg.asw_symmetric


def routed(cfg: StereoConfig) -> bool:
    """Whether the config goes to this kernel (the reference's
    ``kernel_layout`` rules, asw_dlanes.routed): 'dlanes' takes left-only
    ASW and box, and raises on a geometry the kernel does not support
    (symmetric ASW belongs to ``asw_sym_dlanes_kernel``); 'xlanes' never;
    'auto' takes left-only ASW at any supported geometry and box only for
    D > 64 (below that the reference measured K1 faster)."""
    if cfg.kernel_layout == "dlanes":
        if cfg.aggregation == "asw" and cfg.asw_symmetric:
            return False
        if not supports(cfg):
            raise ValueError(
                "kernel_layout='dlanes' requires left-only ASW or box "
                "aggregation with max_disparity in [2, 128] and "
                "window_size <= 65"
            )
        return True
    if cfg.kernel_layout != "auto":
        return False
    if cfg.aggregation == "box":
        return cfg.max_disparity > 64 and supports(cfg)
    return cfg.aggregation == "asw" and supports(cfg)


def _check(cfg: StereoConfig) -> None:
    if not supports(cfg):
        raise ValueError(
            "the d-lanes kernel requires left-only ASW or box, "
            "max_disparity in [2, 128] and window_size <= 65"
        )


def reference_from_stacks(ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig) -> dict:
    """Plain PyTorch version over pre-extended channel stacks, on any
    device: K1's plain version, which computes the same function."""
    _check(cfg)
    return asw_kernel.reference_from_stacks(ls_ext, rs_ext, cfg)


def wta_outputs_reference(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Plain PyTorch version of the kernel's function, on any device."""
    _check(cfg)
    return reference_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Run the d-lanes kernel over one pair of (H, W[, 3]) float32 images."""
    _check(cfg)
    return wta_outputs_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs_from_stacks(
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig
) -> dict:
    """The d-lanes kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule.
    """
    _check(cfg)
    return dispatch(ls_ext, rs_ext, cfg, reference_from_stacks, _launch)


def _launch(ls_ext, rs_ext, cfg) -> dict:
    global launches
    build.load()
    sw = device_table(spatial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_dlanes_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        sw,
        cfg.window_radius,
        cfg.max_disparity,
        int(cfg.aggregation == "box"),
        int(cfg.cost == "ad"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
    )
    launches += 1
    return dict(zip(PLANES, outs))
