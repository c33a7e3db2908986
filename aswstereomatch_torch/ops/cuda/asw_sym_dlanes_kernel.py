"""Symmetric exact ASW + dual-view WTA with the right weights reused across
d: wrapper, routing rules and plain version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_sym_dlanes.py``.  The
kernel is hand-written CUDA (``asw_sym_dlanes_kernel.cu``, bound as
``torch.ops.asw_torch.asw_sym_dlanes_wta`` by ``asw_binding.cpp``, built by
``build.py``).  Both entry points return the same dict of (H, W) planes as
``asw_kernel``: bestd, bestc, cm, cp, rbestd, ubest.

Its function is K1's symmetric mode, so the plain version is K1's
(``asw_kernel.reference_from_stacks``).  On a CUDA tensor the wrapper
launches the kernel (and raises if it cannot); on a CPU tensor it computes
that plain version.  The kernel is opt-in (``kernel_layout="dlanes"``), as
in the reference.
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

# The reference kernel's tile width: its strided lane roll bounds the
# window to window_size + TILE_XS - 1 < 128 (asw_sym_dlanes.supports).
TILE_XS = 64


def supports(cfg: StereoConfig) -> bool:
    """Symmetric exact ASW with 2 <= D <= 128 and K <= 63: the reference
    kernel's bounds (asw_sym_dlanes.supports)."""
    return (
        cfg.aggregation == "asw"
        and cfg.asw_symmetric
        and not cfg.asw_separable
        and 2 <= cfg.max_disparity <= 128
        and cfg.window_size + TILE_XS - 1 < 128
    )


def routed(cfg: StereoConfig) -> bool:
    """Whether the config goes to this kernel (asw_sym_dlanes.routed): only
    on an explicit kernel_layout='dlanes' pin, for symmetric ASW, which
    raises on a geometry the kernel does not support; left-only ASW and box
    belong to ``asw_dlanes_kernel``."""
    if cfg.kernel_layout == "dlanes":
        if cfg.aggregation == "asw" and cfg.asw_symmetric:
            if not supports(cfg):
                raise ValueError(
                    "kernel_layout='dlanes' on symmetric ASW requires "
                    "max_disparity in [2, 128] and window_size <= 63"
                )
            return True
        return False
    return False


def _check(cfg: StereoConfig) -> None:
    if not supports(cfg):
        raise ValueError(
            "the symmetric d-lanes kernel requires exact symmetric ASW, "
            "max_disparity in [2, 128] and window_size <= 63"
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
    """Run the symmetric d-lanes kernel over one pair of (H, W[, 3]) float32
    images."""
    _check(cfg)
    return wta_outputs_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs_from_stacks(
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig
) -> dict:
    """The symmetric d-lanes kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule.
    """
    _check(cfg)
    return dispatch(ls_ext, rs_ext, cfg, reference_from_stacks, _launch)


def _launch(ls_ext, rs_ext, cfg) -> dict:
    global launches
    build.load()
    sw = device_table(spatial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_sym_dlanes_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        sw,
        cfg.window_radius,
        cfg.max_disparity,
        int(cfg.cost == "ad"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
    )
    launches += 1
    return dict(zip(PLANES, outs))
