"""Separable two-pass ASW + dual-view WTA: wrapper and plain version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_sep_dlanes.py``.  The
kernel is hand-written CUDA (``asw_sep_kernel.cu``, bound as
``torch.ops.asw_torch.asw_sep_wta`` by ``asw_binding.cpp``, built by
``build.py``).  Both entry points return the same dict of (H, W) planes as
``asw_kernel``: bestd, bestc, cm, cp, rbestd, ubest.

On a CUDA tensor the wrapper launches the kernel (and raises if it cannot);
on a CPU tensor it computes the plain PyTorch version from the materialized
aggregated volume (``aggregate.aggregate_asw_separable_from_stacks``).
``wta_outputs_reference`` (``reference_from_stacks`` over pre-extended
stacks) is that plain version on any device: the tests and chip_smoke.py
compare the kernel against it.  With
``volume_dtype="bfloat16"`` both round each raw cost to bfloat16 and back
before aggregation; accumulation stays float32.
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from .. import aggregate
from ...utils.convert import axial_weights_np
from . import build
from .common import PLANES, device_table, dispatch, f32, stacks, wta_planes

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).
launches = 0


def supports(cfg: StereoConfig) -> bool:
    """Separable ASW (either weight mode) with 2 <= D <= 128 and r <= 32
    (K <= 65): the reference kernel's bounds (asw_sep_dlanes.supports)."""
    return (
        cfg.aggregation == "asw"
        and cfg.asw_separable
        and 2 <= cfg.max_disparity <= 128
        and cfg.window_radius <= 32
    )


def routed(cfg: StereoConfig) -> bool:
    """Whether the config goes to this kernel (the reference's
    ``kernel_layout`` rules): never for exact configs or an explicit
    'xlanes' pin (no such kernel exists for this mode; the eager path serves
    it); 'dlanes' on an unsupported geometry raises; 'auto' takes every
    supported geometry."""
    if not cfg.asw_separable:
        return False
    if cfg.kernel_layout == "dlanes":
        if not supports(cfg):
            raise ValueError(
                "kernel_layout='dlanes' on separable ASW requires "
                "max_disparity in [2, 128] and window_size <= 65"
            )
        return True
    if cfg.kernel_layout == "xlanes":
        return False
    return supports(cfg)


def _check(cfg: StereoConfig) -> None:
    if not supports(cfg):
        raise ValueError(
            "the separable kernel requires asw_separable with "
            "max_disparity in [2, 128] and window_size <= 65"
        )


def reference_from_stacks(ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig) -> dict:
    """Plain PyTorch version over pre-extended channel stacks, on any
    device: the materialized separable volume and ``wta_planes``."""
    _check(cfg)
    storage = torch.bfloat16 if cfg.volume_dtype == "bfloat16" else None
    vol = aggregate.aggregate_asw_separable_from_stacks(
        ls_ext, rs_ext, cfg, storage_dtype=storage)
    return wta_planes(vol)


def wta_outputs_reference(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Plain PyTorch version of the kernel's function, on any device."""
    _check(cfg)
    return reference_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Run the separable kernel over one pair of (H, W[, 3]) float32 images."""
    _check(cfg)
    return wta_outputs_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs_from_stacks(
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig
) -> dict:
    """Separable kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule.
    """
    _check(cfg)
    return dispatch(ls_ext, rs_ext, cfg, reference_from_stacks, _launch)


def _launch(ls_ext, rs_ext, cfg) -> dict:
    global launches
    build.load()
    aw = device_table(axial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_sep_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        aw,
        cfg.window_radius,
        cfg.max_disparity,
        int(cfg.asw_symmetric),
        int(cfg.cost == "ad"),
        int(cfg.volume_dtype == "bfloat16"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
    )
    launches += 1
    return dict(zip(PLANES, outs))
