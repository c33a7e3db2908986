"""Left-only exact ASW or box aggregation + dual-view WTA with the weights
reused across d: wrapper, routing rules and plain version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_dlanes.py``.  The kernel
is hand-written CUDA (``asw_dlanes_kernel.cu``, bound as
``torch.ops.asw_torch.asw_dlanes_wta`` by ``asw_binding.cpp``, built by
``build.py``).  ``tile_plan`` sizes the kernel's blocks to the geometry
and the card's shared memory, and the launch passes the plan to the kernel.
Both entry points return the same dict of (H, W) planes as ``asw_kernel``:
bestd, bestc, cm, cp, rbestd, ubest.

Its function is the one K1 (``asw_kernel``) computes for left-only ASW and
box aggregation, so the plain version is K1's (``asw_kernel.
reference_from_stacks``).  On a CUDA tensor the wrapper launches the kernel
(and raises if it cannot); on a CPU tensor it computes that plain version.
"""

from __future__ import annotations

from typing import NamedTuple

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

# What one block of the kernel may have on an H100 (asw_dlanes_kernel.cu
# checks the plan against the card's own opt-in limit too).
SMEM_LIMIT = 232_448
MAX_THREADS = 512
TILE_COLS = 8    # columns of a thread's register tile
TILE_DISPS = 8   # disparities of a thread's register tile
MAX_BOX_ROWS = 16  # box: each thread holds a running column sum per row


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class TilePlan(NamedTuple):
    """One block: ``ty`` output rows x ``tx`` columns x ``dp`` disparities
    (D rounded up to 8), asw_dlanes_kernel.cu."""

    ty: int
    tx: int
    dp: int

    def threads(self) -> int:
        return self.ty * (self.tx // TILE_COLS) * (self.dp // TILE_DISPS)

    def smem_bytes(self, r: int, box: bool) -> int:
        """asw_dlanes_kernel.cu's Layout: the stage arrays (left-only: the
        raw-cost row and one band of weights per row; box: the column sums
        of every row), or the aggregated tile over them; for left-only, two
        buffers of stack rows, the centres' Lab and den."""
        ty, tx, dp = self
        lw = tx + 2 * r
        stage = ty * lw * dp if box else lw * dp + ty * lw * tx
        n = _round4(max(stage, ty * tx * (dp + 1)))
        if not box:
            n += 2 * _round4(7 * lw + 4 * (lw + dp - 1)) + _round4(3 * ty * tx) + _round4(ty * tx)
        return 4 * n

    def fits(self, r: int, box: bool) -> bool:
        return (self.threads() <= MAX_THREADS and self.smem_bytes(r, box) <= SMEM_LIMIT
                and (not box or (self.ty <= MAX_BOX_ROWS and self.ty & (self.ty - 1) == 0)))


def tile_plan(H: int, W: int, D: int, r: int, box: bool) -> TilePlan:
    """The kernel's tile plan for an (H, W) pair at D <= 128 disparities,
    radius r <= 32, left-only ASW or box.

    Columns: the fewest tiles of at most 64 columns (box) or 32 (left-only:
    more rows share each raw-cost row, which measured faster at KITTI,
    PERF.md section 6), evened out to a multiple of 8.  Disparities: all of
    D, rounded up to 8.  Rows: as many as 512 threads allow, each output row
    taking (tx / 8) x (dp / 8) threads; for box a power of two of at most 16
    (the kernel's running column sums are a register array per row).
    Where shared memory runs short, the plan gives up rows (left-only one
    at a time, box by halving), then columns; it never refuses a supported
    geometry: one row of 8 columns fits at every D and K <= 65.
    """
    dp = -(-D // TILE_DISPS) * TILE_DISPS
    ntiles = -(-W // (64 if box else 32))
    tx = TILE_COLS * -(-W // (TILE_COLS * ntiles))
    ty = max(1, min(H, MAX_THREADS // ((tx // TILE_COLS) * (dp // TILE_DISPS))))
    if box:
        ty = 1 << (min(ty, MAX_BOX_ROWS).bit_length() - 1)
    plan = TilePlan(ty, tx, dp)
    while not plan.fits(r, box):
        if plan.ty > 1:
            plan = plan._replace(ty=plan.ty // 2 if box else plan.ty - 1)
        else:
            plan = plan._replace(tx=max(TILE_COLS, plan.tx // 2 // TILE_COLS * TILE_COLS))
    return plan


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
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig,
    plan: TilePlan | None = None,
) -> dict:
    """The d-lanes kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule.  ``plan`` overrides ``tile_plan`` (any plan
    gives the same bits; a plan the kernel cannot run raises).
    """
    _check(cfg)
    return dispatch(ls_ext, rs_ext, cfg, reference_from_stacks,
                    lambda ls, rs, c: _launch(ls, rs, c, plan))


def _launch(ls_ext, rs_ext, cfg, plan=None) -> dict:
    global launches
    build.load()
    box = cfg.aggregation == "box"
    r = cfg.window_radius
    if plan is None:
        H, W = ls_ext.shape[1], ls_ext.shape[2] - 2 * r
        plan = tile_plan(H, W, cfg.max_disparity, r, box)
    sw = device_table(spatial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_dlanes_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        sw,
        r,
        cfg.max_disparity,
        int(box),
        int(cfg.cost == "ad"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
        [*plan, plan.smem_bytes(r, box)],
    )
    launches += 1
    return dict(zip(PLANES, outs))
