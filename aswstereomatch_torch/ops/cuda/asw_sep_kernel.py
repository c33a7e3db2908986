"""Separable two-pass ASW + dual-view WTA: wrapper and plain version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_sep_dlanes.py``.  The
kernel is hand-written CUDA (``asw_sep_kernel.cu``, bound as
``torch.ops.asw_torch.asw_sep_wta`` by ``asw_binding.cpp``, built by
``build.py``).  ``tile_plan`` sizes the kernel's blocks to the geometry
and the card's shared memory, and the launch passes the plan to the
kernel.  Both entry points return the same dict of (H, W) planes as
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

from typing import NamedTuple

import torch

from ...config import StereoConfig
from .. import aggregate, wta
from ...utils.convert import axial_weights_np
from . import build
from .common import PLANES, device_table, dispatch, f32, stacks

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).
launches = 0

# What one block of the kernel may have on an H100 (asw_sep_kernel.cu checks
# the plan against the card's own opt-in limit too).
SMEM_LIMIT = 232_448
MAX_THREADS = 512
TILE_COLS = 4    # columns of a thread's register tile
TILE_DISPS = 8   # disparities of a thread's register tile (vertical pass)
WTA_WORDS = 11   # 4-byte words of one column's carried WTA state


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class TilePlan(NamedTuple):
    """One block: ``ty`` output rows x ``tx`` columns, disparities in chunks
    of ``dc``, horizontal weights in runs of ``kx`` taps (asw_sep_kernel.cu;
    left-only: all K taps in one run, built once per block)."""

    ty: int
    tx: int
    dc: int
    kx: int

    def columns(self, r: int) -> int:
        """The vertical pass's extended columns, tx + 2r rounded up to whole
        register tiles."""
        return _round4(self.tx + 2 * r)

    def threads(self, r: int) -> int:
        """One register tile per thread over the vertical pass's rows x
        extended columns x chunk."""
        return self.ty * (self.columns(r) // TILE_COLS) * (self.dc // TILE_DISPS)

    def smem_bytes(self, r: int, sym: bool) -> int:
        """asw_sep_kernel.cu's Layout: the stage arrays (symmetric: a run's
        horizontal weights over them; left-only: the left horizontal weights
        after them); the vertical sums (the chunk's aggregated tile over
        them); the rows' Lab (left, and right in symmetric mode); the
        carried WTA state."""
        ty, tx, dc, kx = self
        lwp = self.columns(r)
        ncv, nch, dcs = lwp + dc, tx + dc, dc + 4
        stage = lwp * dcs + ty * lwp + (ty * ncv if sym else 0)
        stage += 2 * _round4(7 * lwp + (7 if sym else 4) * ncv)
        if sym:
            n = _round4(max(stage, ty * kx * (tx + nch)))
        else:
            n = _round4(stage) + ty * kx * tx
        n += ty * lwp * dcs + (ty * lwp * dcs if sym else ty * lwp)
        n += _round4(3 * ty * lwp) + (3 * ty * ncv if sym else 0)
        n += _round4(WTA_WORDS * ty * tx)
        return 4 * n

    def fits(self, r: int, sym: bool) -> bool:
        K = 2 * r + 1
        return (self.threads(r) <= MAX_THREADS and self.smem_bytes(r, sym) <= SMEM_LIMIT
                and (1 <= self.kx <= K if sym else self.kx == K))


def tile_plan(H: int, W: int, D: int, r: int, sym: bool) -> TilePlan:
    """The kernel's tile plan for an (H, W) pair at 2 <= D <= 128, r <= 32,
    symmetric or left-only weights.

    Columns: the fewest tiles of at most 96 columns, evened out to a
    multiple of 8.  Disparities: chunks of 32, at most D rounded up to 8.
    Rows: as many as 512 threads allow, one register tile of 4 columns x 8
    disparities per thread over the vertical pass's tx + 2r columns; at
    most H.  Horizontal weights: all K
    taps in one run.  Where shared memory runs short, the plan gives up
    taps per run (symmetric, down to 8), then rows, then columns, then
    disparities; it never refuses a supported geometry: one row of 8
    columns and a chunk of 8 disparities fit at every r <= 32, with runs of
    one tap (symmetric) or all K (left-only).
    """
    K = 2 * r + 1
    dc = min(32, -(-D // TILE_DISPS) * TILE_DISPS)
    ntiles = -(-W // 96)
    tx = 8 * -(-W // (8 * ntiles))
    per_row = (_round4(tx + 2 * r) // TILE_COLS) * (dc // TILE_DISPS)
    while per_row > MAX_THREADS and tx > 8:
        tx = max(8, tx // 2 // 8 * 8)
        per_row = (_round4(tx + 2 * r) // TILE_COLS) * (dc // TILE_DISPS)
    plan = TilePlan(max(1, min(H, MAX_THREADS // per_row)), tx, dc, K)
    while not plan.fits(r, sym):
        if sym and plan.kx > 8:  # the next number of runs, evened out
            plan = plan._replace(kx=max(8, -(-K // (-(-K // plan.kx) + 1))))
        elif plan.ty > 1:
            plan = plan._replace(ty=plan.ty - 1)
        elif plan.tx > 8:
            plan = plan._replace(tx=max(8, plan.tx // 2 // 8 * 8))
        elif plan.dc > 8:
            plan = plan._replace(dc=plan.dc - 8)
        else:
            plan = plan._replace(kx=max(1, plan.kx // 2) if sym else K)
    return plan


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
    device: the materialized separable volume and ``wta.planes``."""
    _check(cfg)
    storage = torch.bfloat16 if cfg.volume_dtype == "bfloat16" else None
    vol = aggregate.aggregate_asw_separable_from_stacks(
        ls_ext, rs_ext, cfg, storage_dtype=storage)
    return wta.planes(vol)


def wta_outputs_reference(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Plain PyTorch version of the kernel's function, on any device."""
    _check(cfg)
    return reference_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Run the separable kernel over one pair of (H, W[, 3]) float32 images."""
    _check(cfg)
    return wta_outputs_from_stacks(*stacks(left, right, cfg), cfg)


def wta_outputs_from_stacks(
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig,
    plan: TilePlan | None = None,
) -> dict:
    """Separable kernel over pre-extended channel stacks.

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
    r, sym = cfg.window_radius, cfg.asw_symmetric
    if plan is None:
        H, W = ls_ext.shape[1], ls_ext.shape[2] - 2 * r
        plan = tile_plan(H, W, cfg.max_disparity, r, sym)
    aw = device_table(axial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_sep_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        aw,
        r,
        cfg.max_disparity,
        int(sym),
        int(cfg.cost == "ad"),
        int(cfg.volume_dtype == "bfloat16"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
        [*plan, plan.smem_bytes(r, sym)],
    )
    launches += 1
    return dict(zip(PLANES, outs))
