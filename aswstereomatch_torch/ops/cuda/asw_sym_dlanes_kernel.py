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
in the reference.  ``tile_plan`` sizes the kernel's blocks to the geometry
and the card's shared memory, and the launch passes the plan to the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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

# What one block of the kernel may have on an H100 (asw_sym_dlanes_kernel.cu
# checks the plan against the card's own opt-in limit too).
SMEM_LIMIT = 232_448
WARPGROUP = 128
MAX_CONSUMERS = 384  # consumer threads of a block (three warpgroups)
MAX_DC = 128
TILE_COLS = 8   # columns of a consumer thread's register tile
TILE_DISPS = 4  # disparities of a consumer thread's register tile
DC_STEP = 8     # d-chunks are a multiple of 8 disparities
WTA_WORDS = 11  # 32-bit words of a column's WTA state carried across d-chunks

# Estimated instructions per unit of work, the weights of tile_plan's cost
# model (asw_sym_dlanes_kernel.cu's design note counts them): a raw cost, a
# bilateral weight (IEEE sqrtf and expf), and a tap of the register tile
# (weight product, FMA and add, plus its share of shared-memory loads).
COST_INSNS, WEIGHT_INSNS, TAP_INSNS = 26, 40, 3.2
# Producer warpgroups of a block (asw_sym_dlanes_kernel.cu): with one, the
# weights (latency-bound IEEE sqrtf and expf on 4 warps per SM) held K4
# 1.2-1.6x back at KITTI and Middlebury (PERF.md section 6).
PRODUCER_GROUPS = 2


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class TilePlan(NamedTuple):
    """One block: ``ty`` output rows x ``tx`` columns, d-chunks of ``dc``,
    runs of ``kx`` window columns (asw_sym_dlanes_kernel.cu)."""

    ty: int
    tx: int
    dc: int
    kx: int

    def tiles(self) -> int:
        """Register tiles of 8 columns x 4 disparities, one per consumer."""
        return self.ty * (self.tx // TILE_COLS) * (self.dc // TILE_DISPS)

    def consumers(self) -> int:
        """Consumer threads: the tiles in whole warpgroups."""
        return -(-self.tiles() // WARPGROUP) * WARPGROUP

    def threads(self) -> int:
        return PRODUCER_GROUPS * WARPGROUP + self.consumers()

    def smem_bytes(self, D: int) -> int:
        """asw_sym_dlanes_kernel.cu's Layout: two stage buffers (raw-cost
        row, left and right weights), or the aggregated tile over them; three
        buffers of stack rows; the centres' Lab; the WTA state carried
        across d-chunks where D > dc."""
        ty, tx, dc, kx = self
        nc, lw = tx + dc, tx + kx - 1
        stage = _round4(lw * dc + ty * kx * tx + ty * kx * nc)
        n = _round4(max(2 * stage, ty * tx * (dc + 1)))
        n += 3 * _round4(7 * (lw + nc + kx - 1)) + _round4(3 * ty * tx) + _round4(3 * ty * nc)
        if D > dc:
            n += WTA_WORDS * ty * tx
        return 4 * n

    def fits(self, D: int, r: int) -> bool:
        ty, tx, dc, kx = self
        return (ty >= 1 and tx >= TILE_COLS and tx % TILE_COLS == 0 and 8 <= dc <= MAX_DC
                and dc % DC_STEP == 0 and 1 <= kx <= 2 * r + 1
                and self.tiles() <= MAX_CONSUMERS and self.smem_bytes(D) <= SMEM_LIMIT)

    def cost(self, H: int, W: int, D: int, r: int) -> float:
        """Estimated instructions of the whole grid: raw costs (each stack
        row of a block row once per run of window columns), weights (per
        output row, stack row and tap, TX left and TX + DC right ones per
        d-chunk) and taps (every column of every tile), the taps scaled by
        the consumer threads launched over those that work."""
        ty, tx, dc, kx = self
        K = 2 * r + 1
        nbx, nby, nch = -(-W // tx), -(-H // ty), -(-D // dc)
        nkx = -(-K // kx)
        raw = (H + nby * 2 * r) * (nkx * (tx - 1) + K) * dc * COST_INSNS
        weights = H * K * K * (2 * tx + dc) * WEIGHT_INSNS
        taps = H * tx * dc * K * K * TAP_INSNS * self.consumers() / self.tiles()
        return nbx * nch * (raw + weights + taps)


def with_longest_run(plan: TilePlan, D: int, r: int) -> TilePlan | None:
    """``plan`` with the longest run of window columns (kx <= K) that fits,
    or None where not even one column does (shared memory grows with kx)."""
    lo, hi = 0, 2 * r + 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if plan._replace(kx=mid).fits(D, r) else (lo, mid - 1)
    return plan._replace(kx=lo) if lo else None


@functools.lru_cache(maxsize=256)
def tile_plan(H: int, W: int, D: int, r: int) -> TilePlan:
    """The kernel's tile plan for an (H, W) pair at 2 <= D <= 128
    disparities, radius r (K <= 63).

    Disparities: one chunk of D rounded up to 8.  Among the blocks of
    ty <= H rows x tx columns (a multiple of 8, at most 128) whose
    ty x (tx / 8) x (dc / 4) register tiles fit the 384 consumer threads,
    each with the longest run of window columns (kx <= K) that fits the
    232,448 bytes of shared memory, the plan of the least estimated work
    (``TilePlan.cost``), the fewer threads on a tie, among those that take
    all K window columns in one run where any does (a second run doubles
    the stages and rebuilds the raw-cost halo) and whose tiles fill whole
    warpgroups where any does (so every launched consumer thread works).
    It never refuses a supported geometry: one row of 8 columns
    with runs of one window column fits at every D and K <= 63.
    """
    K = 2 * r + 1
    dc = min(-(-D // DC_STEP) * DC_STEP, MAX_DC)
    best, best_key = None, None
    for tx in range(TILE_COLS, 129, TILE_COLS):
        per_row = (tx // TILE_COLS) * (dc // TILE_DISPS)
        for ty in range(1, min(H, MAX_CONSUMERS // per_row) + 1):
            plan = with_longest_run(TilePlan(ty, tx, dc, K), D, r)
            if plan is None:
                continue
            key = (plan.kx < K, plan.tiles() != plan.consumers(), plan.cost(H, W, D, r),
                   plan.threads(), -tx)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    return best


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
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig,
    plan: TilePlan | None = None,
) -> dict:
    """The symmetric d-lanes kernel over pre-extended channel stacks.

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
    D = cfg.max_disparity
    if plan is None:
        H, W = ls_ext.shape[1], ls_ext.shape[2] - 2 * cfg.window_radius
        plan = tile_plan(H, W, D, cfg.window_radius)
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
        [*plan, plan.smem_bytes(D)],
    )
    launches += 1
    return dict(zip(PLANES, outs))
