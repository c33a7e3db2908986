"""Fused cost + exact ASW/box aggregation + dual-view WTA: wrapper and plain
version.

Counterpart of ``aswstereomatch_tpu/ops/pallas/asw_kernel.py``.  The kernel
is hand-written CUDA (``asw_kernel.cu``, bound as
``torch.ops.asw_torch.asw_wta`` by ``asw_binding.cpp``, built by
``build.py``).  ``tile_plan`` sizes the kernel's blocks to the geometry
and the card's shared memory, and the launch passes the plan to the kernel.
Both entry points return the same dict of (H, W) planes:

  bestd, bestc, cm, cp — left-view integer WTA + parabola triple
  rbestd               — right-view WTA (volume reuse), for the LR check
  ubest                — second-best cost excluding bestd +- 1

The sharded layouts (``parallel/``) also pass the TPU kernel's shard inputs
(its ``wta_outputs_from_stacks``, asw_kernel.py:466-473): ``n_valid_cols``,
``d_window`` and ``want_strip``, which adds ``rbestc`` and the right-view
strip ``r_strip_c`` / ``r_strip_d`` (H, D - 1).

On a CUDA tensor the wrapper launches the kernel (and raises if it cannot);
on a CPU tensor it computes the plain PyTorch version from the materialized
aggregated volume.  ``wta_outputs_reference`` (``reference_from_stacks``
over pre-extended stacks) is that plain version on any device: the tests
and chip_smoke.py compare the kernel against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import StereoConfig
from .. import aggregate, wta
from ...utils.convert import spatial_weights_np
from . import build
from .common import PLANES, device_table, dispatch, f32, stacks

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).
launches = 0

# What one block of the kernel may have on an H100 (asw_kernel.cu checks the
# plan against the card's own opt-in limit too).
SMEM_LIMIT = 232_448
MAX_THREADS = 512
MAX_DC = 128
TILE_COLS = 4   # columns of a thread's register tile
TILE_DISPS = 8  # disparities of a thread's register tile
SYMMETRIC, LEFT_ONLY, BOX = 0, 1, 2  # the kernel's Mode


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class TilePlan(NamedTuple):
    """One block: ``ty`` output rows x ``tx`` columns, d-chunks of ``dc``,
    runs of ``kx`` window columns (asw_kernel.cu)."""

    ty: int
    tx: int
    dc: int
    kx: int

    def threads(self) -> int:
        return self.ty * (self.tx // TILE_COLS) * (self.dc // TILE_DISPS)

    def smem_bytes(self, mode: int) -> int:
        """asw_kernel.cu's Layout: the stage arrays (raw-cost rows, left
        weights for ASW, right weights for symmetric), or the aggregated
        tile over them; two buffers of stack rows; the centres' Lab."""
        ty, tx, dc, kx = self
        nc, lw = tx + dc, tx + kx - 1
        stage = lw * dc
        if mode != BOX:
            stage += ty * kx * tx
        if mode == SYMMETRIC:
            stage += ty * kx * nc
        n = _round4(max(stage, ty * tx * (dc + 1))) + 2 * _round4(7 * (lw + nc + kx - 1))
        if mode != BOX:
            n += _round4(3 * ty * tx)
        if mode == SYMMETRIC:
            n += _round4(3 * ty * nc)
        return 4 * n

    def fits(self, mode: int) -> bool:
        return self.threads() <= MAX_THREADS and self.smem_bytes(mode) <= SMEM_LIMIT


def tile_plan(H: int, W: int, D: int, r: int, mode: int) -> TilePlan:
    """The kernel's tile plan for an (H, W) pair at D disparities, radius r.

    Columns: the fewest tiles of at most 64 columns, evened out (450
    columns run as 8 tiles of 60, not 7 of 64 and one of 2).  Disparities:
    one chunk of D rounded up to 8 where D <= 128, else chunks of 128.
    Rows: as many as 512 threads allow, each output row taking
    (tx / 4) x (dc / 8) threads.  Where shared memory runs short (large
    K), the plan gives up, in this order, rows, window columns per stage,
    columns and disparities per chunk; it never refuses a geometry: at one
    row, one window column, 4 columns and dc <= 32 every D and r fit.
    """
    K = 2 * r + 1
    dc = min(-(-D // TILE_DISPS) * TILE_DISPS, MAX_DC)
    ntiles = -(-W // 64)
    tx = TILE_COLS * -(-W // (TILE_COLS * ntiles))
    per_row = (tx // TILE_COLS) * (dc // TILE_DISPS)
    plan = TilePlan(max(1, min(H, MAX_THREADS // per_row)), tx, dc, K)
    while not plan.fits(mode):
        if plan.ty > 1:
            plan = plan._replace(ty=plan.ty // 2)
        elif plan.kx > 1:
            plan = plan._replace(kx=-(-plan.kx // 2))
        elif plan.tx > TILE_COLS:
            plan = plan._replace(tx=max(TILE_COLS, plan.tx // 2 // TILE_COLS * TILE_COLS))
        else:  # dc > 32: halving keeps a multiple of 8 and >= 32
            plan = plan._replace(dc=plan.dc // 2)
    return plan


def supports(cfg: StereoConfig) -> bool:
    """The fused kernel covers exact ASW (both weight modes) and box
    aggregation, for both costs; aggregation='none' and SGM are not its
    function, and the separable approximation is ``asw_sep_kernel``'s."""
    return cfg.aggregation in ("asw", "box") and not cfg.asw_separable


def _mode(cfg: StereoConfig) -> int:
    """The kernel's Mode (asw_kernel.cu)."""
    if cfg.aggregation == "box":
        return BOX
    return SYMMETRIC if cfg.asw_symmetric else LEFT_ONLY


def reference_from_stacks(ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig,
                          *, n_valid_cols: int | None = None, want_strip: bool = False,
                          d_window: tuple[int, int] | None = None) -> dict:
    """The kernel's function in plain PyTorch over pre-extended channel
    stacks, on any device, from the materialized aggregated volume (the
    forms ``aggregate.aggregated_volume`` uses).  The shard inputs as
    ``wta_outputs_from_stacks`` takes them."""
    _check(cfg)
    if cfg.aggregation == "box":
        vol = aggregate.aggregate_box(aggregate.cost_volume_from_stacks(ls_ext, rs_ext, cfg), cfg)
    else:
        vol = aggregate.aggregate_asw_from_stacks(ls_ext, rs_ext, cfg)
    W, D = vol.shape[1], vol.shape[2]
    n_valid, (lo, hi) = _shard_inputs(n_valid_cols, d_window, W, D)
    if n_valid == W and (lo, hi) == (0, D) and not want_strip:
        return wta.planes(vol)
    return window_planes(vol, n_valid, lo, hi, want_strip)


def _shard_inputs(n_valid_cols, d_window, W: int, D: int) -> tuple:
    """(n_valid, (lo, hi)) with their defaults, W and the whole range of d;
    raises on values the kernel does not take."""
    n_valid = W if n_valid_cols is None else int(n_valid_cols)
    lo, hi = (0, D) if d_window is None else (int(d_window[0]), int(d_window[1]))
    if not 0 <= n_valid <= W:
        raise ValueError(f"n_valid_cols {n_valid} outside [0, {W}]")
    if not 0 <= lo < hi <= D:
        raise ValueError(f"d_window {(lo, hi)} outside [0, {D})")
    return n_valid, (lo, hi)


def window_planes(vol: torch.Tensor, n_valid: int, lo: int, hi: int,
                   want_strip: bool) -> dict:
    """The kernel's planes with the shard inputs, from the (H, W, D)
    volume: only d in [lo, hi) may win either view (cm / cp still read the
    planes beside the winner), left columns at or past ``n_valid`` feed no
    right-view candidate, and the right view covers x' in [-(D-1), W); a
    right pixel no candidate reaches reads (inf, 0), as the kernels' does."""
    H, W, D = vol.shape
    dev = vol.device
    inf = torch.tensor(float("inf"), dtype=vol.dtype, device=dev)
    dd = torch.arange(D, device=dev)
    in_win = (dd >= lo) & (dd < hi)
    win = torch.where(in_win, vol, inf)
    bestd = wta.wta(win)
    take = lambda i: torch.gather(vol, -1, i.to(torch.int64)[..., None])[..., 0]  # noqa: E731
    out = {"bestd": bestd, "bestc": take(bestd), "cm": take((bestd - 1).clamp(0, D - 1)),
           "cp": take((bestd + 1).clamp(0, D - 1)),
           "ubest": wta.second_best_excl_neighbors(win, bestd)}
    src = torch.arange(W + D - 1, device=dev)[:, None] - (D - 1) + dd[None, :]  # x' + d
    ok = (src >= 0) & (src < n_valid) & in_win[None, :]
    cand = torch.gather(win, 1, src.clamp(0, W - 1).expand(H, W + D - 1, D))
    cand = torch.where(ok, cand, inf)
    rc, rd = cand.amin(-1), wta.wta(cand)
    out["rbestd"] = rd[:, D - 1:].contiguous()
    if want_strip:
        out["rbestc"] = rc[:, D - 1:].contiguous()
        out["r_strip_c"] = rc[:, : D - 1].contiguous()
        out["r_strip_d"] = rd[:, : D - 1].contiguous()
    return out


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
    ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig,
    plan: TilePlan | None = None, *, n_valid_cols: int | None = None,
    want_strip: bool = False, d_window: tuple[int, int] | None = None,
) -> dict:
    """Fused kernel over pre-extended channel stacks.

    ls_ext: (7, H, W + 2r); rs_ext: (7, H, W + 2r + D - 1), columns extended
    per the padded-plane rule (in a shard, real neighbour columns).
    ``plan`` overrides ``tile_plan`` (any plan gives the same bits; a plan
    the kernel cannot run raises).

    The shard inputs of the TPU kernel: ``n_valid_cols`` (default W) left
    columns are real pixels, the rest feed no right-view candidate;
    ``d_window = (lo, hi)`` (default (0, D)) lets only those d's win either
    view, while every d's plane is still computed; ``want_strip`` adds
    ``rbestc`` (H, W) and the right-view partial ``r_strip_c`` /
    ``r_strip_d`` (H, D - 1) of the columns [-(D-1), -1] left of the local
    origin, for a cross-shard strict-< merge.  The reference refuses a
    strip when D - 1 exceeds its TPU tile width; here the right view is one
    buffer of W + D - 1 columns, so no such limit applies.
    """
    _check(cfg)
    kw = dict(n_valid_cols=n_valid_cols, want_strip=want_strip, d_window=d_window)
    return dispatch(ls_ext, rs_ext, cfg,
                    lambda ls, rs, c: reference_from_stacks(ls, rs, c, **kw),
                    lambda ls, rs, c: _launch(ls, rs, c, plan, **kw))


def _launch(ls_ext, rs_ext, cfg, plan=None, n_valid_cols=None, want_strip=False,
            d_window=None) -> dict:
    global launches
    build.load()
    mode = _mode(cfg)
    H, W = ls_ext.shape[1], ls_ext.shape[2] - 2 * cfg.window_radius
    n_valid, (lo, hi) = _shard_inputs(n_valid_cols, d_window, W, cfg.max_disparity)
    if plan is None:
        plan = tile_plan(H, W, cfg.max_disparity, cfg.window_radius, mode)
    sw = device_table(spatial_weights_np, cfg, ls_ext.device)
    outs = torch.ops.asw_torch.asw_wta(
        ls_ext.to(torch.float32).contiguous(),
        rs_ext.to(torch.float32).contiguous(),
        sw,
        cfg.window_radius,
        cfg.max_disparity,
        mode,
        int(cfg.cost == "ad"),
        f32(cfg.alpha),
        f32(1.0 - cfg.alpha),
        f32(cfg.tau_color),
        f32(cfg.tau_grad),
        f32(1.0 / cfg.gamma_color),
        n_valid, lo, hi, bool(want_strip),
        [*plan, plan.smem_bytes(mode)],
    )
    launches += 1
    out = dict(zip(PLANES, outs[:6]))
    if want_strip:
        out.update(rbestc=outs[6], r_strip_c=outs[7], r_strip_d=outs[8])
    return out
