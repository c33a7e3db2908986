"""K3's tile plan and box schedule, on the CPU.

``asw_dlanes_kernel.tile_plan`` sizes the CUDA kernel's blocks
(``asw_dlanes_kernel.cu``); these tests hold every plan of a grid of
geometries to what the kernel needs (it fits the card's shared memory and
thread limits, and its threads' register tiles cover every output row,
column and disparity of a block exactly once), pin the plans of the main
geometries, and check that chip_smoke.py's multi-row cases really span
several blocks of rows.  A float32 numpy model of the box blocks' schedule
(running column sums per covered output row, stack rows ascending, then
K column sums in dx order) must equal the plain box aggregation bit for
bit, with H not a multiple of the plan's rows and clamped border rows.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from aswstereomatch_torch.config import StereoConfig
from aswstereomatch_torch.ops import aggregate
from aswstereomatch_torch.ops.cuda import asw_dlanes_kernel

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

GEOMETRIES = [(375, 1242), (375, 450), (45, 150), (23, 150), (1, 1)]


def _owned(plan):
    """(row, column, d) triples the threads of one block own, as
    asw_dlanes_kernel.cu maps them: thread tid is output row tid // NTR;
    within the row, tile columns xb + i (i < 8) and disparities db + j and
    dp/2 + db + j (j < 4)."""
    ty, tx, dp = plan
    dg = dp // 8
    ntr = (tx // 8) * dg
    for tid in range(plan.threads()):
        t, q = divmod(tid, ntr)
        xb, db = q // dg * 8, q % dg * 4
        for i in range(8):
            for j in range(8):
                yield t, xb + i, db + (j if j < 4 else dp // 2 + j - 4)


@pytest.mark.parametrize("r", [0, 1, 4, 16, 31, 32])
@pytest.mark.parametrize("D", [2, 3, 7, 13, 64, 77, 128])
def test_tile_plan_fits_and_covers(D, r):
    K = 2 * r + 1
    for H, W in GEOMETRIES:
        for box in (False, True):
            plan = asw_dlanes_kernel.tile_plan(H, W, D, r, box)
            ty, tx, dp = plan
            assert plan.smem_bytes(r, box) <= 232_448
            assert 1 <= plan.threads() <= asw_dlanes_kernel.MAX_THREADS
            assert tx % 8 == 0 and dp == -(-D // 8) * 8 and 1 <= ty <= H
            if box:  # the kernel's box instantiations: ty in 1, 2, 4, 8, 16
                assert ty in (1, 2, 4, 8, 16)
            # whole tiles over the image, and each (row, column, d) of a
            # block owned by one thread exactly once
            assert -(-W // tx) * tx >= W and -(-H // ty) * ty >= H
            owned = list(_owned(plan))
            assert len(owned) == len(set(owned)) == ty * tx * dp
            # every tap: the stack rows a block walks give each of its rows
            # each dy once, in ascending order
            nrows = min(ty, H)
            for t in range(nrows):
                dys = [k - t for k in range(nrows + 2 * r) if 0 <= k - t < K]
                assert dys == list(range(K))


def test_tile_plan_of_the_main_geometries():
    """The plans the main path runs (PERF.md section 6 records their times)
    and those of K = 65, the kernel's window bound, at D = 128."""
    plan = asw_dlanes_kernel.tile_plan
    assert plan(375, 1242, 128, 16, False) == (8, 32, 128)
    assert plan(375, 1242, 128, 16, True) == (4, 64, 128)
    assert plan(375, 1242, 128, 32, False) == (8, 32, 128)
    assert plan(375, 1242, 128, 32, True) == (2, 64, 128)
    assert plan(375, 1242, 128, 16, False).smem_bytes(16, False) == 145_888
    assert plan(375, 1242, 128, 16, True).smem_bytes(16, True) == 196_608


def test_tile_plan_shrinks_rather_than_refuses():
    """Where a plan does not fit, rows go first (box by halving), then
    columns; a one-row plan of 8 columns fits every supported geometry."""
    for box in (False, True):
        for D in (2, 128):
            small = asw_dlanes_kernel.TilePlan(1, 8, -(-D // 8) * 8)
            assert small.fits(32, box)
    wide = asw_dlanes_kernel.tile_plan(375, 4000, 128, 32, True)
    assert wide.ty == 2 and wide.fits(32, True)
    assert not asw_dlanes_kernel.TilePlan(3, 64, 128).fits(16, True)  # box rows: powers of 2
    assert not asw_dlanes_kernel.TilePlan(8, 64, 128).fits(16, False)  # 1024 threads


@pytest.mark.parametrize("name", ["dl_rows_left_only", "dl_rows_box"])
def test_multirow_smoke_cases_span_several_row_blocks(name):
    """chip_smoke.py's two multi-row K3 cases: H at least 3 x the plan's
    rows and not a multiple of them."""
    case = {c[0]: c for c in chip_smoke.DLANES_SMALL_CASES}[name]
    cfg = StereoConfig(**{**chip_smoke._BASE, **case[1]})
    H, W = case[2]
    plan = asw_dlanes_kernel.tile_plan(H, W, cfg.max_disparity, cfg.window_radius,
                                       cfg.aggregation == "box")
    assert plan.ty >= 4 and H >= 3 * plan.ty and H % plan.ty != 0
    assert asw_dlanes_kernel.supports(cfg)


def _box_block_sums(vol_ext: np.ndarray, r: int, ty: int, tx: int, dx_first=False) -> np.ndarray:
    """The (H, W, D) window sums of asw_dlanes_kernel.cu's box blocks, in
    float32: per block of ty rows x tx columns, each tile column's running
    sums for the rows whose windows cover a stack row, stack rows
    ascending (clamped into the image), then K of those column sums per
    output in dx order.  ``dx_first`` sums rows first instead: a different
    order, which must not give the same bits."""
    H, WE, D = vol_ext.shape
    W, K = WE - 2 * r, 2 * r + 1
    if dx_first:
        rows = np.zeros((H, W, D), np.float32)
        for dx in range(K):
            rows += vol_ext[:, dx:dx + W]
        out = np.zeros((H, W, D), np.float32)
        for dy in range(K):
            out += rows[np.clip(np.arange(H) + dy - r, 0, H - 1)]
        return out
    out = np.zeros((H, W, D), np.float32)
    for y0 in range(0, H, ty):
        nrows = min(ty, H - y0)
        for x0 in range(0, W, tx):
            lw = tx + 2 * r
            nu = min(lw, WE - x0)  # tile columns inside the stacks
            cols = np.zeros((ty, lw, D), np.float32)
            for k in range(nrows + 2 * r):
                c = vol_ext[min(max(y0 - r + k, 0), H - 1), x0:x0 + nu]
                for t in range(ty):
                    if 0 <= k - t < K:
                        cols[t, :nu] += c
            for t in range(nrows):
                acc = np.zeros((tx, D), np.float32)
                for dx in range(K):
                    acc += cols[t, dx:dx + tx]
                n = min(tx, W - x0)
                out[y0 + t, x0:x0 + n] = acc[:n]
    return out


@pytest.mark.parametrize(
    "H,W,D,r,ty,tx",
    [(7, 19, 5, 2, 2, 8), (10, 23, 3, 4, 4, 16), (5, 9, 4, 6, 4, 8), (13, 40, 7, 1, 8, 16),
     (1, 5, 2, 3, 1, 8), (21, 50, 16, 3, 16, 24)],
)
def test_box_block_schedule_equals_plain_box(H, W, D, r, ty, tx):
    """Random float32 costs spanning several magnitudes, so that any other
    summation order rounds differently: the block schedule, scaled as the
    plain version scales, equals ``aggregate.aggregate_box`` bit for bit,
    for H not a multiple of ty and windows past the image rows."""
    rng = np.random.default_rng(H * 1000 + W * 10 + r)
    vol_ext = (rng.random((H, W + 2 * r, D)) * 10.0 ** rng.integers(-3, 3, (H, W + 2 * r, D))
               ).astype(np.float32)
    cfg = StereoConfig(max_disparity=D, window_radius=r, aggregation="box")
    ref = aggregate.aggregate_box(torch.from_numpy(vol_ext), cfg)
    K = 2 * r + 1
    got = torch.from_numpy(_box_block_sums(vol_ext, r, ty, tx)) / float(K * K)
    assert torch.equal(got, ref)
    if r > 0:  # the test sees the order: summing rows first changes bits
        other = torch.from_numpy(_box_block_sums(vol_ext, r, ty, tx, dx_first=True)) / float(K * K)
        assert not torch.equal(other, ref)


def test_box_block_schedule_on_a_raw_cost_volume():
    """The same on the raw cost volume of a synthetic pair, at the plan
    tile_plan gives its geometry."""
    from aswstereomatch_torch.ops.cuda.common import stacks
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(max_disparity=64, window_radius=3, aggregation="box")
    p = synthetic.make_pair(height=29, width=150, max_disparity=64, seed=3)
    ls, rs = stacks(torch.from_numpy(p["left"]), torch.from_numpy(p["right"]), cfg)
    vol_ext = aggregate.cost_volume_from_stacks(ls, rs, cfg)
    plan = asw_dlanes_kernel.tile_plan(29, 150, 64, 3, True)
    got = torch.from_numpy(_box_block_sums(vol_ext.numpy(), 3, plan.ty, plan.tx)) / 49.0
    assert torch.equal(got, aggregate.aggregate_box(vol_ext, cfg))
