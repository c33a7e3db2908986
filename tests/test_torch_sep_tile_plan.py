"""K2's tile plan and block schedule, on the CPU.

``asw_sep_kernel.tile_plan`` sizes the separable CUDA kernel's blocks
(``asw_sep_kernel.cu``); these tests hold every plan of a grid of
geometries to what the kernel needs (it fits the card's shared memory and
thread limits, and its threads' register tiles cover every row, column and
disparity of a block's vertical and horizontal passes exactly once), pin
the plans of the main geometries, and check that chip_smoke.py's multi-row
cases really span several blocks of rows.  A float32 numpy model of the
blocks' schedule (the virtual stack rows of a block walked once each,
clamped for reading; d-chunks; horizontal taps in runs) gives every output
row each window row once, dy ascending, and its sums agree with the plain
separable aggregation at the aggregated-volume bar.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from aswstereomatch_torch.config import StereoConfig
from aswstereomatch_torch.ops import aggregate, preprocess
from aswstereomatch_torch.ops.cuda import asw_sep_kernel
from aswstereomatch_torch.ops.cuda.common import stacks
from aswstereomatch_torch.utils import synthetic

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

GEOMETRIES = [(375, 1242), (375, 450), (45, 150), (23, 150), (1, 1)]


def _owned_vertical(plan, r):
    """(row, column, d) triples the threads of one block own in the vertical
    pass, as asw_sep_kernel.cu maps them: per row (lw / 4) x (dc / 8)
    threads, each with extended columns ub + i (i < 4) and chunk offsets
    db + j and dc/2 + db + j (j < 4)."""
    ty, tx, dc, kx = plan
    dg = dc // 8
    per_row = (plan.columns(r) // 4) * dg
    for tid in range(plan.threads(r)):
        t, q = divmod(tid, per_row)
        ub, db = q // dg * 4, q % dg * 4
        for i in range(4):
            for j in range(8):
                yield t, ub + i, db + (j if j < 4 else dc // 2 + j - 4)


def _owned_horizontal(plan, r):
    """The same for the horizontal pass: tiles of 4 columns x 4 disparities,
    (tx / 4) x (dc / 4) per row; thread tid takes tiles tid + h * threads for
    h < 2."""
    ty, tx, dc, kx = plan
    dg = dc // 4
    per_row = (tx // 4) * dg
    nthreads = plan.threads(r)
    for tid in range(nthreads):
        for h in range(2):  # asw_sep_kernel.cu's HT
            tile = tid + h * nthreads
            if tile >= ty * per_row:
                continue
            t, q = divmod(tile, per_row)
            xb, db = q // dg * 4, q % dg * 4
            for i in range(4):
                for j in range(4):
                    yield t, xb + i, db + j


@pytest.mark.parametrize("r", [0, 2, 8, 16, 32])
@pytest.mark.parametrize("D", [2, 8, 64, 128])
@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "left_only"])
def test_tile_plan_fits_and_covers(D, r, sym):
    K = 2 * r + 1
    for H, W in GEOMETRIES:
        plan = asw_sep_kernel.tile_plan(H, W, D, r, sym)
        ty, tx, dc, kx = plan
        assert plan.fits(r, sym)
        assert plan.smem_bytes(r, sym) <= 232_448
        assert 1 <= plan.threads(r) <= asw_sep_kernel.MAX_THREADS
        assert tx % 8 == 0 and dc % 8 == 0 and 8 <= dc <= -(-D // 8) * 8
        assert 1 <= ty <= H and (1 <= kx <= K if sym else kx == K)
        # whole tiles over the image
        assert -(-W // tx) * tx >= W and -(-H // ty) * ty >= H
        # each (row, column, d) of both passes owned by one thread exactly
        # once; the horizontal tasks fit in the block
        lw = plan.columns(r)
        assert lw >= tx + 2 * r and lw % 4 == 0
        vert = list(_owned_vertical(plan, r))
        assert len(vert) == len(set(vert)) == ty * lw * dc == 32 * plan.threads(r)
        horiz = list(_owned_horizontal(plan, r))
        assert len(horiz) == len(set(horiz)) == ty * tx * dc


def test_tile_plan_of_the_main_geometries():
    """The plans the main path runs (PERF.md section 6 records their times)
    and those of K = 65, the kernel's window bound, at D = 128."""
    plan = asw_sep_kernel.tile_plan
    assert plan(375, 1242, 128, 16, True) == (4, 96, 32, 11)
    assert plan(375, 1242, 128, 16, False) == (4, 96, 32, 33)
    assert plan(375, 1242, 128, 32, True) == (3, 96, 32, 22)
    assert plan(375, 1242, 128, 32, False) == (3, 96, 32, 65)
    assert plan(375, 1242, 128, 16, True).smem_bytes(16, True) == 217_600
    assert plan(375, 1242, 128, 16, False).smem_bytes(16, False) == 182_272


def test_tile_plan_shrinks_rather_than_refuses():
    """Where a plan does not fit, the horizontal runs go first (symmetric),
    then rows, columns and disparities; one row of 8 columns and a chunk of
    8 fit every supported geometry, with runs of one tap (symmetric) or all
    K taps (left-only, which builds them once per block)."""
    assert asw_sep_kernel.TilePlan(1, 8, 8, 1).fits(32, True)
    assert asw_sep_kernel.TilePlan(1, 8, 8, 65).fits(32, False)
    assert not asw_sep_kernel.TilePlan(1, 8, 8, 1).fits(32, False)  # left-only: kx = K
    wide = asw_sep_kernel.tile_plan(375, 1242, 128, 16, True)
    assert wide.kx < 33 and not wide._replace(kx=17).fits(16, True)
    assert not asw_sep_kernel.TilePlan(8, 96, 32, 33).fits(16, True)   # 1024 threads
    assert not asw_sep_kernel.TilePlan(4, 96, 32, 33).fits(16, True)   # shared memory
    assert not asw_sep_kernel.TilePlan(4, 96, 32, 34).fits(16, True)   # kx > K


@pytest.mark.parametrize("name", ["sep_rows_sym", "sep_rows_left_only"])
def test_multirow_smoke_cases_span_several_row_blocks(name):
    """chip_smoke.py's two multi-row K2 cases: H at least 3 x the plan's
    rows and not a multiple of them, r >= 4, more than one d-chunk."""
    case = {c[0]: c for c in chip_smoke.SEP_SMALL_CASES}[name]
    cfg = StereoConfig(**{**chip_smoke._BASE, **case[1]})
    H, W = case[2]
    plan = asw_sep_kernel.tile_plan(H, W, cfg.max_disparity, cfg.window_radius,
                                    cfg.asw_symmetric)
    assert plan.ty >= 2 and H >= 3 * plan.ty and H % plan.ty != 0
    assert cfg.window_radius >= 4 and cfg.max_disparity > plan.dc and W > plan.tx
    assert asw_sep_kernel.supports(cfg)


def _block_model(vol_ext, wv, wh, r, plan, visits=None):
    """The (H, W, D) aggregated volume as asw_sep_kernel.cu's blocks compute
    it, in float32: per block of ty rows x tx columns and per d-chunk, the
    virtual stack rows y0 - r ... y0 + nrows - 1 + r walked once each
    (clamped for reading), each adding w * C into the vertical sums of the
    rows whose windows cover it; then the horizontal taps in runs of kx,
    dx ascending.  wv[y, u, d, dy] and wh[y, x, d, dx] are the plain
    version's weight products.  ``visits[y]`` collects (dy, stack row) in
    the order output row y takes them."""
    H, WL, D = vol_ext.shape
    K = 2 * r + 1
    W = WL - 2 * r
    ty, tx, dc, kx = plan
    out = np.zeros((H, W, D), np.float32)
    for y0 in range(0, H, ty):
        nrows = min(ty, H - y0)
        for x0 in range(0, W, tx):
            nx = min(tx, W - x0)
            nu = nx + 2 * r
            for d0 in range(0, D, dc):
                d1 = min(d0 + dc, D)
                numv = np.zeros((nrows, nu, d1 - d0), np.float32)
                denv = np.zeros_like(numv)
                for k in range(nrows + 2 * r):
                    s = min(max(y0 - r + k, 0), H - 1)
                    for t in range(nrows):
                        dy = k - t
                        if 0 <= dy < K:
                            w = wv[y0 + t, x0:x0 + nu, d0:d1, dy]
                            numv[t] += w * vol_ext[s, x0:x0 + nu, d0:d1]
                            denv[t] += w
                            if visits is not None and d0 == 0 and x0 == 0:
                                visits[y0 + t].append((dy, s))
                for t in range(nrows):
                    num = np.zeros((nx, d1 - d0), np.float32)
                    den = np.zeros_like(num)
                    for dx0 in range(0, K, kx):
                        for dx in range(dx0, min(dx0 + kx, K)):
                            w = wh[y0 + t, x0:x0 + nx, d0:d1, dx]
                            num += w * numv[t, dx:dx + nx]
                            den += w * denv[t, dx:dx + nx]
                    out[y0 + t, x0:x0 + nx, d0:d1] = num / den
    return out


def _plain_pieces(ls, rs, cfg, storage=None):
    """The raw cost volume and the weight products of the plain version
    (aggregate.aggregate_asw_separable_from_stacks), as numpy arrays."""
    r, D = cfg.window_radius, cfg.max_disparity
    we = ls.shape[2]
    vol = aggregate.cost_volume_from_stacks(ls, rs, cfg)
    if storage is not None:
        vol = vol.to(storage).to(torch.float32)
    lab_l = torch.movedim(ls[4:7], 0, -1)
    wvl = aggregate._bilateral_1d(lab_l, cfg, "y")
    whl = aggregate._bilateral_1d(preprocess.pad_edge(lab_l, 1, r, r), cfg, "x")[:, r:we - r]
    H, W = ls.shape[1], we - 2 * r
    K = 2 * r + 1
    wv = np.empty((H, we, D, K), np.float32)
    wh = np.empty((H, W, D, K), np.float32)
    if cfg.asw_symmetric:
        lab_r = torch.movedim(rs[4:7], 0, -1)
        wvr = aggregate._bilateral_1d(lab_r, cfg, "y")
        whr = aggregate._bilateral_1d(preprocess.pad_edge(lab_r, 1, r, r), cfg, "x")
    for d in range(D):
        start = D - 1 - d
        if cfg.asw_symmetric:
            wv[:, :, d] = (wvl * wvr[:, start:start + we]).numpy()
            wh[:, :, d] = (whl * whr[:, start + r:start + we - r]).numpy()
        else:
            wv[:, :, d] = wvl.numpy()
            wh[:, :, d] = whl.numpy()
    return vol.numpy(), wv, wh


@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "left_only"])
@pytest.mark.parametrize("H,W,D,r,plan", [
    (29, 130, 40, 5, (6, 72, 32, 11)),   # several row blocks, ragged rows and chunks
    (5, 40, 16, 4, (8, 24, 8, 4)),        # H below TY and below K
    (3, 30, 8, 3, (2, 16, 8, 7)),         # H below K, ragged
    (7, 19, 2, 0, (3, 8, 8, 1)),          # r = 0, D = 2
    (11, 33, 12, 2, (4, 16, 8, 2)),       # D not a multiple of the chunk
])
def test_block_schedule_visits_and_sums(H, W, D, r, plan, sym):
    """Each output row takes (dy, clamp(y + dy - r)) for dy = 0 ... K - 1
    exactly once, in ascending order, and the model's sums agree with the
    plain separable aggregation at the aggregated-volume bar
    (tests/test_oracle_parity.py:65)."""
    cfg = StereoConfig(max_disparity=D, window_radius=r, gamma_color=14.0, gamma_spatial=9.0,
                       asw_separable=True, asw_symmetric=sym)
    p = synthetic.make_pair(height=H, width=W, max_disparity=D, seed=H + W)
    ls, rs = stacks(torch.from_numpy(p["left"]), torch.from_numpy(p["right"]), cfg)
    vol, wv, wh = _plain_pieces(ls, rs, cfg)
    visits = [[] for _ in range(H)]
    got = _block_model(vol, wv, wh, r, asw_sep_kernel.TilePlan(*plan), visits)
    K = 2 * r + 1
    for y in range(H):
        assert visits[y] == [(dy, min(max(y + dy - r, 0), H - 1)) for dy in range(K)]
    ref = aggregate.aggregate_asw_separable_from_stacks(ls, rs, cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)


def test_block_schedule_at_the_default_plan_bf16():
    """The model at tile_plan's own plan for chip_smoke.py's multi-row
    symmetric case, with bfloat16 cost storage, against the plain version
    in the same storage mode."""
    case = {c[0]: c for c in chip_smoke.SEP_SMALL_CASES}["sep_rows_sym"]
    cfg = StereoConfig(**{**chip_smoke._BASE, **case[1], "volume_dtype": "bfloat16"})
    H, W = case[2]
    p = synthetic.make_pair(height=H, width=W, max_disparity=cfg.max_disparity, seed=3)
    ls, rs = stacks(torch.from_numpy(p["left"]), torch.from_numpy(p["right"]), cfg)
    vol, wv, wh = _plain_pieces(ls, rs, cfg, storage=torch.bfloat16)
    plan = asw_sep_kernel.tile_plan(H, W, cfg.max_disparity, cfg.window_radius, True)
    got = _block_model(vol, wv, wh, cfg.window_radius, plan)
    ref = aggregate.aggregate_asw_separable_from_stacks(
        ls, rs, cfg, storage_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)
