"""K4's tile plan and stage schedule, on the CPU.

``asw_sym_dlanes_kernel.tile_plan`` sizes the symmetric d-lanes CUDA
kernel's blocks (``asw_sym_dlanes_kernel.cu``); these tests hold every plan
of a grid of geometries to what the kernel needs (it fits the card's shared
memory and thread limits, its consumer threads' register tiles cover every
column and disparity of a block exactly once, its stages cover every tap),
pin the plans of the main geometries, and check that chip_smoke.py's
multi-row K4 cases really span several blocks of rows.  A numpy model of
the schedule, producer and consumer warps handing stages through two
stage buffers and three input buffers in any interleaving the named
barriers allow, gives every output row its (dy, dx) taps exactly once and
in order, never lets a stage read a buffer that holds another stage, and
sums to the plain exact aggregation at the aggregated-volume bar.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from aswstereomatch_torch.config import StereoConfig
from aswstereomatch_torch.ops import aggregate
from aswstereomatch_torch.ops.cuda import asw_sym_dlanes_kernel as k4
from aswstereomatch_torch.ops.cuda.common import stacks
from aswstereomatch_torch.utils import synthetic

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

GEOMETRIES = [(375, 1242), (375, 450), (29, 130), (1, 1)]


def _consumer_tiles(plan):
    """(row, column, disparity offset) triples the consumer threads of one
    block own, as asw_sym_dlanes_kernel.cu maps them: per row (tx / 8) x
    (dc / 4) threads, each with columns xb + i (i < 8) and disparities
    db + j (j < 4); threads past the tiles own nothing."""
    ty, tx, dc, kx = plan
    dg = dc // 4
    per_row = (tx // 8) * dg
    for ctid in range(plan.consumers()):
        t, q = divmod(ctid, per_row)
        if t >= ty:
            continue
        xb, db = q // dg * 8, q % dg * 4
        for i in range(8):
            for j in range(4):
                yield t, xb + i, db + j


@pytest.mark.parametrize("r", [0, 1, 2, 5, 16, 24, 31])
@pytest.mark.parametrize("D", [2, 3, 8, 13, 40, 64, 77, 120, 128])
def test_tile_plan_fits_and_covers(D, r):
    K = 2 * r + 1
    for H, W in GEOMETRIES:
        plan = k4.tile_plan(H, W, D, r)
        ty, tx, dc, kx = plan
        assert plan.fits(D, r)
        assert plan.smem_bytes(D) <= 232_448
        assert plan.threads() <= 640 and plan.consumers() % 128 == 0
        assert tx % 8 == 0 and dc % 8 == 0 and dc == -(-D // 8) * 8  # one d-chunk
        assert 1 <= ty <= H and 1 <= kx <= K
        # whole tiles over the image and the disparities
        assert -(-W // tx) * tx >= W and -(-D // dc) * dc >= D
        owned = list(_consumer_tiles(plan))
        assert len(owned) == len(set(owned)) == ty * tx * dc
        # every tap: runs of kx window columns cover 0..K-1 once; the stack
        # rows a block walks give each of its rows each dy once
        runs = [dx for dx0 in range(0, K, kx) for dx in range(dx0, min(dx0 + kx, K))]
        assert runs == list(range(K))
        nrows = min(ty, H)
        for t in range(nrows):
            assert [s + r - t for s in range(-r, nrows + r) if 0 <= s + r - t < K] == list(range(K))


def test_tile_plan_of_the_main_geometries():
    """The plans the main path runs (PERF.md section 6 records their times):
    whole consumer warpgroups, so every launched thread works, also at D = 64."""
    plan = k4.tile_plan
    assert plan(375, 1242, 128, 16) == (2, 48, 128, 33)
    assert plan(375, 450, 64, 16) == (3, 64, 64, 33)
    assert plan(375, 1242, 128, 16).smem_bytes(128) == 229_760
    assert plan(375, 450, 64, 16).smem_bytes(64) == 229_632
    for args in ((375, 1242, 128, 16), (375, 450, 64, 16), (375, 1242, 64, 16)):
        p = plan(*args)
        assert p.tiles() == p.consumers() == 384 and p.threads() == 640


def test_tile_plan_shrinks_rather_than_refuses():
    """Where shared memory runs short the plan gives up rows and columns
    before it splits the window columns into runs; one row of 8 columns
    with runs of one window column fits every supported geometry, chunks
    of fewer disparities carry the WTA state, and plans the kernel cannot
    run do not fit."""
    for D in (2, 64, 128):
        assert k4.TilePlan(1, 8, -(-D // 8) * 8, 1).fits(D, 31)
    assert not k4.TilePlan(1, 4, 8, 1).fits(8, 31)          # columns: a multiple of 8
    wide = k4.tile_plan(375, 1242, 128, 31)
    assert wide.kx == 63 and wide.fits(128, 31) and wide.tx < 48
    assert not k4.TilePlan(2, 48, 128, 63).fits(128, 31)
    two_chunks = k4.TilePlan(2, 48, 64, 33)
    assert two_chunks.smem_bytes(128) == two_chunks.smem_bytes(64) + 4 * 11 * 2 * 48
    assert not k4.TilePlan(2, 64, 128, 33).fits(128, 16)    # 512 consumer threads
    assert not k4.TilePlan(2, 48, 128, 34).fits(128, 16)    # kx > K
    assert not k4.TilePlan(1, 96, 128, 33).fits(128, 16)     # shared memory
    assert k4.with_longest_run(k4.TilePlan(1, 96, 128, 33), 128, 16).kx == 27


@pytest.mark.parametrize("name", ["sdl_rows", "sdl_rows_d64"])
def test_multirow_smoke_cases_span_several_row_blocks(name):
    """chip_smoke.py's two multi-row K4 cases: H at least 3 x the plan's
    rows and not a multiple of them, more than one column tile; the second
    at D = 64 with every consumer thread at work."""
    case = {c[0]: c for c in chip_smoke.SYM_DLANES_SMALL_CASES}[name]
    cfg = StereoConfig(**{**chip_smoke._BASE, **case[1]})
    H, W = case[2]
    plan = k4.tile_plan(H, W, cfg.max_disparity, cfg.window_radius)
    assert plan.ty >= 2 and H >= 3 * plan.ty and H % plan.ty != 0 and W > plan.tx
    assert k4.supports(cfg) and k4.routed(cfg)
    if cfg.max_disparity == 64:
        assert plan.tiles() == plan.consumers()


def _stage(plan, y0, nrows, r, k):
    """Stage k of a block at rows y0 ..: (stack row s, first window column
    dx0, run length kx, output rows t_lo .. t_lo + nt - 1 whose weights the
    producers build), asw_sym_dlanes_kernel.cu's index arithmetic."""
    K = 2 * r + 1
    nkx = -(-K // plan.kx)
    s = y0 - r + k // nkx
    dx0 = (k % nkx) * plan.kx
    t_lo = max(0, s - r - y0)
    nt = min(nrows - 1, s + r - y0) - t_lo + 1
    return s, dx0, min(plan.kx, K - dx0), t_lo, nt


def _ring(nst, rng, unreleased=2):
    """One interleaving of the producers and consumers of a block over nst
    stages, as the named barriers allow it, with the buffers each stage
    touches (asw_sym_dlanes_kernel.cu):
      - producers, stage k: once the consumers have arrived on empty for
        stage k - 2 (k >= 2), wait for stage k's rows (input buffer k % 3),
        start the copies of stage k + 1's rows into buffer (k + 1) % 3,
        build stage k's weights into stage buffer k % 2, and arrive on full;
      - consumers, stage k: once full has come for stage k, build its
        raw-cost row into stage buffer k % 2 from input buffer k % 3, run its
        FMAs, and arrive on empty where k + unreleased < nst (the kernel's
        2: the producers wait for no release past stage nst - 3).
    Yields ("build", k) and ("run", k) in order; raises on a deadlock, or on
    a buffer that holds another stage when it is read, or that is refilled
    while a stage still needs it."""
    built, ran, released = 0, 0, set()
    rows = [0, None, None]         # stage whose rows each input buffer holds
    weights = [None] * 2
    while ran < nst:
        can_build = built < nst and (built < 2 or built - 2 in released)
        can_run = ran < built
        assert can_build or can_run, "deadlock"
        if can_build and (not can_run or rng.random() < 0.5):
            k = built
            assert rows[k % 3] == k, "producers read another stage's rows"
            if k + 1 < nst:
                old = rows[(k + 1) % 3]
                # the producers built that stage, and the consumers its raw costs
                assert old is None or (old < k and old < ran), "rows refilled while read"
                rows[(k + 1) % 3] = k + 1
            assert weights[k % 2] is None or weights[k % 2] < ran, "weights refilled while read"
            weights[k % 2] = k
            yield "build", k
            built += 1
        else:
            k = ran
            assert weights[k % 2] == k and rows[k % 3] == k, "a consumer read another stage"
            yield "run", k
            if k + unreleased < nst:
                released.add(k)
            ran += 1


def _block_model(vol, wgt, r, plan, rng, visits):
    """The (H, W, D) aggregated volume as asw_sym_dlanes_kernel.cu's blocks
    compute it, in float32: per block and d-chunk, stages (stack row, run)
    through the two-buffer ring, each consumer row adding t * C and t over
    its run, dx ascending.  vol[s, u, d] is the raw cost of extended column
    u; wgt[y, x, d, dy, dx] the plain version's weight products.
    ``visits[y]`` collects (dy, dx, stack row) in the order row y takes
    them."""
    H, WL, D = vol.shape
    K = 2 * r + 1
    W = WL - 2 * r
    ty, tx, dc, kx = plan
    out = np.zeros((H, W, D), np.float32)
    for y0 in range(0, H, ty):
        nrows = min(ty, H - y0)
        nst = (nrows + 2 * r) * -(-K // kx)
        for x0 in range(0, W, tx):
            nx = min(tx, W - x0)
            for d0 in range(0, D, dc):
                d1 = min(d0 + dc, D)
                num = np.zeros((nrows, nx, d1 - d0), np.float32)
                den = np.zeros_like(num)
                built = {}
                for event, k in _ring(nst, rng):
                    s, dx0, n, t_lo, nt = _stage(plan, y0, nrows, r, k)
                    if event == "build":
                        built[k % 2] = (k, set(range(t_lo, t_lo + nt)))
                        continue
                    assert built[k % 2][0] == k
                    yy = min(max(s, 0), H - 1)
                    for t in range(nrows):
                        dy = s - (y0 + t) + r
                        if not 0 <= dy < K:
                            continue
                        assert t in built[k % 2][1], "weights of a covered row not built"
                        for dx in range(dx0, dx0 + n):
                            w = wgt[y0 + t, x0:x0 + nx, d0:d1, dy, dx]
                            den[t] += w
                            num[t] += w * vol[yy, x0 + dx:x0 + dx + nx, d0:d1]
                            if d0 == 0 and x0 == 0:
                                visits[y0 + t].append((dy, dx, yy))
                out[y0:y0 + nrows, x0:x0 + nx, d0:d1] = num / den
    return out


def _plain_pieces(ls, rs, cfg):
    """The raw cost volume (H, W + 2r, D) and the weight products
    (H, W, D, K, K) of the plain version (aggregate.aggregate_asw_from_stacks)."""
    r, D = cfg.window_radius, cfg.max_disparity
    K = 2 * r + 1
    W = ls.shape[2] - 2 * r
    vol = aggregate.cost_volume_from_stacks(ls, rs, cfg).numpy()
    wl = aggregate.bilateral_planes_from_lab(torch.movedim(ls[4:7], 0, -1), cfg)
    wr = aggregate.bilateral_planes_from_lab(torch.movedim(rs[4:7], 0, -1), cfg)
    wgt = np.stack([(wl * wr[:, D - 1 - d:D - 1 - d + W]).numpy() for d in range(D)], axis=2)
    return vol, wgt.reshape(*wgt.shape[:3], K, K)


@pytest.mark.parametrize("H,W,D,r,plan", [
    (29, 130, 40, 5, (3, 72, 40, 11)),   # several row blocks, ragged rows and columns
    (5, 40, 16, 4, (8, 24, 8, 4)),       # H below TY and K; two d-chunks; runs 4, 4, 1
    (3, 30, 8, 3, (2, 16, 8, 7)),        # H below K, ragged
    (7, 19, 2, 0, (3, 8, 8, 1)),         # r = 0, D = 2
    (11, 33, 12, 2, (4, 16, 8, 2)),      # D not a multiple of the chunk; runs 2, 2, 1
])
def test_stage_schedule_visits_and_sums(H, W, D, r, plan):
    """Each output row takes (dy, dx) for dy = 0 ... K - 1, then dx = 0 ...
    K - 1, exactly once, from stack row clamp(y + dy - r), under random
    interleavings of the two roles; the model's sums agree with the plain
    exact aggregation at the aggregated-volume bar
    (tests/test_oracle_parity.py:65)."""
    plan = k4.TilePlan(*plan)
    assert plan.fits(D, r)
    cfg = StereoConfig(max_disparity=D, window_radius=r, gamma_color=14.0, gamma_spatial=9.0,
                       kernel_layout="dlanes")
    p = synthetic.make_pair(height=H, width=W, max_disparity=D, seed=H + W)
    ls, rs = stacks(torch.from_numpy(p["left"]), torch.from_numpy(p["right"]), cfg)
    vol, wgt = _plain_pieces(ls, rs, cfg)
    K = 2 * r + 1
    ref = aggregate.aggregate_asw_from_stacks(ls, rs, cfg).numpy()
    for seed in range(3):
        visits = [[] for _ in range(H)]
        got = _block_model(vol, wgt, r, plan, np.random.default_rng(seed), visits)
        for y in range(H):
            assert visits[y] == [(dy, dx, min(max(y + dy - r, 0), H - 1))
                                 for dy in range(K) for dx in range(K)]
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)


def test_ring_deadlocks_on_a_mismatched_hand_off():
    """The ring model is not vacuous: it runs every stage once, in order,
    and consumers that withhold one more release than the producers wait
    for deadlock it."""
    events = list(_ring(7, np.random.default_rng(0)))
    assert [k for e, k in events if e == "run"] == list(range(7))
    assert [k for e, k in events if e == "build"] == list(range(7))
    with pytest.raises(AssertionError, match="deadlock"):
        list(_ring(7, np.random.default_rng(0), unreleased=3))
