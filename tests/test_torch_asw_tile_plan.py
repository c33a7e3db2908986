"""K1's tile plan and d-chunk schedule, on the CPU.

``asw_kernel.tile_plan`` sizes the CUDA kernel's blocks; these tests hold
every plan of a grid of geometries to what ``asw_kernel.cu`` needs (it
fits the card's shared memory and thread limits, and its threads' register
tiles, window-column runs and stack rows cover every column, disparity and
tap exactly once).  A numpy model of the kernel's schedule over d-chunks
(the online WTA carried across chunks, the right view folded once per
(tile, chunk) with the packed first-occurrence minimum) must equal the
plain ``wta.planes`` bit for bit on tie-heavy volumes.
"""

import numpy as np
import pytest
import torch

from aswstereomatch_torch.ops import wta
from aswstereomatch_torch.ops.cuda import asw_kernel

MODES = (asw_kernel.SYMMETRIC, asw_kernel.LEFT_ONLY, asw_kernel.BOX)
GEOMETRIES = [(375, 1242), (375, 450), (45, 150), (1, 1)]


def _thread_tiles(plan):
    """(column, d-offset) pairs each thread of one output row owns, as
    asw_kernel.cu maps them: tile column xb + i, disparities db + j and
    dc/2 + db + j, for j < 4."""
    ty, tx, dc, kx = plan
    dg = dc // 8
    for q in range((tx // 4) * dg):
        xb, db = q // dg * 4, q % dg * 4
        for i in range(4):
            for j in range(8):
                yield xb + i, db + (j if j < 4 else dc // 2 + j - 4)


@pytest.mark.parametrize("r", [0, 1, 2, 16, 31, 32, 48])
@pytest.mark.parametrize("D", [1, 2, 8, 64, 127, 128, 129, 256])
def test_tile_plan_fits_and_covers(D, r):
    K = 2 * r + 1
    for H, W in GEOMETRIES:
        for mode in MODES:
            plan = asw_kernel.tile_plan(H, W, D, r, mode)
            ty, tx, dc, kx = plan
            assert plan.smem_bytes(mode) <= 232_448
            assert 1 <= plan.threads() <= asw_kernel.MAX_THREADS
            assert tx % 4 == 0 and dc % 8 == 0 and 8 <= dc <= 128
            assert 1 <= ty <= H and 1 <= kx <= K
            if D > dc:  # one thread per column carries the WTA across chunks
                assert plan.threads() >= ty * tx
            # every column and disparity: whole tiles and chunks, and each
            # (tile column, d-offset) owned by one thread exactly once
            assert -(-W // tx) * tx >= W and -(-D // dc) * dc >= D
            owned = list(_thread_tiles(plan))
            assert len(owned) == len(set(owned)) == tx * dc
            # every tap: runs of kx window columns cover 0..K-1 once; the
            # stack rows a block walks give each of its rows each dy once
            runs = [dx for dx0 in range(0, K, kx) for dx in range(dx0, min(dx0 + kx, K))]
            assert runs == list(range(K))
            nrows = min(ty, H)
            for t in range(nrows):
                dys = [s + r - t for s in range(-r, nrows + r) if 0 <= s + r - t < K]
                assert dys == list(range(K))


def test_tile_plan_of_the_main_geometries():
    """The plans the main path runs (PERF.md section 6 records their times)."""
    plan = asw_kernel.tile_plan
    assert plan(375, 1242, 128, 16, asw_kernel.SYMMETRIC) == (2, 64, 128, 33)
    assert plan(375, 450, 64, 16, asw_kernel.SYMMETRIC) == (4, 60, 64, 33)
    assert plan(288, 384, 16, 4, asw_kernel.BOX) == (16, 64, 16, 9)


def test_tile_plan_shrinks_rather_than_refuses():
    """Large windows: the plan gives up rows, then window columns per stage,
    then columns, and still fits."""
    wide = asw_kernel.tile_plan(375, 1242, 256, 200, asw_kernel.SYMMETRIC)
    assert wide.ty == 1 and wide.kx < 401 and wide.fits(asw_kernel.SYMMETRIC)
    huge = asw_kernel.tile_plan(64, 3000, 256, 4000, asw_kernel.SYMMETRIC)
    assert huge.fits(asw_kernel.SYMMETRIC) and huge.kx < 8001


class _Wta:
    """asw_common.cuh's Wta, in float32."""

    def __init__(self):
        inf = np.float32(np.inf)
        self.bestc, self.cm, self.cp, self.prev = inf, np.float32(0), np.float32(0), np.float32(0)
        self.bestd = 0
        self.c = [inf, inf, inf]
        self.d = [-9, -9, -9]

    def update(self, agg, d):
        if self.bestd == d - 1:
            self.cp = agg
        better = agg < self.bestc
        if better:
            self.cm = self.prev
        (c1, c2, c3), (d1, d2, d3) = self.c, self.d
        lt1, lt2, lt3 = agg < c1, agg < c2, agg < c3
        n3 = (c2, d2) if lt2 else ((agg, d) if lt3 else (c3, d3))
        n2 = (c1, d1) if lt1 else ((agg, d) if lt2 else (c2, d2))
        n1 = (self.bestc, self.bestd) if better else ((agg, d) if lt1 else (c1, d1))
        self.c, self.d = [n1[0], n2[0], n3[0]], [n1[1], n2[1], n3[1]]
        if better:
            self.bestc, self.bestd = agg, d
        self.prev = agg

    def ubest(self):
        u = np.float32(np.inf)
        for c, d in zip(self.c, self.d):
            if abs(d - self.bestd) > 1:
                u = min(u, c)
        return u


def _schedule_model(vol, tx, dc):
    """The kernel's WTA over an aggregated (H, W, D) volume, tile by tile
    and chunk by chunk: each column's Wta carried across chunks; per
    (row, tile, chunk), each right column's first-occurrence minimum of its
    candidates in the tile folded into a packed (cost bits, d) minimum."""
    H, W, D = vol.shape
    out = {k: np.zeros((H, W), np.float32) for k in ("bestc", "cm", "cp", "ubest")}
    out["bestd"] = np.zeros((H, W), np.int32)
    rpack = np.full((H, W), np.iinfo(np.uint64).max, np.uint64)
    for y in range(H):
        for x0 in range(0, W, tx):
            xend = min(x0 + tx, W)
            states = {x: _Wta() for x in range(x0, xend)}
            for d0 in range(0, D, dc):
                dend = min(d0 + dc, D)
                for x, w in states.items():
                    for d in range(d0, dend):
                        w.update(vol[y, x, d], d)
                for xr in range(max(0, x0 - (dend - 1)), xend - d0):
                    bc, bd = np.float32(np.inf), -1
                    for d in range(max(d0, x0 - xr), min(dend - 1, xend - 1 - xr) + 1):
                        if vol[y, xr + d, d] < bc:
                            bc, bd = vol[y, xr + d, d], d
                    if bd >= 0:
                        packed = np.uint64((int(bc.view(np.uint32)) << 32) | bd)
                        rpack[y, xr] = min(rpack[y, xr], packed)
            for x, w in states.items():
                out["bestd"][y, x] = w.bestd
                for k in ("bestc", "cm", "cp"):
                    out[k][y, x] = getattr(w, k)
                out["ubest"][y, x] = w.ubest()
    out["rbestd"] = (rpack & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return out


@pytest.mark.parametrize(
    "D,tx,dc,levels",
    [(45, 8, 32, 3), (70, 12, 32, 4), (129, 8, 128, 2), (33, 4, 32, 2), (9, 8, 8, 3)],
)
def test_chunk_schedule_model_equals_wta_planes(D, tx, dc, levels):
    """Integer-valued costs from a few levels, so that most columns have
    ties within and across chunks: the first-occurrence argmin, the
    parabola triple, ubest and the right view must not depend on where the
    chunk and tile edges fall."""
    rng = np.random.default_rng(D * 100 + tx)
    H, W = 3, 2 * tx + 5
    vol = rng.integers(0, levels, size=(H, W, D)).astype(np.float32)
    got = _schedule_model(vol, tx, dc)
    ref = {k: v.numpy() for k, v in wta.planes(torch.from_numpy(vol)).items()}
    for k in ("bestd", "rbestd", "bestc", "ubest"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    inner = (ref["bestd"] > 0) & (ref["bestd"] < D - 1)
    for k in ("cm", "cp"):
        np.testing.assert_array_equal(got[k][inner], ref[k][inner], err_msg=k)
