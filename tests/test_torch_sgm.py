"""Semi-global aggregation in the port (``aggregation="sgm"``) on the CPU.

The plain version (``ops/cuda/sgm_kernel.aggregate_reference``, what the
wrapper computes for a CPU tensor) against the reference's packed-scan
``aggregate_sgm`` bit for bit: the recurrence is adds and mins only, taken
in the reference's order.  A numpy model of the CUDA kernel's scanline
schedule (one line per warp, first pixel L = C, directions summed in the
pinned order) against the plain version bit for bit.  The pipeline against
the reference's jnp path and the loop oracle at tests/test_sgm.py's bars,
the zero-penalty identity, the hard-regime accuracy claim, the matcher's
batch and the refusal of y_chunks.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import oracle_numpy as oracle
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.ops import aggregate as ref_aggregate

import aswstereomatch_torch as asm
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops import aggregate, cost
from aswstereomatch_torch.ops.cuda import sgm_kernel
from aswstereomatch_torch.utils import convert, evaluate, synthetic

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _ref_cfg(**kw):
    base = dict(max_disparity=12, cost="tad_grad", aggregation="sgm",
                lr_check=True, fill_holes=True, subpixel=True, median_filter=True)
    base.update(kw)
    return RefConfig(**base)


def _volume(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 40.0).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """tests/test_sgm.py's pair."""
    return synthetic.make_pair(height=32, width=56, max_disparity=12, seed=5)


def assert_agree(d_t, d_ref, bar=0.995, gross=0.002):
    """tests/test_oracle_parity.py:141-143."""
    diff = np.abs(d_t - d_ref)
    assert np.mean(diff <= 0.51) > bar, f"disagreement {np.mean(diff > 0.51):.4%}"
    assert np.mean(diff > 2.0) < gross


PENALTIES = [(8.0, 32.0), (0.0, 0.0), (3.0, 50.0)]
DS = [1, 2, 9, 33]


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("hw", [(1, 9), (9, 1), (13, 7), (7, 13)],
                         ids=["h1", "w1", "tall", "wide"])
def test_plain_sgm_equals_reference_bit_for_bit(hw, D, paths):
    """On a random volume: H = 1 and W = 1 (lines of one pixel), H > W and
    W > H (diagonals starting on both edges), D = 1 (no d-neighbours) and
    D = 33 (past one 32-lane chunk); the penalty pair cycles with D and
    the paths, so that each shape meets each pair of PENALTIES."""
    vol = _volume((*hw, D), seed=hw[0] * 100 + hw[1] + D)
    p1, p2 = PENALTIES[(DS.index(D) + (paths == 8)) % len(PENALTIES)]
    ref_cfg = RefConfig(aggregation="sgm", max_disparity=D, sgm_paths=paths,
                        sgm_p1=p1, sgm_p2=p2)
    want = np.asarray(J(ref_aggregate.aggregate_sgm, cfg=ref_cfg)(jnp.asarray(vol)))
    got = sgm_kernel.aggregate(T(vol), port(ref_cfg))
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"p1={p1} p2={p2}")


@pytest.mark.parametrize("paths", [4, 8])
def test_sgm_volume_matches_oracle(pair, paths):
    """tests/test_sgm.py:46-56's bars: atol 1e-3, argmin agreement > 0.999."""
    ref_cfg = _ref_cfg(sgm_paths=paths)
    vol_t = pipeline.aggregated_volume(T(pair["left"]), T(pair["right"]), port(ref_cfg)).numpy()
    vol_o = oracle.aggregate_sgm(oracle.cost_volume(pair["left"], pair["right"], ref_cfg),
                                 ref_cfg)
    np.testing.assert_allclose(vol_t, vol_o, atol=1e-3)
    assert float(np.mean(vol_t.argmin(-1) == vol_o.argmin(-1))) > 0.999


def _line_start(H, W, dy, dx, i):
    """sgm_kernel.cu's line_start: first pixel and length of scanline i."""
    if dy == 0:
        y, x = i, (0 if dx > 0 else W - 1)
    elif dx == 0:
        y, x = (0 if dy > 0 else H - 1), i
    elif i < W:
        y, x = (0 if dy > 0 else H - 1), i
    else:
        j = i - W + 1
        y, x = (j if dy > 0 else H - 1 - j), (0 if dx > 0 else W - 1)
    ny = H - y if dy > 0 else (y + 1 if dy < 0 else H)
    nx = W - x if dx > 0 else (x + 1 if dx < 0 else W)
    return y, x, (nx if dy == 0 else (ny if dx == 0 else min(ny, nx)))


def _kernel_model(vol, paths, p1, p2):
    """sgm_kernel.cu's schedule in numpy: each direction's scanlines
    (rows, columns, or diagonals from their first in-image pixel), L = C at
    a line's first pixel, the recurrence over the previous pixel's row with
    +inf guards at d = -1 and D, and S = L for the first direction, S + L
    for each later one.  Every pixel lies on exactly one line per
    direction."""
    H, W, D = vol.shape
    p1, p2 = np.float32(p1), np.float32(p2)
    S = np.empty_like(vol)
    for j, (dy, dx) in enumerate(sgm_kernel.DIRECTIONS[:paths]):
        cover = np.zeros((H, W), int)
        for i in range(H if dy == 0 else (W if dx == 0 else H + W - 1)):
            y, x, n = _line_start(H, W, dy, dx, i)
            prev = None
            for t in range(n):
                yy, xx = y + t * dy, x + t * dx
                cover[yy, xx] += 1
                c = vol[yy, xx]
                if t == 0:
                    v = c
                else:
                    pmin = prev.min()
                    g = np.concatenate([[np.inf], prev, [np.inf]]).astype(np.float32)
                    best = np.minimum(np.minimum(g[1:-1], pmin + p2),
                                      np.minimum(g[:-2], g[2:]) + p1)
                    v = (c + best) - pmin
                S[yy, xx] = v if j == 0 else S[yy, xx] + v
                prev = v
        assert (cover == 1).all(), f"direction {(dy, dx)} does not cover each pixel once"
    return S


@pytest.mark.parametrize("shape", [(1, 6, 3), (6, 1, 2), (1, 1, 4), (9, 5, 33), (5, 9, 1),
                                   (11, 14, 7)])
@pytest.mark.parametrize("paths", [4, 8])
def test_kernel_schedule_model_equals_plain_version(shape, paths):
    vol = _volume(shape, seed=sum(shape))
    for p1, p2 in PENALTIES:
        cfg = asm.StereoConfig(aggregation="sgm", max_disparity=shape[2], sgm_paths=paths,
                               sgm_p1=p1, sgm_p2=p2)
        want = sgm_kernel.aggregate_reference(T(vol), cfg).numpy()
        np.testing.assert_array_equal(_kernel_model(vol, paths, p1, p2), want)


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize(
    "kw", [dict(), dict(median_mode="weighted"), dict(uniqueness_ratio=10.0, fill_holes=False),
           dict(lr_check=False, subpixel=False)],
    ids=["default", "weighted_median", "uniqueness_nofill", "no_lr_no_subpix"])
def test_sgm_pipeline_matches_jnp_and_oracle(pair, kw, paths):
    """Against the reference's jnp pipeline at assert_agree's bars, and
    against the loop oracle at tests/test_sgm.py:59-67's (the same valid
    pixels, atol 1e-4)."""
    ref_cfg = _ref_cfg(sgm_paths=paths, **kw)
    d_t = pipeline.match_pair(T(pair["left"]), T(pair["right"]), port(ref_cfg)).numpy()
    assert d_t.dtype == np.float32 and d_t.shape == pair["gt"].shape
    d_j = np.asarray(J(ref_pipeline.match_pair, cfg=ref_cfg.replace(backend="jnp"))(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    assert_agree(d_t, d_j)
    if paths == 4:
        d_o = oracle.match_pair(pair["left"], pair["right"], ref_cfg)
        np.testing.assert_array_equal(d_t >= 0, d_o >= 0)
        np.testing.assert_allclose(d_t, d_o, atol=1e-4)


def test_sgm_zero_penalties_is_raw_cost(pair):
    """tests/test_sgm.py:70-78: P1 = P2 = 0 gives S = 4 C up to ~1 ulp per
    scan step."""
    cfg = port(_ref_cfg(sgm_p1=0.0, sgm_p2=0.0))
    l, r = T(pair["left"]), T(pair["right"])
    vol = pipeline.aggregated_volume(l, r, cfg).numpy()
    raw = cost.cost_volume(l, r, cfg).numpy()
    np.testing.assert_allclose(vol, 4.0 * raw, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(vol.argmin(-1), raw.argmin(-1))


def test_sgm_beats_local_asw_dense_on_hard_regime():
    """tests/test_sgm.py:81-101 on the port's own make_hard_pair: dense
    semi-global beats dense local ASW on ambiguous content."""
    p = synthetic.make_hard_pair(96, 160, 32, seed=7)
    l, r = T(p["left"]), T(p["right"])
    post = dict(lr_check=True, fill_holes=True, subpixel=True, median_filter=True)
    sgm = pipeline.match_pair(l, r, asm.StereoConfig(max_disparity=32, aggregation="sgm",
                                                     **post)).numpy()
    asw = pipeline.match_pair(l, r, asm.StereoConfig(max_disparity=32, aggregation="asw",
                                                     window_radius=8, **post)).numpy()
    nonocc = ~p["occluded"]
    b_sgm = evaluate.bad_report(sgm, p["gt"], valid=nonocc)["bad_2"]
    b_asw = evaluate.bad_report(asw, p["gt"], valid=nonocc)["bad_2"]
    assert b_sgm < b_asw, (b_sgm, b_asw)


def test_sgm_matcher_batch_equals_singles(pair):
    m = asm.StereoMatcher(port(_ref_cfg()), device="cpu")
    p2 = synthetic.make_pair(height=32, width=56, max_disparity=12, seed=9)
    singles = [m(p["left"], p["right"]) for p in (pair, p2)]
    out = m.batch(np.stack([pair["left"], p2["left"]]), np.stack([pair["right"], p2["right"]]))
    assert tuple(out.shape) == (2, 32, 56)
    for i in range(2):
        torch.testing.assert_close(out[i], singles[i], rtol=0, atol=0)


def test_sgm_rejects_y_chunks(pair):
    l, r = T(pair["left"]), T(pair["right"])
    with pytest.raises(ValueError, match="sgm"):
        pipeline.match_pair(l, r, port(_ref_cfg(y_chunks=2)))
    with pytest.raises(ValueError, match="sgm"):
        pipeline.match_pair_chunked(l, r, port(_ref_cfg(y_chunks=4)))


def test_sgm_aggregate_checks_its_input():
    cfg = asm.StereoConfig(aggregation="sgm", max_disparity=4)
    vol = T(_volume((5, 6, 4), seed=1))
    with pytest.raises(ValueError, match="float32"):
        sgm_kernel.aggregate(vol.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        sgm_kernel.aggregate(vol.transpose(0, 1), cfg)
    with pytest.raises(ValueError, match="disparities"):
        sgm_kernel.aggregate(vol, cfg.replace(max_disparity=5))
    with pytest.raises(ValueError, match="no kernel for device"):
        sgm_kernel.aggregate(vol.to("meta"), cfg)
    # aggregate_sgm defers to the wrapper
    torch.testing.assert_close(aggregate.aggregate_sgm(vol, cfg),
                               sgm_kernel.aggregate_reference(vol, cfg), rtol=0, atol=0)


def test_sgm_bound_counts_bytes():
    """chip_smoke.sgm_bound: one read of C and one write of S at 3.35 TB/s,
    0.142 ms at KITTI, whatever the number of paths; the operations stay
    below the bytes."""
    cfg = asm.get_preset("kitti_sgm")
    for paths in (4, 8):
        ms, by = chip_smoke.sgm_bound(375, 1242, cfg.replace(sgm_paths=paths))
        assert by == "bytes" and ms == pytest.approx(2 * 4 * 375 * 1242 * 128 / 3.35e12 * 1e3)
    assert 0.142 < chip_smoke.sgm_bound(375, 1242, cfg)[0] < 0.143
