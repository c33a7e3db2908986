"""Semi-global aggregation in the port (``aggregation="sgm"``) on the CPU.

The plain version (``ops/cuda/sgm_kernel.aggregate_reference``, what the
wrapper computes for a CPU tensor) against the reference's packed-scan
``aggregate_sgm`` bit for bit: the recurrence is adds and mins only, taken
in the reference's order.  A numpy model of the CUDA kernel's schedule
(its plan's phases, one line per warp, first pixel L = C, each lane's
disparities padded with +inf, the scratch volumes and the completing
direction's ordered sum) against the plain version bit for bit, and the
plan itself: each scanline handed out once, the rings within the shared
memory they ask for, at most two scratch volumes, 3 P - 1 volumes moved;
a plan off its path count's schedule refused.  The pipeline against
the reference's jnp path and the loop oracle at tests/test_sgm.py's bars,
the zero-penalty identity, the hard-regime accuracy claim, the matcher's
batch and the refusal of y_chunks.
"""

import dataclasses
import functools
import importlib.util
import json
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
    vol_t = aggregate.aggregated_volume(T(pair["left"]), T(pair["right"]), port(ref_cfg)).numpy()
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


def _kernel_model(vol, paths, p1, p2, plan=None):
    """sgm_kernel.cu's schedule in numpy, phase by phase from the plan
    (sgm_kernel.plan by default): each slot's scanlines in hand-out order
    (rows, columns, or diagonals from their first in-image pixel), L = C at
    a line's first pixel, and the recurrence over the previous pixel's L as
    the lanes hold it: 32 x VPL entries, +inf past D, the d -+ 1 neighbours
    shifted in with +inf at both ends (the long-D path's guarded row, VPL 0,
    is the same vector at width D).  Each role stores S = L, X1 = L, X2 = L,
    S = S + L or S = ((S + X1) + X2) + L, reading S, X1 and X2 as the phase
    before left them (NaN where nothing wrote, as torch.empty may hold);
    each output element is written at most once a phase, and every
    direction covers each pixel once."""
    H, W, D = vol.shape
    plan = plan or sgm_kernel.plan(H, W, D, paths)
    width = 32 * plan.vpl if plan.vpl else D
    p1, p2 = np.float32(p1), np.float32(p2)
    inf = np.float32(np.inf)
    out = {k: np.full_like(vol, np.nan) for k in ("S", "X1", "X2")}
    target = {sgm_kernel.WRITE_S: "S", sgm_kernel.WRITE_X1: "X1", sgm_kernel.WRITE_X2: "X2",
              sgm_kernel.ADD_S: "S", sgm_kernel.COMPLETE_S: "S"}
    for phase in plan.phases:
        before = {k: v.copy() for k, v in out.items()}
        written = {k: np.zeros((H, W), int) for k in out}
        for slot in phase.slots:
            cover = np.zeros((H, W), int)
            for i in range(slot.n_lines):
                y, x, n = _line_start(H, W, slot.dy, slot.dx, i)
                prev = None
                for t in range(n):
                    yy, xx = y + t * slot.dy, x + t * slot.dx
                    cover[yy, xx] += 1
                    c = np.full(width, inf)
                    c[:D] = vol[yy, xx]
                    if t == 0:
                        v = c
                    else:
                        pmin = prev.min()
                        up = np.concatenate([[inf], prev[:-1]])
                        dn = np.concatenate([prev[1:], [inf]])
                        best = np.minimum(np.minimum(prev, pmin + p2), np.minimum(up, dn) + p1)
                        v = (c + best) - pmin
                        v[D:] = inf
                    L = v[:D]
                    if slot.role == sgm_kernel.ADD_S:
                        L = before["S"][yy, xx] + L
                    elif slot.role == sgm_kernel.COMPLETE_S:
                        L = ((before["S"][yy, xx] + before["X1"][yy, xx])
                             + before["X2"][yy, xx]) + L
                    key = target[slot.role]
                    out[key][yy, xx] = L
                    written[key][yy, xx] += 1
                    prev = v
            assert (cover == 1).all(), f"direction {slot[:2]} does not cover each pixel once"
        assert all((w <= 1).all() for w in written.values()), "an element written twice"
    return out["S"]


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


@pytest.mark.parametrize("vpl, D", [(0, 36), (4, 36), (4, 8)], ids=["long_d", "d36", "d8"])
@pytest.mark.parametrize("paths", [4, 8])
def test_kernel_schedule_model_any_lane_width(vpl, D, paths):
    """The long-D path's guarded row (a plan with VPL 0) and lanes wider
    than D needs (+inf padding; most lanes idle at D = 8) give the plain
    version's bits too."""
    shape = (7, 10, D)
    vol = _volume(shape, seed=vpl + paths + D)
    cfg = asm.StereoConfig(aggregation="sgm", max_disparity=shape[2], sgm_paths=paths)
    plan = sgm_kernel.plan(*shape, paths, vpl=vpl)
    assert plan.vpl == vpl
    want = sgm_kernel.aggregate_reference(T(vol), cfg).numpy()
    np.testing.assert_array_equal(
        _kernel_model(vol, paths, cfg.sgm_p1, cfg.sgm_p2, plan), want)


def _take_line(phase, g):
    """sgm_kernel.cu's take_line: warp g's (direction, line), None past the
    phase's last line."""
    first = 0
    for slot in phase.slots:
        if g < first + slot.n_lines:
            return (slot.dy, slot.dx), g - first
        first += slot.n_lines
    return None


PLAN_DS = sorted({c[1][2] for c in chip_smoke.SGM_SMALL_CASES}
                 | {c.max_disparity for c in asm.PRESETS.values()}
                 | {sgm_kernel.REG_MAX_D, sgm_kernel.REG_MAX_D + 1, 6143})
# The largest geometry a benchmark cell runs on the long-D path: MiddEval3
# at half resolution, 994 x 1440, D = 256.
MIDDEVAL3_H = chip_smoke.MIDDEVAL3_H_SHAPE


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("D", PLAN_DS)
def test_plan_hands_out_each_scanline_once_and_fits(D, paths):
    """Every scanline of every direction lies in exactly one phase's work
    table, once; the ring (or the long-D path's rows) fits the shared
    memory the plan asks for; at most two scratch volumes, with their
    bytes; 3 P - 1 volumes moved, as chip_smoke.sgm_schedule_bytes counts."""
    cfg = asm.StereoConfig(aggregation="sgm", max_disparity=D, sgm_paths=paths)
    shapes = [(375, 1242), (3, 200), (1, 1), (40, 1), (50, 7)]
    for H, W in shapes + ([MIDDEVAL3_H] if D == 256 else []):
        p = sgm_kernel.plan(H, W, D, paths)
        if (H, W, D) == (*MIDDEVAL3_H, 256):
            assert p.vpl == 0 and not p.row_floats, "the long-D path, its rows in shared memory"
        assert len(p.phases) == paths // 2
        seen = []
        for phase in p.phases:
            total = sum(s.n_lines for s in phase.slots)
            warps = sgm_kernel.WARPS
            seen += [_take_line(phase, g) for g in range(-(-total // warps) * warps)]
            lengths = [sgm_kernel.longest_line(H, W, s.dy, s.dx) for s in phase.slots]
            assert lengths == sorted(lengths, reverse=True), "longest scanlines first"
            assert phase.nvol == max(sgm_kernel.ROLE_VOLUMES[s.role] for s in phase.slots)
            assert phase.smem_bytes <= sgm_kernel.SMEM_OPTIN
            if p.vpl:
                assert p.vpl == sgm_kernel.VPL and D <= sgm_kernel.REG_MAX_D and D % p.vpl == 0
                assert phase.smem_bytes == (warps * sgm_kernel.DEPTH * phase.nvol * 32 * p.vpl
                                            * 4)
            else:
                assert D > sgm_kernel.REG_MAX_D or D % sgm_kernel.VPL
                if phase.smem_bytes:
                    assert 2 * (D + 2) * 4 <= sgm_kernel.ROW_SMEM_BUDGET
                    assert phase.smem_bytes == warps * 2 * (D + 2) * 4 and not p.row_floats
                else:
                    assert 2 * (D + 2) * 4 > sgm_kernel.ROW_SMEM_BUDGET
                    assert p.row_floats >= total * 2 * (D + 2)
        lines = [x for x in seen if x is not None]
        want = [((dy, dx), i) for dy, dx in sgm_kernel.DIRECTIONS[:paths]
                for i in range(sgm_kernel.lines_of(H, W, dy, dx))]
        assert sorted(lines) == sorted(want) and len(set(lines)) == len(lines)
        assert p.scratch_volumes <= 2
        assert 4 * p.scratch_floats(H, W, D) == 4 * (2 * H * W * D + p.row_floats)
        assert p.volumes_moved() == 3 * paths - 1
        assert chip_smoke.sgm_schedule_bytes(H, W, cfg) == 4 * H * W * D * p.volumes_moved()
        assert len(p.ints()) == 4 + 15 * len(p.phases)


def _off_schedule_plans():
    """Plans of a (5, 6, 8) volume that do not run their path count's
    schedule: each sums fewer paths, or in another order, or over other
    scanlines."""
    p4 = sgm_kernel.plan(5, 6, 8, 4)
    a, b = p4.phases
    swapped = tuple(s._replace(role={sgm_kernel.WRITE_X1: sgm_kernel.WRITE_X2,
                                     sgm_kernel.WRITE_X2: sgm_kernel.WRITE_X1}.get(s.role, s.role))
                    for s in a.slots)
    return {
        "one_phase": (p4._replace(phases=(a,)), 4),
        "four_paths_for_eight": (p4, 8),
        "one_slot": (p4._replace(phases=(a._replace(slots=a.slots[:1]), b)), 4),
        "scratch_roles_swapped": (p4._replace(phases=(a._replace(slots=swapped), b)), 4),
        "other_shape": (sgm_kernel.plan(6, 5, 8, 4), 4),
        "one_scratch_volume": (p4._replace(scratch_volumes=1), 4),
    }


@pytest.mark.parametrize("case", list(_off_schedule_plans()))
def test_aggregate_refuses_a_plan_off_the_schedule(case):
    """A plan that would sum a partial or reordered S raises, on any
    device, before anything runs."""
    plan, paths = _off_schedule_plans()[case]
    cfg = asm.StereoConfig(aggregation="sgm", max_disparity=8, sgm_paths=paths)
    with pytest.raises(ValueError, match="schedule"):
        sgm_kernel.aggregate(T(_volume((5, 6, 8), seed=2)), cfg, plan)


@pytest.mark.parametrize("paths", [4, 8])
def test_aggregate_takes_a_plan_on_the_schedule(paths):
    """The long-D path and a phase's slots in another hand-out order run
    the schedule: accepted, with the plain version's bits."""
    vol = T(_volume((5, 6, 8), seed=3))
    cfg = asm.StereoConfig(aggregation="sgm", max_disparity=8, sgm_paths=paths)
    p = sgm_kernel.plan(5, 6, 8, paths)
    turned = p._replace(phases=tuple(ph._replace(slots=ph.slots[::-1]) for ph in p.phases))
    want = sgm_kernel.aggregate_reference(vol, cfg)
    for plan in (sgm_kernel.plan(5, 6, 8, paths, vpl=0), turned):
        assert torch.equal(sgm_kernel.aggregate(vol, cfg, plan), want)


def test_plan_refuses_the_register_path_off_its_d():
    for D in (5, 33, 130):
        with pytest.raises(ValueError, match="register path"):
            sgm_kernel.plan(4, 4, D, 4, vpl=sgm_kernel.VPL)
        assert sgm_kernel.plan(4, 4, D, 4).vpl == 0


def _ordered(bits):
    """sgm_kernel.cu's order-preserving image of float32 bits (uint32): the
    sign bit of a non-negative float flipped, every bit of a negative one."""
    return np.where(bits >> 31, ~bits, bits ^ np.uint32(0x80000000)).astype(np.uint32)


def _unordered(u):
    return np.where(u >> 31, u ^ np.uint32(0x80000000), ~u).astype(np.uint32)


def test_redux_min_image_is_exact():
    """The integer min of the image is the float min, for negatives, zeros
    and infinities too, and the image inverts exactly."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000),
                           [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 3.4e38]]).astype(np.float32)
    bits = vals.view(np.uint32)
    np.testing.assert_array_equal(_unordered(_ordered(bits)), bits)
    for row in rng.permutation(vals)[:3968].reshape(-1, 32):
        got = _unordered(_ordered(row.view(np.uint32)).min(keepdims=True)).view(np.float32)[0]
        assert got == row.min()
    order = np.argsort(_ordered(bits), kind="stable")
    assert (np.diff(vals[order]) >= 0).all()


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


@pytest.mark.parametrize("D", [136, 130], ids=["d136", "d130_not_a_multiple_of_4"])
def test_sgm_pipeline_past_the_register_path_matches_jnp(D):
    """A disparity range the kernel runs on its long-D path (D > 128, or
    not a multiple of 4), 8 paths, with the uniqueness gate and the LR
    check, as the middeval3_h_sgm configuration runs it: against the
    reference's jnp pipeline at assert_agree's bars."""
    p = synthetic.make_pair(height=12, width=160, max_disparity=D, seed=5)
    ref_cfg = _ref_cfg(max_disparity=D, sgm_paths=8, uniqueness_ratio=10.0)
    assert sgm_kernel.plan(12, 160, D, 8).vpl == 0
    d_t = pipeline.match_pair(T(p["left"]), T(p["right"]), port(ref_cfg)).numpy()
    assert d_t.dtype == np.float32 and d_t.shape == p["gt"].shape
    d_j = np.asarray(J(ref_pipeline.match_pair, cfg=ref_cfg.replace(backend="jnp"))(
        jnp.asarray(p["left"]), jnp.asarray(p["right"])))
    assert_agree(d_t, d_j)


def test_sgm_zero_penalties_is_raw_cost(pair):
    """tests/test_sgm.py:70-78: P1 = P2 = 0 gives S = 4 C up to ~1 ulp per
    scan step."""
    cfg = port(_ref_cfg(sgm_p1=0.0, sgm_p2=0.0))
    l, r = T(pair["left"]), T(pair["right"])
    vol = aggregate.aggregated_volume(l, r, cfg).numpy()
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


def test_sgm_schedule_bytes_counts_volumes():
    """chip_smoke.sgm_schedule_bytes: 11 and 23 volumes of 238 MB at KITTI,
    0.78 and 1.64 ms at 3.35 TB/s."""
    cfg = asm.get_preset("kitti_sgm")
    vol = 4 * 375 * 1242 * 128
    for paths, n in ((4, 11), (8, 23)):
        assert chip_smoke.sgm_schedule_bytes(375, 1242, cfg.replace(sgm_paths=paths)) == n * vol
    assert 0.78 < 11 * vol / chip_smoke.HBM_BYTES * 1e3 < 0.79
    assert 1.63 < 23 * vol / chip_smoke.HBM_BYTES * 1e3 < 1.64


def test_sgm_bound_counts_bytes():
    """chip_smoke.sgm_bound: one read of C and one write of S at 3.35 TB/s,
    0.142 ms at KITTI, whatever the number of paths; the operations stay
    below the bytes."""
    cfg = asm.get_preset("kitti_sgm")
    for paths in (4, 8):
        ms, by = chip_smoke.sgm_bound(375, 1242, cfg.replace(sgm_paths=paths))
        assert by == "bytes" and ms == pytest.approx(2 * 4 * 375 * 1242 * 128 / 3.35e12 * 1e3)
    assert 0.142 < chip_smoke.sgm_bound(375, 1242, cfg)[0] < 0.143


def test_chip_smoke_long_d_path_is_the_benchmarked_config():
    """chip_smoke.py's middeval3_h_sgm path runs the benchmark's
    configuration (benchmark/configs/middeval3_h_sgm.json): kitti_sgm with
    its overrides at its geometry, whose scan plan is the long-D path, and
    sgm_bound reads 0.875 ms there."""
    path = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "middeval3_h_sgm.json"
    conf = json.loads(path.read_text())
    assert conf["preset"] == "kitti_sgm"
    assert chip_smoke.MIDDEVAL3_H_OVERRIDES == conf["overrides"]
    assert chip_smoke.MIDDEVAL3_H_SHAPE == (conf["height"], conf["width"])
    cfg = asm.get_preset("kitti_sgm").replace(**chip_smoke.MIDDEVAL3_H_OVERRIDES)
    assert dataclasses.asdict(cfg) == conf["stereo_config"]
    assert sgm_kernel.plan(*chip_smoke.MIDDEVAL3_H_SHAPE, cfg.max_disparity, cfg.sgm_paths).vpl == 0
    ms, by = chip_smoke.sgm_bound(*chip_smoke.MIDDEVAL3_H_SHAPE, cfg)
    assert by == "bytes" and 0.874 < ms < 0.876
