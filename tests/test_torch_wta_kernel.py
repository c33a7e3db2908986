"""The eager volume's WTA planes: routing and the WTA kernel's wrapper, on
the CPU.

``models/pipeline.py::_planes`` ends the eager route at
``wta_kernel.planes``, which takes the plain version (``wta.planes``) for CPU
volumes and launches nothing; any other device goes to the kernel's
wrapper, which refuses what the kernel cannot take before any launch.  A
model of ``wta_kernel.cu``'s schedule (its plan and constants read from the
source: staged tiles, K threads a column merged by shuffles, a thread a
residue x' mod D for the right view, its state carried from tile to tile)
checks the tie, NaN and exclusion rules against the plain version and that
every right column is written once.  The kernel itself runs only on a card
(tests/test_torch_wta_cuda.py).
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import aswstereomatch_torch as asm
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops import aggregate, wta
from aswstereomatch_torch.ops.cuda import wta_kernel
from aswstereomatch_torch.utils import synthetic

CU = Path(wta_kernel.__file__).with_suffix(".cu")


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU.read_text()).group(1))


THREADS, NSTAGE, STAGE_FLOATS, GROUPS_PER_THREAD, MAX_D = (
    _const(n) for n in ("THREADS", "NSTAGE", "STAGE_FLOATS", "GROUPS_PER_THREAD", "MAX_D"))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _assert_planes(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert _bits_equal(got[k], want[k]), k


# ---- routing and the wrapper -------------------------------------------

@pytest.mark.parametrize("overrides", [
    {"sgm_paths": 4},                                   # rbestd, no ubest
    {"sgm_paths": 8, "uniqueness_ratio": 10.0},         # rbestd and ubest
    {"lr_check": False, "aggregation": "box", "window_radius": 2},  # neither
], ids=["sgm4", "sgm8_gate", "box_nolr"])
def test_cpu_volumes_take_the_plain_version_and_launch_nothing(overrides):
    cfg = asm.get_preset("kitti_sgm").replace(max_disparity=16, **overrides)
    pair = synthetic.make_pair(height=12, width=40, max_disparity=16, seed=3)
    l, r = torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"])
    before = wta_kernel.launches
    got = pipeline._planes(l, r, cfg, "eager")
    assert wta_kernel.launches == before
    want = wta.planes(aggregate.aggregated_volume(l, r, cfg), rbestd=cfg.lr_check,
                      ubest=cfg.uniqueness_ratio > 0)
    _assert_planes(got, want)


@pytest.mark.parametrize("rbestd", [True, False], ids=["r", "nor"])
@pytest.mark.parametrize("ubest", [True, False], ids=["u", "nou"])
def test_reference_is_wta_planes(rbestd, ubest):
    vol = torch.from_numpy(np.random.default_rng(4).integers(0, 5, (5, 23, 9)).astype(np.float32))
    got = wta_kernel.reference(vol, rbestd=rbestd, ubest=ubest)
    _assert_planes(got, wta.planes(vol, rbestd=rbestd, ubest=ubest))
    _assert_planes(wta_kernel.planes(vol, rbestd=rbestd, ubest=ubest), got)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,vol,match", [
    ("float64", _meta((4, 8, 16), torch.float64), "float32"),
    ("bfloat16", _meta((4, 8, 16), torch.bfloat16), "float32"),
    ("two_dim", _meta((4, 8)), r"non-empty \(H, W, D\)"),
    ("four_dim", _meta((1, 4, 8, 16)), r"non-empty \(H, W, D\)"),
    ("empty", _meta((0, 8, 16)), r"non-empty \(H, W, D\)"),
    ("d_too_large", _meta((2, 3, MAX_D + 1)), rf"D <= {MAX_D}"),
    ("not_contiguous", _meta((8, 4, 16)).transpose(0, 1), "contiguous"),
    ("cpu", torch.zeros((4, 8, 16)), "no WTA kernel for device cpu"),
    ("meta", _meta((4, 8, 16)), "no WTA kernel for device meta"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_the_kernel_entry_refuses_what_the_kernel_cannot_take(case, vol, match):
    before = wta_kernel.launches
    with pytest.raises(ValueError, match=match):
        wta_kernel.wta_planes(vol, rbestd=True, ubest=True)
    assert wta_kernel.launches == before


def test_volumes_off_the_cpu_go_to_the_kernel_and_raise_without_one():
    """A device that is neither CPU nor CUDA reaches the kernel's entry,
    which raises rather than run the plain ops there."""
    before = wta_kernel.launches
    with pytest.raises(ValueError, match="no WTA kernel for device meta"):
        wta_kernel.planes(_meta((4, 8, 16)), rbestd=True, ubest=False)
    assert wta_kernel.launches == before


# ---- a model of wta_kernel.cu's schedule --------------------------------

def _write_once(plane, y, x, v):
    assert plane[y, x] == -1, "a right column written twice"
    plane[y, x] = v


def _plan(W: int, D: int):
    """wta_kernel.cu's ``plan_for``: (groups, k, nq, stride, tx)."""
    groups = (D + 3) // 4
    k = 1
    while k < 32 and k * GROUPS_PER_THREAD < groups:
        k *= 2
    nq = -(-groups // k)
    stride = 4 * groups + ((4 * k) % 32 - 4 * groups) % 32
    tx = THREADS // k
    if tx * stride > STAGE_FLOATS:
        tx = STAGE_FLOATS // stride
    return groups, k, nq, stride, min(max(tx, 1), W)


def _before(a, b) -> bool:
    """The kernel's ``before``: torch.argmin's order on (value, index)."""
    (va, ia), (vb, ib) = a, b
    if math.isnan(va):
        return not math.isnan(vb) or ia < ib
    return va < vb or (va == vb and ia < ib)


def _step(best, v, d):
    bv, _ = best
    return (v, d) if v < bv or (math.isnan(v) and not math.isnan(bv)) else best


def _nan_min(m, v):
    return v if math.isnan(v) or v < m else m


def _butterfly(vals, merge):
    k = len(vals)
    o = k // 2
    while o:
        vals = [merge(vals[i], vals[i ^ o]) for i in range(k)]
        o //= 2
    assert all(_same(v, vals[0]) for v in vals)
    return vals[0]


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64), equal_nan=True)


def _nan_min_canonical(a, b):
    """min.NaN.f32: NaN where either is."""
    return math.nan if math.isnan(a) or math.isnan(b) else min(a, b)


def _left_exact(col, k, groups, ubest):
    """The kernel's ``left_exact``: every element under torch's rules."""
    lanes = []
    for kk in range(k):
        best = (math.inf, 4 * kk)
        for g in range(kk, groups, k):
            for j in range(4):
                best = _step(best, float(col[4 * g + j]), 4 * g + j)
        lanes.append(best)
    b = _butterfly(lanes, lambda x, o: o if _before(o, x) else x)[1]
    u = math.inf
    if ubest:
        us = []
        for kk in range(k):
            m = math.inf
            for g in range(kk, groups, k):
                for j in range(4):
                    if abs(4 * g + j - b) > 1:
                        m = _nan_min(m, float(col[4 * g + j]))
            us.append(m)
        u = _butterfly(us, _nan_min)
    return b, u


def _left_column(col, k, nq, groups, ubest):
    """The kernel's left view of one staged column: (bestd, ubest)."""
    gms = [[min(col[4 * g:4 * g + 4].tolist()) if not np.isnan(col[4 * g:4 * g + 4]).any()
            else math.nan for g in range(kk, groups, k)] for kk in range(k)]
    assert max(map(len, gms)) <= nq <= 16
    m = _butterfly([functools.reduce(_nan_min_canonical, gm, math.inf) for gm in gms],
                   _nan_min_canonical)
    if math.isnan(m):
        return _left_exact(col, k, groups, ubest)
    firsts = []
    for kk, gm in enumerate(gms):
        qs = [q for q, v in enumerate(gm) if v == m]
        if qs:
            g = kk + qs[0] * k
            v = col[4 * g:4 * g + 4].tolist()
            firsts.append(4 * g + next((j for j in range(3) if v[j] == m), 3))
        else:
            firsts.append(2**31 - 1)
    b = _butterfly(firsts, min)
    u = math.inf
    if ubest:
        us = []
        for kk, gm in enumerate(gms):
            uu = math.inf
            for q, v in enumerate(gm):
                g = kk + q * k
                if 0 <= b + 1 - 4 * g <= 5:  # the group meets [b - 1, b + 1]
                    uu = min([uu] + [float(col[4 * g + j]) for j in range(4)
                                     if abs(4 * g + j - b) > 1])
                else:
                    uu = min(uu, v)
            us.append(uu)
        u = _butterfly(us, min)
    return b, u


def _model(vol: np.ndarray, rbestd: bool, ubest: bool) -> dict:
    """Run the kernel's blocks (rows), tiles and threads over a numpy copy
    of the volume, with its plan; returns the planes it writes."""
    H, W, D = vol.shape
    groups, k, nq, stride, tx = _plan(W, D)
    assert 4 * (NSTAGE * tx * stride + 2 * D) <= 227 * 1024
    assert stride >= 4 * groups and stride % 32 == (4 * k) % 32 or k >= 8
    out = {"bestd": np.full((H, W), -1, np.int32), "bestc": np.full((H, W), np.nan, np.float32)}
    out["cm"], out["cp"] = out["bestc"].copy(), out["bestc"].copy()
    if rbestd:
        out["rbestd"] = np.full((H, W), -1, np.int32)
    if ubest:
        out["ubest"] = out["bestc"].copy()
    tiles = math.ceil(W / tx)
    for y in range(H):
        state = [(math.inf, 0)] * D
        for t in range(tiles):
            x0 = t * tx
            nx = min(tx, W - x0)
            staged = np.full((tx, stride), np.nan, np.float32)  # unread words: NaN
            staged[:, D:4 * groups] = np.inf                     # the pad
            staged[:nx, :D] = vol[y, x0:x0 + nx]
            for c in range(nx):  # the left view: K lanes a column
                col = staged[c]
                b, u = _left_column(col, k, nq, groups, ubest)
                out["bestd"][y, x0 + c] = b
                out["bestc"][y, x0 + c] = col[b]
                out["cm"][y, x0 + c] = col[max(b - 1, 0)]
                out["cp"][y, x0 + c] = col[min(b + 1, D - 1)]
                if ubest:
                    out["ubest"][y, x0 + c] = u
            if not rbestd:
                continue
            for rho in range(D):  # the right view: a thread a residue x' mod D
                best = state[rho]
                d = (x0 - rho) % D
                fresh = False
                for i in range(nx):
                    v = float(staged[i, d])
                    take = fresh or ((not v >= best[0]) and best[0] == best[0])
                    if take:
                        best = (v, d)
                    fresh = d == D - 1
                    if fresh and x0 + i - d >= 0:  # right column x0 + i - d is complete
                        _write_once(out["rbestd"], y, x0 + i - d, best[1])
                    d = 0 if fresh else d + 1
                if fresh:
                    best = (math.inf, 0)
                if t == tiles - 1 and d > 0 and x0 + nx - d >= 0:
                    _write_once(out["rbestd"], y, x0 + nx - d, best[1])
                state[rho] = best
    return {key: torch.from_numpy(v) for key, v in out.items()}


def _tie_heavy(shape, seed, levels=3):
    g = np.random.default_rng(seed)
    return g.integers(0, levels, shape).astype(np.float32)


def _planted(shape, seed):
    """Ties, +inf columns and rows, -inf and NaN planted among them."""
    v = _tie_heavy(shape, seed, 4)
    H, W, D = shape
    v[:, W // 3] = np.inf                # a whole column +inf
    v[0, :, 0] = np.inf                  # d = 0 excluded along a row
    v[-1, W // 2, D // 2] = np.nan       # one NaN
    v[-1, 1, (D - 1) // 2:] = np.nan     # a run of NaNs: the first wins
    v[0, W - 1, D - 1] = -np.inf
    v[:, 2, 1::2] = np.inf               # inf at every odd d
    return v


@pytest.mark.parametrize("shape,kind", [
    ((3, 37, 1), "ties"), ((2, 29, 2), "ties"), ((2, 31, 3), "planted"),
    ((3, 40, 12), "planted"), ((2, 9, 20), "ties"),        # W < D
    ((2, 70, 128), "planted"), ((1, 45, 256), "ties"), ((2, 33, 7), "planted"),
], ids=str)
def test_the_kernels_schedule_gives_the_plain_planes(shape, kind):
    vol = (_tie_heavy(shape, sum(shape)) if kind == "ties" else _planted(shape, sum(shape)))
    want = wta.planes(torch.from_numpy(vol), rbestd=True, ubest=True)
    _assert_planes(_model(vol, True, True), want)


def test_the_schedule_without_the_optional_planes():
    vol = _planted((2, 26, 16), 9)
    for rb, ub in ((True, False), (False, True), (False, False)):
        _assert_planes(_model(vol, rb, ub), wta.planes(torch.from_numpy(vol), rbestd=rb, ubest=ub))


@pytest.mark.parametrize("W,D,k,stride,tx", [
    (1242, 128, 4, 144, 64),    # kitti_sgm
    (1440, 256, 8, 256, 32),    # middeval3_h_sgm
    (1242, 64, 2, 72, 128),
    (1242, 2048, 32, 2048, 4),  # MAX_D
    (5, 3, 1, 4, 5),
    (900, 101, 4, 112, 64),
])
def test_the_plan_at_the_cells_shapes(W, D, k, stride, tx):
    """Two blocks fit an SM at both cells' shapes; every tile plan fits a
    block's shared memory up to MAX_D, with a thread's groups within 16."""
    groups, got_k, nq, got_stride, got_tx = _plan(W, D)
    assert (got_k, got_stride, got_tx) == (k, stride, tx)
    assert stride >= 4 * groups and stride % 4 == 0 and nq <= 16
    assert k >= 8 or stride % 32 == 4 * k
    smem = 4 * (NSTAGE * tx * stride + 2 * D)
    assert smem <= 227 * 1024
    if D in (128, 256):
        assert 2 * (smem + 1024) <= 228 * 1024 and nq <= 8


# ---- the benchmark's reader of the kernel's device time ------------------

def _wta_reader():
    from benchmark import harness

    return harness.metric_reader("wta_kernel.device_ms")


def _obs(n_requests, device, traced=True):
    from types import SimpleNamespace

    from benchmark import tracing

    return SimpleNamespace(requests=[object()] * n_requests,
                           trace=tracing.Trace(device, 1.0) if traced else None)


KERNEL = "void (anonymous namespace)::wta_planes_kernel<8>((anonymous namespace)::Args)"


def test_the_reader_takes_the_kernels_device_time_per_pair():
    device = [(0.0, 150.0, KERNEL), (1000.0, 1140.0, KERNEL),
              (200.0, 900.0, "void (anonymous namespace)::sgm_reg_kernel(Phase)"),
              (950.0, 990.0, "void at::native::reduce_kernel<512, 1>(float)")]
    assert _wta_reader().read(_obs(2, device)) == pytest.approx(0.145)


def test_the_reader_is_silent_with_nothing_to_read():
    other = [(0.0, 50.0, "void at::native::(anonymous namespace)::CatArrayBatchedCopy<4>()"),
             (60.0, 90.0, "my_wta_planes_kernel_copy")]  # not the kernel's name
    read = _wta_reader().read
    assert read(_obs(2, other)) is None                          # the parent: plain ops
    assert read(_obs(2, [(0.0, 10.0, KERNEL)], traced=False)) is None
    assert read(_obs(0, [(0.0, 10.0, KERNEL)])) is None


def test_the_benchmark_lists_the_reader_for_the_two_sgm_cells():
    import json

    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}["wta_kernel.device_ms"]
    layer = {m["name"]: m["layer"] for m in bench["per_layer"]}["plain_ops.device_ms"]
    assert entry == {"name": "wta_kernel.device_ms", "unit": "ms", "better": "lower",
                     "source": "device_trace", "layer": layer, "moves": "pairs_per_s",
                     "workloads": ["kitti_sgm.stream", "middeval3_h_sgm.stream"]}
    assert bench["per_layer"][-1] is entry


@pytest.mark.parametrize("preset_overrides,shape,bytes_", [
    ({"sgm_paths": 8}, (375, 1242), 4 * 375 * 1242 * (128 + 5)),
    ({"sgm_paths": 8, "max_disparity": 256, "uniqueness_ratio": 10.0}, (994, 1440),
     4 * 994 * 1440 * (256 + 6)),
], ids=["kitti_sgm", "middeval3_h_sgm"])
def test_chip_smokes_wta_bound_counts_the_volume_and_the_planes(preset_overrides, shape,
                                                                bytes_):
    """One read of the volume and one write of each plane the cell's config
    asks for: ~0.074 ms and ~0.448 ms at the H100's 3.35 TB/s."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = asm.get_preset("kitti_sgm").replace(**preset_overrides)
    ms, by = chip_smoke.wta_bound(*shape, cfg)
    assert by == "bytes" and ms == pytest.approx(bytes_ / chip_smoke.HBM_BYTES * 1e3)
