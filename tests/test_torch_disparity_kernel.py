"""The planes -> map routing and the disparity kernel's wrapper, on the CPU.

``pipeline.disp_pre`` and ``pipeline.disparity`` turn CPU planes into a map
with the plain ops (``disparity_kernel.reference``) and launch nothing; any
other device goes to the kernel's wrapper, which refuses what the kernel
cannot take before any launch.  ``reference`` is the composition the
pipeline ran before the kernel, for every preset's post-process settings.
A numpy model of ``disparity_kernel.cu`` (its constants and its median
network read from the source) runs the kernel's schedule: bands of TY rows
with halo rows clamped at the image's edges, each pixel's value in the
kernel's order of float32 operations, the holes filled by 32 lanes' runs
with their prefix max and suffix min, and each output row's median from its
own band through the network; it equals ``reference`` bit for bit.  The
kernel itself runs only on a card (tests/test_torch_disparity_cuda.py).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from aswstereomatch_torch.config import PRESETS, StereoConfig
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops import postprocess, wta
from aswstereomatch_torch.ops.cuda import disparity_kernel

CU = Path(disparity_kernel.__file__).with_suffix(".cu")
SRC = CU.read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


TY, MAX_W, WARP = (_const(n) for n in ("TY", "MAX_W", "WARP"))
NETWORK = [(int(i), int(j)) for i, j in re.findall(
    r"sort2\(p\[(\d)\], p\[(\d)\]\)", SRC[SRC.index("float median9("):])]

FLAGS = ("subpixel", "lr_check", "uniqueness", "fill_holes", "median")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def make_planes(H: int, W: int, D: int, seed: int) -> dict:
    """Seeded WTA planes with every edge the post-process has: winners at 0
    and D - 1, parabolas with |denom| at and below 1e-6, right-view
    winners out of [0, D) and beyond the row, a row with no LR-consistent
    pixel, runs of equal disparities (ties among the median's taps) and
    uniqueness margins on both sides of the gate."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, D, (H, 1))
    steps = rng.integers(-2, 3, (H, W)) * (rng.random((H, W)) < 0.15)
    bestd = np.clip(base + np.cumsum(steps, axis=1), 0, D - 1)
    bestd[rng.random((H, W)) < 0.05] = 0
    bestd[rng.random((H, W)) < 0.05] = D - 1
    rbestd = bestd.copy()
    ys, xs = np.nonzero((np.arange(W)[None, :] >= bestd) & (rng.random((H, W)) < 0.7))
    rbestd[ys, xs - bestd[ys, xs]] = bestd[ys, xs]  # consistent views on most pixels
    rbestd += rng.integers(-2, 3, (H, W)) * (rng.random((H, W)) < 0.3)
    rbestd[rng.random((H, W)) < 0.03] = -3
    rbestd[rng.random((H, W)) < 0.03] = D + 5
    if H > 1:
        rbestd[H // 2] = 10 * D + 7  # no pixel of this row passes the LR check
    bestc = (rng.random((H, W)) * 40).astype(np.float32)
    cm = bestc + (rng.random((H, W)) * 8).astype(np.float32)
    cp = bestc + (rng.random((H, W)) * 8).astype(np.float32)
    flat = rng.random((H, W)) < 0.05  # denom 0
    cm[flat], cp[flat] = bestc[flat], bestc[flat]
    tiny = rng.random((H, W)) < 0.05  # |denom| around 1e-6
    cp[tiny] = bestc[tiny] + np.float32(2 ** -20) * rng.integers(0, 3, int(tiny.sum()))
    cm[tiny] = bestc[tiny]
    ubest = bestc * (1 + rng.random((H, W)) * 0.3).astype(np.float32)
    return {"bestd": torch.from_numpy(bestd.astype(np.int32)),
            "bestc": torch.from_numpy(bestc), "cm": torch.from_numpy(cm.astype(np.float32)),
            "cp": torch.from_numpy(cp.astype(np.float32)),
            "rbestd": torch.from_numpy(rbestd.astype(np.int32)),
            "ubest": torch.from_numpy(ubest.astype(np.float32))}


def flag_config(D: int, flags: dict, **over) -> tuple:
    """(config, median) for one combination of the five stages."""
    cfg = StereoConfig(max_disparity=D, subpixel=flags["subpixel"], lr_check=flags["lr_check"],
                       uniqueness_ratio=12.5 if flags["uniqueness"] else 0.0,
                       fill_holes=flags["fill_holes"], median_filter=flags["median"], **over)
    return cfg, flags["median"]


COMBOS = [dict(zip(FLAGS, v)) for v in itertools.product((False, True), repeat=len(FLAGS))]


def _combo_id(flags):
    return "-".join(k for k in FLAGS if flags[k]) or "none"


def _old_disparity(planes, cfg):
    """``pipeline.disparity(planes, cfg, None)`` as it was before the
    kernel: ``disp_pre``'s plain ops, then ``postprocess.median_filter``."""
    disp_i = planes["bestd"]
    if cfg.subpixel:
        disp = wta.subpixel_from_triple(disp_i, planes["bestc"], planes["cm"], planes["cp"],
                                        cfg.max_disparity)
    else:
        disp = disp_i.to(torch.float32)
    valid = None
    if cfg.lr_check:
        valid = postprocess.lr_check(disp_i, planes["rbestd"], cfg)
    if cfg.uniqueness_ratio > 0:
        uv = wta.uniqueness_valid(planes["bestc"], planes["ubest"], cfg.uniqueness_ratio)
        valid = uv if valid is None else valid & uv
    if valid is not None:
        if cfg.fill_holes:
            disp = postprocess.fill_holes(disp, valid)
        else:
            disp = torch.where(valid, disp, torch.full_like(disp, -1.0))
    disp = disp.to(torch.float32)
    return postprocess.median_filter(disp, cfg, None) if cfg.median_filter else disp


# ---- routing: CPU planes take the plain ops ---------------------------------

@pytest.mark.parametrize("flags", COMBOS, ids=_combo_id)
def test_cpu_planes_take_the_plain_ops_and_launch_nothing(flags):
    cfg, _ = flag_config(24, flags)
    planes = make_planes(9, 31, 24, 5)
    before = disparity_kernel.launches
    got = pipeline.disparity(planes, cfg, None)
    pre = pipeline.disp_pre(planes, cfg)
    assert disparity_kernel.launches == before
    assert _bits_equal(got, _old_disparity(planes, cfg))
    assert _bits_equal(pre, _old_disparity(planes, cfg.replace(median_filter=False)))
    assert got.dtype == torch.float32 and got.shape == (9, 31)


def test_the_weighted_median_follows_disp_pre():
    """``median_mode="weighted"``: disp_pre (the kernel with the median off
    on the card), then the plain weighted median over the Lab guide."""
    cfg = StereoConfig(max_disparity=16, median_mode="weighted", uniqueness_ratio=5.0)
    planes = make_planes(7, 12, 16, 9)
    left = torch.from_numpy(np.random.default_rng(1).random((7, 12, 3)).astype(np.float32) * 255)
    guide = pipeline.guide_lab(left, cfg)
    want = postprocess.weighted_median3(_old_disparity(planes, cfg.replace(median_filter=False)),
                                        guide, cfg)
    assert _bits_equal(pipeline.disparity(planes, cfg, guide), want)
    with pytest.raises(ValueError, match="Lab guide"):
        pipeline.disparity(planes, cfg, None)


def test_planes_off_the_cpu_go_to_the_kernel_and_raise_without_one():
    """A device that is neither CPU nor CUDA reaches the wrapper, which
    raises rather than run the plain ops there."""
    planes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in make_planes(4, 6, 8, 1).items()}
    before = disparity_kernel.launches
    for fn in (lambda: pipeline.disparity(planes, StereoConfig(max_disparity=8), None),
               lambda: pipeline.disp_pre(planes, StereoConfig(max_disparity=8))):
        with pytest.raises(ValueError, match="no disparity kernel for device meta"):
            fn()
    assert disparity_kernel.launches == before


# ---- reference is the old composition ---------------------------------------

def _post_settings():
    return sorted({(c.subpixel, c.lr_check, c.lr_tol, c.uniqueness_ratio, c.fill_holes,
                    c.median_filter) for c in PRESETS.values()})


@pytest.mark.parametrize("settings", _post_settings(), ids=str)
def test_reference_is_the_old_composition_for_every_presets_settings(settings):
    sub, lr, tol, ratio, fill, med = settings
    cfg = StereoConfig(max_disparity=20, subpixel=sub, lr_check=lr, lr_tol=tol,
                       uniqueness_ratio=ratio, fill_holes=fill, median_filter=med)
    for shape, seed in (((11, 37), 2), ((3, 5), 3), ((1, 9), 4)):
        planes = make_planes(*shape, 20, seed)
        assert _bits_equal(disparity_kernel.reference(planes, cfg, med),
                           _old_disparity(planes, cfg))


# ---- the wrapper refuses what the kernel cannot take -------------------------

def _meta_planes(H=5, W=7, **over):
    p = {k: torch.empty((H, W), dtype=torch.int32 if k.endswith("bestd") else torch.float32,
                        device="meta") for k in ("bestd", "bestc", "cm", "cp", "rbestd", "ubest")}
    p.update(over)
    return {k: v for k, v in p.items() if v is not None}


_M = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731


@pytest.mark.parametrize("case,planes,cfg_kw,match", [
    ("no_rbestd", _meta_planes(rbestd=None), {}, r"needs the planes \['rbestd'\]"),
    ("no_ubest", _meta_planes(ubest=None), {"uniqueness_ratio": 5.0},
     r"needs the planes \['ubest'\]"),
    ("no_cm", _meta_planes(cm=None), {}, r"needs the planes \['cm'\]"),
    ("int64_bestd", _meta_planes(bestd=_M((5, 7), torch.int64)), {}, "int32 bestd"),
    ("float_rbestd", _meta_planes(rbestd=_M((5, 7))), {}, "int32 bestd"),
    ("float64_cp", _meta_planes(cp=_M((5, 7), torch.float64)), {}, "float32 bestc"),
    ("bf16_ubest", _meta_planes(ubest=_M((5, 7), torch.bfloat16)),
     {"uniqueness_ratio": 1.0}, "float32 bestc"),
    ("three_dims", _meta_planes(**{k: _M((1, 5, 7), torch.int32 if k.endswith("bestd")
                                         else torch.float32)
                                   for k in ("bestd", "bestc", "cm", "cp", "rbestd")}),
     {}, "one \\(H, W\\) shape"),
    ("empty", _meta_planes(H=0), {}, "non-empty"),
    ("shapes_differ", _meta_planes(bestc=_M((5, 8))), {}, "one \\(H, W\\) shape"),
    ("too_wide", _meta_planes(W=MAX_W + 1), {}, rf"W <= {MAX_W}"),
    ("not_contiguous", _meta_planes(cm=_M((7, 5)).t()), {}, "contiguous"),
    ("devices_differ", _meta_planes(cp=torch.zeros((5, 7))), {}, "different devices"),
    ("cpu", {k: torch.zeros((5, 7), dtype=v.dtype) for k, v in _meta_planes().items()}, {},
     "no disparity kernel for device cpu"),
    ("meta", _meta_planes(), {}, "no disparity kernel for device meta"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_the_wrapper_refuses_what_the_kernel_cannot_take(case, planes, cfg_kw, match):
    cfg = StereoConfig(max_disparity=8, **cfg_kw)
    before = disparity_kernel.launches
    with pytest.raises(ValueError, match=match):
        disparity_kernel.disparity_map(planes, cfg, True)
    assert disparity_kernel.launches == before


def test_planes_the_config_does_not_read_may_be_absent():
    """Without the LR check and the uniqueness gate the kernel reads neither
    rbestd nor ubest: the wrapper passes planes without them to the card
    check, which a CPU tensor then fails."""
    planes = {k: torch.zeros((5, 7), dtype=torch.int32 if k == "bestd" else torch.float32)
              for k in ("bestd", "bestc", "cm", "cp")}
    with pytest.raises(ValueError, match="no disparity kernel for device cpu"):
        disparity_kernel.disparity_map(planes, StereoConfig(max_disparity=8, lr_check=False),
                                       True)


# ---- a numpy model of disparity_kernel.cu ------------------------------------

def _before(a, b):
    """torch.sort's ascending order: NaN above every number."""
    return (a < b) | (np.isnan(b) & ~np.isnan(a))


def model_median9(p: np.ndarray) -> np.ndarray:
    """The source's network over taps p (9, N): the fifth of each column."""
    p = p.copy()
    for i, j in NETWORK:
        swap = _before(p[j], p[i])
        p[i], p[j] = np.where(swap, p[j], p[i]), np.where(swap, p[i], p[j])
    return p[4]


def model_fill_row(d: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """One warp's fill of a row: 32 lanes' runs, the prefix max of their
    last valid columns, the suffix min of their first, then each run's
    forward and backward walk."""
    W = d.size
    d = d.copy()
    run = -(-W // WARP)
    spans = [(min(lane * run, W), min(min(lane * run, W) + run, W)) for lane in range(WARP)]
    last = [max([x for x in range(lo, hi) if ok[x]], default=-1) for lo, hi in spans]
    first = [min([x for x in range(lo, hi) if ok[x]], default=W) for lo, hi in spans]
    slot = {}
    for lane, (lo, hi) in enumerate(spans):
        left = max(last[:lane], default=-1)
        for x in range(lo, hi):
            if ok[x]:
                left = x
            else:
                slot[x] = left
    for lane, (lo, hi) in enumerate(spans):
        right = min(first[lane + 1:], default=W)
        for x in range(hi - 1, lo - 1, -1):
            if ok[x]:
                right = x
            else:
                dl = d[slot[x]] if slot[x] >= 0 else np.float32(np.inf)
                dr = d[right] if right < W else np.float32(np.inf)
                f = dl if np.isnan(dl) else (dr if np.isnan(dr) else min(dl, dr))
                d[x] = np.float32(0.0) if np.isinf(f) else f
    return d


def model_pixels(planes: dict, cfg: StereoConfig) -> tuple:
    """Each pixel's value and valid flag before the fill, in the kernel's
    order of float32 operations."""
    f32 = np.float32
    d = planes["bestd"].numpy()
    H, W = d.shape
    D = cfg.max_disparity
    df = d.astype(np.float32)
    v = df.copy()
    if cfg.subpixel:
        c0, cm, cp = (planes[k].numpy() for k in ("bestc", "cm", "cp"))
        with np.errstate(all="ignore"):
            denom = (cp - f32(2.0) * c0) + cm
            off = (cp - cm) / (f32(2.0) * denom)
            off = np.where(np.isnan(off), off, np.minimum(np.maximum(off, f32(-0.5)), f32(0.5)))
            ok = (d > 0) & (d < D - 1) & (np.abs(denom) > f32(1e-6))
            v = np.where(ok, df - off, df).astype(np.float32)
    valid = np.ones((H, W), bool)
    if cfg.lr_check:
        dli = np.rint(df).astype(np.int64)
        xr = np.arange(W)[None, :] - dli
        inside = (dli >= 0) & (dli < D) & (xr >= 0) & (xr < W)
        dr = np.take_along_axis(planes["rbestd"].numpy(), np.clip(xr, 0, W - 1), 1)
        valid = inside & (np.abs(df - dr.astype(np.float32)) <= f32(cfg.lr_tol))
    if cfg.uniqueness_ratio > 0:
        scale = f32(100.0 + cfg.uniqueness_ratio)
        valid &= planes["ubest"].numpy() * f32(100.0) >= planes["bestc"].numpy() * scale
    return v, valid


def model_kernel(planes: dict, cfg: StereoConfig, median: bool) -> np.ndarray:
    """The kernel's schedule: per block, its band of TY rows and (with the
    median) one clamped halo row a side, filled row by row, then the
    median of each output row from the band's rows."""
    v, valid = model_pixels(planes, cfg)
    H, W = v.shape
    gated = cfg.lr_check or cfg.uniqueness_ratio > 0
    halo = 1 if median else 0
    out = np.empty((H, W), np.float32)
    xs = [np.clip(np.arange(W) + dx, 0, W - 1) for dx in (-1, 0, 1)]
    for y0 in range(0, H, TY):
        rows = [min(max(y0 - halo + r, 0), H - 1) for r in range(TY + 2 * halo)]
        band = v[rows].copy()
        if gated and not cfg.fill_holes:
            band = np.where(valid[rows], band, np.float32(-1.0))
        if gated and cfg.fill_holes:
            band = np.stack([model_fill_row(band[i], valid[g]) for i, g in enumerate(rows)])
        for r in range(TY):
            if y0 + r >= H:
                break
            if median:
                taps = np.stack([band[r + dy][xs[dx]] for dy in range(3) for dx in range(3)])
                out[y0 + r] = model_median9(taps)
            else:
                out[y0 + r] = band[r]
    return out


def test_the_network_selects_the_median_of_every_zero_one_input():
    """The 0-1 principle: a compare-exchange network that selects the median
    of every 0/1 input selects it for every input."""
    assert len(NETWORK) == 19
    bits = np.array(list(itertools.product((0.0, 1.0), repeat=9)), np.float32).T
    assert np.array_equal(model_median9(bits), np.sort(bits, axis=0)[4])


@pytest.mark.parametrize("H,W,seed", [(1, 1, 0), (1, 2, 1), (2, 3, 2), (3, 1, 3), (5, 7, 4),
                                      (9, 33, 5), (17, 70, 6), (40, 41, 7)])
def test_the_band_schedule_gives_median3(H, W, seed):
    """Bands of TY rows with clamped halo rows, each output row's median
    from its own band, equal the plain 3x3 median: random maps with ties,
    -1, 0, infinities and NaN (which torch.sort puts last)."""
    rng = np.random.default_rng(seed)
    disp = rng.integers(-1, 6, (H, W)).astype(np.float32)
    disp += (rng.random((H, W)) < 0.3) * rng.integers(1, 4, (H, W)).astype(np.float32) * 0.25
    disp[rng.random((H, W)) < 0.05] = np.inf
    disp[rng.random((H, W)) < 0.05] = np.nan
    got = np.empty((H, W), np.float32)
    xs = [np.clip(np.arange(W) + dx, 0, W - 1) for dx in (-1, 0, 1)]
    for y0 in range(0, H, TY):
        band = disp[[min(max(y0 - 1 + r, 0), H - 1) for r in range(TY + 2)]]
        for r in range(min(TY, H - y0)):
            got[y0 + r] = model_median9(
                np.stack([band[r + dy][xs[dx]] for dy in range(3) for dx in range(3)]))
    want = postprocess.median3(torch.from_numpy(disp)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("W,seed", [(1, 0), (2, 1), (31, 2), (32, 3), (33, 4), (100, 5),
                                    (1242, 6)])
def test_the_warps_fill_is_fill_holes(W, seed):
    rng = np.random.default_rng(seed)
    for share in (0.0, 0.02, 0.3, 0.9, 1.0):
        d = (rng.random((3, W)) * 50).astype(np.float32)
        ok = rng.random((3, W)) < share
        ok[1, : W // 2] = False  # a long hole across lanes' runs
        want = postprocess.fill_holes(torch.from_numpy(d), torch.from_numpy(ok)).numpy()
        got = np.stack([model_fill_row(d[i], ok[i]) for i in range(3)])
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("flags", COMBOS, ids=_combo_id)
def test_the_model_of_the_kernel_is_reference(flags):
    for (H, W, D), seed in (((7, 45, 16), 11), ((2, 3, 4), 12), ((1, 1, 3), 13), ((3, 2, 8), 14)):
        cfg, median = flag_config(D, flags)
        planes = make_planes(H, W, D, seed)
        want = disparity_kernel.reference(planes, cfg, median).numpy()
        got = model_kernel(planes, cfg, median)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (H, W, D)


def test_the_model_of_the_kernel_at_a_wide_band():
    """A width whose lanes' runs are ragged, rows with no valid pixel, and
    the edges of every gate at D = 64."""
    cfg, median = flag_config(64, dict.fromkeys(FLAGS, True), lr_tol=0.5)
    planes = make_planes(6, 450, 64, 21)
    assert np.array_equal(model_kernel(planes, cfg, median).view(np.int32),
                          disparity_kernel.reference(planes, cfg, median).numpy().view(np.int32))


def test_the_kernels_shared_memory_fits_at_max_w():
    """The wrapper refuses what the .cu refuses, and TY + 2 rows of MAX_W
    floats and MAX_W one-byte flags stay under the 227 KiB a block may opt
    in to on sm_90."""
    assert disparity_kernel.MAX_W == MAX_W
    assert (TY + 2) * MAX_W * 5 <= 227 * 1024
