"""The disparity kernel (disparity_kernel.cu) against its plain version
(``disparity_kernel.reference``: subpixel, LR check, uniqueness gate, hole
filling, then the plain 3x3 median) run on the same card, bit for bit, its
launch counter, and the planes -> map path without a host synchronisation.

Seeded planes (tests/test_torch_disparity_kernel.py::make_planes: winners
at 0 and D - 1, |denom| at and below 1e-6, right-view winners out of range,
a row with no valid pixel, ties among the median's taps) at 1242x375 D=128,
at 450x375 D=64 and at small shapes with H or W of 1-3, under every
combination of the five stages; planes with infinite costs; the three
benchmarked configurations and the weighted median, the uniqueness gate and
row bands end to end against the same pipeline with the plain ops.  They
need a CUDA device and nvcc, so they skip on machines without a card; run
them there with

    python -m pytest --noconftest tests/test_torch_disparity_cuda.py

(tests/conftest.py imports jax, which the port does not need.)
"""

import pytest
import torch

from test_torch_disparity_kernel import COMBOS, _combo_id, flag_config, make_planes

pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]

DEV = "cuda"


def _assert_same_bits(got, want, label):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, label
    diff = got.view(torch.int32) != want.view(torch.int32)
    if bool(diff.any()):
        at = diff.nonzero()[:4].tolist()
        raise AssertionError(f"{label}: bits differ on {int(diff.sum())} of {diff.numel()} "
                             f"pixels, e.g. at {at}: {[float(got[y, x]) for y, x in at]} "
                             f"against {[float(want[y, x]) for y, x in at]}")


def _check(planes, cfg, median, label):
    """The kernel against the plain version on the card: one launch."""
    from aswstereomatch_torch.ops.cuda import disparity_kernel

    planes = {k: v.to(DEV) for k, v in planes.items()}
    before = disparity_kernel.launches
    got = disparity_kernel.disparity_map(planes, cfg, median)
    assert disparity_kernel.launches == before + 1
    want = disparity_kernel.reference(planes, cfg, median)
    _assert_same_bits(got, want, label)
    assert got.is_contiguous() and got.device == planes["bestd"].device


@pytest.mark.parametrize("flags", COMBOS, ids=_combo_id)
@pytest.mark.parametrize("H,W,D,seed", [(375, 1242, 128, 31), (375, 450, 64, 32)],
                         ids=["kitti", "middlebury"])
def test_seeded_planes_at_the_cells_geometries(H, W, D, seed, flags):
    cfg, median = flag_config(D, flags)
    _check(make_planes(H, W, D, seed), cfg, median, f"{H}x{W} D={D}")


@pytest.mark.parametrize("flags", COMBOS, ids=_combo_id)
def test_small_and_odd_shapes(flags):
    for H, W, D in ((1, 1, 4), (1, 2, 3), (1, 3, 8), (2, 1, 8), (3, 1, 2), (2, 2, 1),
                    (3, 3, 5), (1, 200, 16), (3, 77, 16), (200, 2, 32), (5, 33, 64),
                    (7, 8192, 128)):
        cfg, median = flag_config(D, flags)
        _check(make_planes(H, W, D, H * 1000 + W), cfg, median, f"{H}x{W} D={D}")


@pytest.mark.parametrize("lr_tol,ratio", [(0.0, 0.5), (0.5, 7.0), (2.25, 100.0), (1.0, 33.3)])
def test_other_tolerances_and_ratios(lr_tol, ratio):
    cfg, median = flag_config(128, dict.fromkeys(("subpixel", "lr_check", "uniqueness",
                                                  "fill_holes", "median"), True),
                              lr_tol=lr_tol)
    _check(make_planes(64, 300, 128, 41), cfg.replace(uniqueness_ratio=ratio), median,
           f"lr_tol {lr_tol} ratio {ratio}")


def test_infinite_costs():
    """Infinite costs make NaN and infinite offsets; the map keeps the
    plain ops' NaN where they keep it, and the median sorts NaN last."""
    planes = make_planes(50, 97, 32, 43)
    g = torch.Generator().manual_seed(44)
    for key in ("bestc", "cm", "cp", "ubest"):
        planes[key][torch.rand(planes[key].shape, generator=g) < 0.05] = float("inf")
    for flags in COMBOS:
        cfg, median = flag_config(32, flags)
        _check(planes, cfg, median, _combo_id(flags))


def _route_maps(monkeypatch, left, right, cfg):
    """match_pair through the kernel, then through the plain version on
    the card: (got, want, launches of the first)."""
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import disparity_kernel

    before = disparity_kernel.launches
    got = pipeline.match_pair(left, right, cfg)
    launched = disparity_kernel.launches - before
    with monkeypatch.context() as m:
        m.setattr(disparity_kernel, "disparity_map", disparity_kernel.reference)
        want = pipeline.match_pair(left, right, cfg)
    return got, want, launched


@pytest.mark.parametrize("preset,over", [
    ("kitti_sep", {}), ("kitti_tiled", {"mesh_tile": 1}), ("kitti_sgm", {"sgm_paths": 8}),
    ("kitti_sgm", {"uniqueness_ratio": 10.0}),
], ids=["kitti_sep", "kitti_asw", "kitti_sgm", "kitti_sgm_uniqueness"])
def test_the_cells_configs_end_to_end(monkeypatch, preset, over):
    import aswstereomatch_torch as asm
    from aswstereomatch_torch.utils import synthetic

    cfg = asm.get_preset(preset).replace(**over)
    p = synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=17)
    left = torch.from_numpy(p["left"]).to(DEV)
    right = torch.from_numpy(p["right"]).to(DEV)
    got, want, launched = _route_maps(monkeypatch, left, right, cfg)
    assert launched == 1
    _assert_same_bits(got, want, preset)


@pytest.mark.parametrize("over", [
    {"aggregation": "box", "window_radius": 3, "median_mode": "weighted", "backend": "eager"},
    {"aggregation": "box", "window_radius": 3, "backend": "eager", "y_chunks": 3},
    {"window_radius": 4, "backend": "eager", "y_chunks": 2, "uniqueness_ratio": 5.0},
], ids=["weighted_median", "box_bands", "asw_bands_uniqueness"])
def test_the_weighted_median_and_row_bands(monkeypatch, over):
    """The weighted median runs the kernel with the median off, then its
    plain ops; row bands run the kernel on each band (median off), then
    the band's plain median over its clamped rows."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(max_disparity=32, **over)
    p = synthetic.make_pair(height=60, width=128, max_disparity=32, seed=18)
    left = torch.from_numpy(p["left"]).to(DEV)
    right = torch.from_numpy(p["right"]).to(DEV)
    got, want, launched = _route_maps(monkeypatch, left, right, cfg)
    assert launched == cfg.y_chunks
    _assert_same_bits(got, want, str(over))


def test_one_launch_per_map():
    """StereoMatcher on the card: one launch per map, singles and a batch."""
    import numpy as np

    import aswstereomatch_torch as asm
    from aswstereomatch_torch.ops.cuda import asw_sep_kernel, disparity_kernel
    from aswstereomatch_torch.utils import synthetic

    m = asm.StereoMatcher.from_preset("kitti_sep", max_disparity=32)
    pairs = [synthetic.make_pair(height=48, width=96, max_disparity=32, seed=s) for s in (1, 2)]
    d0, k0 = disparity_kernel.launches, asw_sep_kernel.launches
    for p in pairs:
        m(p["left"], p["right"])
    m.batch(np.stack([p["left"] for p in pairs]), np.stack([p["right"] for p in pairs]))
    torch.cuda.synchronize()
    assert disparity_kernel.launches - d0 == asw_sep_kernel.launches - k0 == 4


def test_the_planes_to_map_path_does_not_synchronise():
    """Under sync-debug "error" the kernel's path raises on no host
    synchronisation; the plain ops' path does (the hole filling's scalar
    copied from the host)."""
    import aswstereomatch_torch as asm
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import disparity_kernel

    cfg = asm.get_preset("kitti_sep")
    planes = {k: v.to(DEV) for k, v in make_planes(375, 1242, 128, 51).items()}
    pipeline.disparity(planes, cfg, None)  # the library is loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pipeline.disparity(planes, cfg, None)
        with pytest.raises(RuntimeError, match="synchroniz"):
            disparity_kernel.reference(planes, cfg, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same_bits(got, disparity_kernel.reference(planes, cfg, True), "sync-free call")
