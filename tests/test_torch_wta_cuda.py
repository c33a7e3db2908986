"""The WTA kernel (wta_kernel.cu) against the plain planes (``wta.planes``:
argmin, triple, the right view by volume reuse, ``ubest``) run on the same
card, bit for bit, and its launch counter.

Seeded volumes at the benchmark's shapes (1242x375, D = 128; a row band of
1440-wide D = 256), D of 1, 2 and 3, widths below D, planted ties, +inf
columns, -inf and NaN, each plane on and off; SGM's maps through the kernel
against the maps through the plain planes.  They need a CUDA device and
nvcc, so they skip on machines without a card; run them there with

    python -m pytest --noconftest tests/test_torch_wta_cuda.py

(tests/conftest.py imports jax, which the port does not need.)
"""

import numpy as np
import pytest
import torch

pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]

DEV = "cuda"


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check(vol, rbestd=True, ubest=True, label=""):
    """The kernel's planes against the plain planes on the card: the same
    names, dtypes and bits (NaN payloads included); one launch."""
    from aswstereomatch_torch.ops.cuda import wta_kernel

    vol = vol.to(DEV)
    before = wta_kernel.launches
    got = wta_kernel.planes(vol, rbestd=rbestd, ubest=ubest)
    assert wta_kernel.launches == before + 1
    want = wta_kernel.reference(vol, rbestd=rbestd, ubest=ubest)
    assert list(got) == list(want), label
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous(), (label, k)
        diff = _bits(g) != _bits(w)
        if bool(diff.any()):
            i = diff.nonzero()[0].tolist()
            raise AssertionError(f"{label} {k}: differs at {int(diff.sum())} of {diff.numel()} "
                                 f"pixels, first {i}: {g[tuple(i)].item()} vs "
                                 f"{w[tuple(i)].item()}")


def _volume(shape, seed, levels=None):
    g = torch.Generator().manual_seed(seed)
    if levels:
        return torch.randint(0, levels, shape, generator=g).to(torch.float32)
    return torch.rand(shape, generator=g) * 200.0


@pytest.mark.parametrize("seed", [31, 32])
def test_the_kitti_cells_shape(seed):
    _check(_volume((375, 1242, 128), seed), rbestd=True, ubest=False, label="kitti")
    _check(_volume((375, 1242, 128), seed + 10, levels=50), label="kitti ties")


def test_a_row_band_of_the_middlebury_cells_shape():
    _check(_volume((40, 1440, 256), 33), label="middeval3 band")
    _check(_volume((40, 1440, 256), 34, levels=200), label="middeval3 band ties")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_the_smallest_disparity_ranges(D):
    for W in (1, 7, 300):
        _check(_volume((5, W, D), D * 100 + W, levels=3), label=f"W={W} D={D}")


@pytest.mark.parametrize("W,D", [(1, 128), (5, 64), (100, 256), (31, 33), (200, 2048)])
def test_widths_below_the_disparity_range(W, D):
    _check(_volume((6, W, D), W + D, levels=4), label=f"W={W} D={D}")


@pytest.mark.parametrize("D", [5, 12, 64, 127, 128, 130, 256, 1000])
def test_planted_ties_the_first_minimum_wins(D):
    vol = _volume((9, 333, D), D, levels=2)   # a tie on almost every pixel
    vol[:, :, D // 2:] = vol[:, :, : D - D // 2].clone()
    vol[2] = 0.0                              # a whole row of ties
    _check(vol, label=f"ties D={D}")


@pytest.mark.parametrize("D", [4, 7, 128, 256])
def test_infinities_and_nan(D):
    vol = _volume((8, 271, D), 40 + D, levels=5)
    vol[:, 17] = float("inf")                 # +inf columns: argmin 0 on both views
    vol[:, 100:102, ::2] = float("inf")
    vol[1, :, 0] = float("inf")
    vol[3, 50, D // 2] = float("nan")         # one NaN: it wins
    vol[4, 60, (D - 1) // 2:] = float("nan")  # a run of NaNs: the first wins
    vol[5, 70, D - 1] = float("-inf")
    vol[6, :, D - 1] = float("-inf")          # the right view's last candidates
    for rbestd in (True, False):
        for ubest in (True, False):
            _check(vol, rbestd, ubest, label=f"inf/nan D={D} r={rbestd} u={ubest}")


@pytest.mark.parametrize("rbestd,ubest", [(True, True), (True, False), (False, True),
                                          (False, False)])
def test_each_plane_on_and_off(rbestd, ubest):
    _check(_volume((64, 700, 96), 7), rbestd, ubest, label="flags")


def test_the_wrapper_raises_on_card_volumes_it_cannot_take():
    from aswstereomatch_torch.ops.cuda import wta_kernel

    vol = _volume((50, 11, 40), 5).to(DEV)
    before = wta_kernel.launches
    for bad in (vol.transpose(0, 1), vol.double(), vol[..., :0], vol[0],
                torch.zeros((2, 3, wta_kernel.MAX_D + 1), device=DEV)):
        with pytest.raises(ValueError):
            wta_kernel.planes(bad, rbestd=True, ubest=True)
    assert wta_kernel.launches == before


@pytest.mark.parametrize("overrides", [{"sgm_paths": 4}, {"sgm_paths": 8},
                                       {"sgm_paths": 8, "uniqueness_ratio": 10.0}])
def test_sgm_maps_equal_the_plain_planes_maps(monkeypatch, overrides):
    """match_pair on preset kitti_sgm: one WTA launch a pair, and the map
    equals the map through the plain planes bit for bit."""
    import aswstereomatch_torch as asm
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import wta_kernel
    from aswstereomatch_torch.utils import synthetic

    cfg = asm.get_preset("kitti_sgm").replace(**overrides)
    p = synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=7)
    left = torch.from_numpy(p["left"]).to(DEV)
    right = torch.from_numpy(p["right"]).to(DEV)
    before = wta_kernel.launches
    got = pipeline.match_pair(left, right, cfg)
    assert wta_kernel.launches == before + 1
    monkeypatch.setattr(wta_kernel, "wta_planes", lambda vol, **kw: wta_kernel.reference(vol, **kw))
    want = pipeline.match_pair(left, right, cfg)
    assert wta_kernel.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_one_launch_per_eager_volume_and_none_on_the_kernel_route():
    """StereoMatcher on the card: an SGM pair's planes in one launch, a
    batch of two in two, the confidence route's in one; K2's route none."""
    import aswstereomatch_torch as asm
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import sgm_kernel, wta_kernel
    from aswstereomatch_torch.utils import synthetic

    m = asm.StereoMatcher.from_preset("kitti_sgm", max_disparity=32)
    pairs = [synthetic.make_pair(height=48, width=96, max_disparity=32, seed=s) for s in (1, 2)]
    w0, s0 = wta_kernel.launches, sgm_kernel.launches
    for p in pairs:
        m(p["left"], p["right"])
    m.batch(np.stack([p["left"] for p in pairs]), np.stack([p["right"] for p in pairs]))
    l = torch.from_numpy(pairs[0]["left"]).to(DEV)
    r = torch.from_numpy(pairs[0]["right"]).to(DEV)
    pipeline.match_pair_with_confidence(l, r, m.cfg)
    torch.cuda.synchronize()
    assert wta_kernel.launches - w0 == sgm_kernel.launches - s0 == 5
    sep = asm.StereoMatcher.from_preset("kitti_sep", max_disparity=32)
    sep(pairs[0]["left"], pairs[0]["right"])
    torch.cuda.synchronize()
    assert wta_kernel.launches - w0 == 5


def test_the_kernel_does_not_synchronise():
    """Under sync-debug "error" the kernel raises on no host synchronisation;
    the plain planes do (ubest's scalar copied from the host)."""
    from aswstereomatch_torch.ops.cuda import wta_kernel

    vol = _volume((20, 300, 128), 9).to(DEV)
    wta_kernel.planes(vol, rbestd=True, ubest=True)  # the library is loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wta_kernel.planes(vol, rbestd=True, ubest=True)
        with pytest.raises(RuntimeError, match="synchroniz"):
            wta_kernel.reference(vol, rbestd=True, ubest=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = wta_kernel.reference(vol, rbestd=True, ubest=True)
    assert all(torch.equal(_bits(got[k]), _bits(want[k])) for k in want)
