"""The cost kernel (cost_kernel.cu) against the plain loop over d
(``cost_kernel.reference``: ``cost.cost_plane`` per disparity, then
``torch.stack``) run on the same card, bit for bit, and its launch counter.

Seeded pairs at the benchmark's geometry (1242x375, D = 128), the AD cost,
the box path's x extension, gray input, D of 1, 5, 64 and 128, widths below
one column tile and across its edge, off-grid floats; SGM's maps through
the kernel against the maps through the plain loop.  They need a CUDA device
and nvcc, so they skip on machines without a card; run them there with

    python -m pytest --noconftest tests/test_torch_cost_cuda.py

(tests/conftest.py imports jax, which the port does not need.)
"""

import pytest
import torch

pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]

DEV = "cuda"


def _assert_same_bits(got, want, label):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, label
    diff = got.view(torch.int32) != want.view(torch.int32)
    if bool(diff.any()):
        raise AssertionError(f"{label}: bits differ in {int(diff.sum())} of {diff.numel()} "
                             f"elements, over disparities {diff.sum((0, 1)).nonzero().ravel()[:8].tolist()}")


def _check(left, right, x_extend=0, **cfg_kw):
    """``cost.cost_volume`` through the kernel against the plain loop on
    the card; one launch and one volume."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops import cost
    from aswstereomatch_torch.ops.cuda import cost_kernel

    cfg = StereoConfig(**cfg_kw)
    left, right = left.to(DEV), right.to(DEV)
    before, vols = cost_kernel.launches, cost.volumes
    vol = cost.cost_volume(left, right, cfg, x_extend=x_extend)
    assert cost_kernel.launches == before + 1 and cost.volumes == vols + 1
    want = cost_kernel.reference(cost.precompute(left, right, cfg, x_extend), cfg)
    _assert_same_bits(vol, want, f"{tuple(left.shape)} x_extend={x_extend} {cfg_kw}")
    assert vol.is_contiguous() and vol.device == left.device


def _grid(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g).to(torch.float32)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_seeded_pairs_at_the_cells_geometry(seed):
    _check(_grid((375, 1242, 3), seed), _grid((375, 1242, 3), seed + 100),
           max_disparity=128, cost="tad_grad")


def test_the_synthetic_kitti_pair():
    from aswstereomatch_torch.utils import synthetic

    p = synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=7)
    _check(torch.from_numpy(p["left"]), torch.from_numpy(p["right"]), max_disparity=128)


@pytest.mark.parametrize("shape", [(375, 1242, 3), (31, 97, 3)])
def test_ad_cost(shape):
    _check(_grid(shape, 3), _grid(shape, 4), max_disparity=128, cost="ad")


@pytest.mark.parametrize("r,D", [(16, 128), (4, 16), (2, 5)])
def test_the_box_paths_x_extension(r, D):
    _check(_grid((40, 150, 3), r), _grid((40, 150, 3), r + 1), x_extend=r, max_disparity=D)


@pytest.mark.parametrize("kind", ["tad_grad", "ad"])
def test_gray_input(kind):
    _check(_grid((29, 77), 5), _grid((29, 77), 6), x_extend=3, max_disparity=64, cost=kind)


@pytest.mark.parametrize("D", [1, 5, 64, 128])
def test_disparity_ranges(D):
    _check(_grid((23, 133, 3), D), _grid((23, 133, 3), D + 9), max_disparity=D)


@pytest.mark.parametrize("W", [1, 3, 17, 63, 64, 65, 200])
def test_widths_around_the_column_tile(W):
    _check(_grid((9, W, 3), W), _grid((9, W, 3), W + 7), max_disparity=128)
    _check(_grid((9, W), W), _grid((9, W), W + 7), x_extend=1, max_disparity=5)


def test_off_grid_floats():
    """Arbitrary floats, negatives, values far above 255 and near-ties with
    the truncations, at a D a multiple of 4 and one that is not."""
    g = torch.Generator().manual_seed(8)
    left = torch.rand((17, 150, 3), generator=g) * 500 - 100
    right = left + (torch.rand((17, 150, 3), generator=g) - 0.5) * 90
    right[:, ::7] = left[:, ::7] + 40.0  # AD exactly at tau_color where d = 0
    for D in (12, 13):
        _check(left, right, max_disparity=D, tau_color=40.0, tau_grad=10.0)
        _check(left, right, x_extend=4, max_disparity=D, alpha=0.37, tau_color=7.5,
               tau_grad=2.25)


def test_the_wrapper_raises_on_card_inputs_it_cannot_take():
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops import cost
    from aswstereomatch_torch.ops.cuda import cost_kernel

    cfg = StereoConfig(max_disparity=4)
    p = cost.precompute(_grid((6, 12, 3), 1).to(DEV), _grid((6, 12, 3), 2).to(DEV), cfg)
    before = cost_kernel.launches
    for bad in (p._replace(lc=p.lc.double()),
                p._replace(gl=p.gl.t().contiguous().t()),
                p._replace(rc=p.rc[:, 1:].contiguous()),
                p._replace(gr=p.gr.cpu()),
                p._replace(lc=torch.cat([p.lc, p.lc[..., :1]], -1))):
        with pytest.raises(ValueError):
            cost_kernel.cost_volume(bad, cfg)
    assert cost_kernel.launches == before


@pytest.mark.parametrize("paths", [4, 8])
def test_sgm_maps_equal_the_plain_loops(monkeypatch, paths):
    """match_pair on preset kitti_sgm: the map through the kernel equals the
    map through the plain loop's volume bit for bit."""
    import aswstereomatch_torch as asm
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import cost_kernel
    from aswstereomatch_torch.utils import synthetic

    cfg = asm.get_preset("kitti_sgm").replace(sgm_paths=paths)
    p = synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=paths)
    left = torch.from_numpy(p["left"]).to(DEV)
    right = torch.from_numpy(p["right"]).to(DEV)
    before = cost_kernel.launches
    got = pipeline.match_pair(left, right, cfg)
    assert cost_kernel.launches == before + 1
    monkeypatch.setattr(cost_kernel, "cost_volume", cost_kernel.reference)
    want = pipeline.match_pair(left, right, cfg)
    assert cost_kernel.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_one_launch_and_one_volume_per_sgm_pair():
    """StereoMatcher on the card: each SGM pair builds its volume in one
    launch of the cost kernel, one per launch of the SGM kernel; a batch of
    two, two."""
    import numpy as np

    import aswstereomatch_torch as asm
    from aswstereomatch_torch.ops import cost
    from aswstereomatch_torch.ops.cuda import cost_kernel, sgm_kernel
    from aswstereomatch_torch.utils import synthetic

    m = asm.StereoMatcher.from_preset("kitti_sgm", max_disparity=32)
    pairs = [synthetic.make_pair(height=48, width=96, max_disparity=32, seed=s) for s in (1, 2)]
    c0, v0, s0 = cost_kernel.launches, cost.volumes, sgm_kernel.launches
    for p in pairs:
        m(p["left"], p["right"])
    m.batch(np.stack([p["left"] for p in pairs]), np.stack([p["right"] for p in pairs]))
    torch.cuda.synchronize()
    assert cost_kernel.launches - c0 == cost.volumes - v0 == sgm_kernel.launches - s0 == 4
