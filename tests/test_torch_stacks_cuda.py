"""The stack kernel (stacks_kernel.cu) against the plain channel stacks
(``preprocess.channel_stack`` + ``pad_edge``) run on the same card, bit for
bit, and its launch counter.

Every 8-bit RGB triple once (one 4096x4096 image), seeded pairs at the
benchmark's geometries, the (r, D) of every preset the kernels serve, gray
input, tiny widths and off-grid floats.  They need a CUDA device and nvcc,
so they skip on machines without a card; run them there with

    python -m pytest --noconftest tests/test_torch_stacks_cuda.py

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


def _assert_same_bits(got, want, label):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, label
    diff = got.view(torch.int32) != want.view(torch.int32)
    if bool(diff.any()):
        per_channel = diff.flatten(1).sum(1).tolist()
        raise AssertionError(f"{label}: bits differ in {per_channel} elements per channel")


def _check(left, right, r, D):
    """The kernel through ``common.stacks`` against the plain version on the
    card; one launch."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import common, stacks_kernel

    left = left.to(DEV, torch.float32).contiguous()
    right = right.to(DEV, torch.float32).contiguous()
    before = stacks_kernel.launches
    ls, rs = common.stacks(left, right, StereoConfig(max_disparity=D, window_radius=r))
    assert stacks_kernel.launches == before + 1
    pl, pr = stacks_kernel.reference(left, right, r, D)
    _assert_same_bits(ls, pl, f"left view r={r} D={D}")
    _assert_same_bits(rs, pr, f"right view r={r} D={D}")
    assert ls.is_contiguous() and rs.is_contiguous()


def _grid(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g).to(torch.float32)


def test_every_rgb_triple():
    v = torch.arange(1 << 24, dtype=torch.int64)
    img = torch.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1)
    img = img.reshape(4096, 4096, 3).to(torch.float32)
    _check(img, img.flip(0, 1), 16, 128)


@pytest.mark.parametrize("H,W,r,D,seed", [(375, 1242, 16, 128, 11), (375, 1242, 16, 128, 12),
                                          (375, 450, 16, 64, 13), (375, 450, 16, 64, 14)])
def test_seeded_pairs_at_the_benchmark_geometries(H, W, r, D, seed):
    _check(_grid((H, W, 3), seed), _grid((H, W, 3), seed + 100), r, D)


def test_every_routed_presets_radius_and_range():
    from aswstereomatch_torch.config import PRESETS
    from aswstereomatch_torch.models import pipeline

    routed = sorted({(c.window_radius, c.max_disparity) for c in PRESETS.values()
                     if pipeline.kernel_for(c) is not None})
    assert routed
    for k, (r, D) in enumerate(routed):
        _check(_grid((37, 141, 3), k), _grid((37, 141, 3), k + 50), r, D)


def test_gray_input():
    _check(_grid((29, 77), 5), _grid((29, 77), 6), 16, 64)


@pytest.mark.parametrize("W", [1, 2, 3, 15])
def test_tiny_widths(W):
    _check(_grid((9, W, 3), W), _grid((9, W, 3), W + 7), 16, 128)
    _check(_grid((9, W), W), _grid((9, W), W + 7), 16, 128)


def test_off_grid_floats():
    """Ties at x.5 (rounded to even before the LUT), negatives and values
    above 255 (clamped), and arbitrary floats between the grid's points."""
    g = torch.Generator().manual_seed(8)
    vals = torch.cat([torch.arange(-4.0, 260.0, 0.5),
                      torch.rand(3000, generator=g) * 500 - 100,
                      torch.tensor([0.49999997, 0.50000006, 254.5, 255.5, -0.5, 1e6, -1e6])])
    vals = vals[: vals.numel() // 3 * 3].reshape(1, -1, 3).repeat(4, 1, 1)
    _check(vals, vals.flip(1), 2, 5)


def test_r0_d1():
    _check(_grid((5, 8, 3), 1), _grid((5, 8, 3), 2), 0, 1)


def test_the_table_is_written_once_per_device(monkeypatch):
    from aswstereomatch_torch.ops.cuda import stacks_kernel

    _check(_grid((4, 6, 3), 1), _grid((4, 6, 3), 2), 1, 2)
    assert torch.cuda.current_device() in stacks_kernel._written
    monkeypatch.setattr(stacks_kernel, "table", lambda: pytest.fail("table written again"))
    _check(_grid((4, 6, 3), 3), _grid((4, 6, 3), 4), 1, 2)


def test_the_wrapper_raises_on_card_inputs_it_cannot_take():
    from aswstereomatch_torch.ops.cuda import stacks_kernel

    img = _grid((6, 12, 3), 1).to(DEV)
    before = stacks_kernel.launches
    for left, right in ((img.to(torch.uint8), img.to(torch.uint8)), (img[:, ::2], img[:, 1::2]),
                        (img, img[:, :6].contiguous()), (img, img.cpu())):
        with pytest.raises(ValueError):
            stacks_kernel.channel_stacks(left, right, 2, 4)
    assert stacks_kernel.launches == before


@pytest.mark.parametrize("preset,kernel", [("middlebury_asw_full", "asw_kernel"),
                                           ("kitti_sep", "asw_sep_kernel")])
def test_one_launch_per_pair_on_the_kernel_route(preset, kernel):
    """StereoMatcher on the card: each pair builds its stacks in one launch
    of the stack kernel, one per launch of its aggregation kernel; a batch
    of two, two."""
    import importlib

    import aswstereomatch_torch as asm
    from aswstereomatch_torch.ops.cuda import stacks_kernel
    from aswstereomatch_torch.utils import synthetic

    agg = importlib.import_module(f"aswstereomatch_torch.ops.cuda.{kernel}")
    m = asm.StereoMatcher.from_preset(preset, max_disparity=32)
    pairs = [synthetic.make_pair(height=48, width=96, max_disparity=32, seed=s) for s in (1, 2)]
    s0, k0 = stacks_kernel.launches, agg.launches
    for p in pairs:
        m(p["left"], p["right"])
    m.batch(np.stack([p["left"] for p in pairs]), np.stack([p["right"] for p in pairs]))
    torch.cuda.synchronize()
    assert stacks_kernel.launches - s0 == agg.launches - k0 == 4
