"""The channel stacks' routing and the stack kernel's wrapper, on the CPU.

``common.stacks`` builds CPU tensors' stacks with the plain version
(``preprocess.channel_stack`` + ``pad_edge``) and launches nothing; the
kernel's wrapper refuses what the kernel cannot take before any launch, and
its constant table is ``utils/colorspace.py``'s, laid out as
``stacks_kernel.cu`` reads it.  The kernel itself runs only on a card
(tests/test_torch_stacks_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from aswstereomatch_torch.config import PRESETS, StereoConfig
from aswstereomatch_torch.ops import preprocess
from aswstereomatch_torch.ops.cuda import common, stacks_kernel
from aswstereomatch_torch.utils import colorspace

CU = Path(stacks_kernel.__file__).with_suffix(".cu")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _image(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g).to(torch.float32)


@pytest.mark.parametrize("shape,r,D", [
    ((12, 20, 3), 4, 16),
    ((9, 33, 3), 16, 64),
    ((7, 13), 2, 5),        # 2-D gray
    ((5, 1, 3), 16, 8),     # W = 1
    ((4, 3, 3), 16, 128),   # W < r
])
def test_cpu_stacks_are_the_plain_version_and_launch_nothing(shape, r, D):
    left, right = _image(shape, 1), _image(shape, 2)
    cfg = StereoConfig(max_disparity=D, window_radius=r)
    before = stacks_kernel.launches
    ls, rs = common.stacks(left, right, cfg)
    assert stacks_kernel.launches == before
    want_l = preprocess.pad_edge(preprocess.channel_stack(left), 2, r, r)
    want_r = preprocess.pad_edge(preprocess.channel_stack(right), 2, r + D - 1, r)
    assert _bits_equal(ls, want_l) and _bits_equal(rs, want_r)
    W = shape[1]
    assert ls.shape == (7, shape[0], W + 2 * r) and rs.shape == (7, shape[0], W + 2 * r + D - 1)


def test_cpu_stacks_keep_taking_other_dtypes():
    """The CPU path is unchanged: it widens a uint8 pair as before."""
    u8 = torch.randint(0, 256, (6, 10, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(3))
    cfg = StereoConfig(max_disparity=4, window_radius=1)
    ls, rs = common.stacks(u8, u8, cfg)
    fl, fr = common.stacks(u8.to(torch.float32), u8.to(torch.float32), cfg)
    assert _bits_equal(ls, fl) and _bits_equal(rs, fr)


def _meta(shape=(6, 9, 3), dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,left,right,match", [
    ("uint8", _meta(dtype=torch.uint8), _meta(dtype=torch.uint8), "float32"),
    ("float64", _meta(dtype=torch.float64), _meta(dtype=torch.float64), "float32"),
    ("one_view_float16", _meta(), _meta(dtype=torch.float16), "float32"),
    ("shapes_differ", _meta(), _meta((6, 10, 3)), "views differ"),
    ("devices_differ", torch.zeros((6, 9, 3)), _meta(), "views differ"),
    ("four_channels", _meta((6, 9, 4)), _meta((6, 9, 4)), r"\(H, W, 3\) or \(H, W\)"),
    ("batched", _meta((2, 6, 9, 3)), _meta((2, 6, 9, 3)), r"\(H, W, 3\) or \(H, W\)"),
    ("empty", _meta((0, 9, 3)), _meta((0, 9, 3)), r"\(H, W, 3\) or \(H, W\)"),
    ("not_contiguous", _meta((9, 6, 3)).transpose(0, 1), _meta(), "contiguous"),
    ("column_slice", torch.zeros((6, 12, 3))[:, ::2], torch.zeros((6, 6, 3)), "contiguous"),
    ("cpu", torch.zeros((6, 9, 3)), torch.zeros((6, 9, 3)), "no stack kernel for device cpu"),
    ("meta", _meta(), _meta(), "no stack kernel for device meta"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_the_wrapper_refuses_what_the_kernel_cannot_take(case, left, right, match):
    before = stacks_kernel.launches
    with pytest.raises(ValueError, match=match):
        stacks_kernel.channel_stacks(left, right, 16, 128)
    assert stacks_kernel.launches == before


@pytest.mark.parametrize("r,D", [(-1, 8), (2, 0)])
def test_the_wrapper_refuses_a_negative_radius_or_no_disparity(r, D):
    with pytest.raises(ValueError, match="r >= 0 and D >= 1"):
        stacks_kernel.channel_stacks(_meta(), _meta(), r, D)


def test_stacks_off_the_cpu_go_to_the_kernel_and_raise_without_one():
    """A device that is neither CPU nor CUDA reaches the wrapper, which
    raises rather than build the plain version there."""
    with pytest.raises(ValueError, match="no stack kernel for device meta"):
        common.stacks(_meta(), _meta(), StereoConfig(max_disparity=8, window_radius=2))


def _enum_names() -> list:
    body = re.search(r"enum : int \{(.*?)\};", CU.read_text(), re.S).group(1)
    return [n.split("=")[0].strip() for n in body.replace("\n", " ").split(",") if n.strip()]


def test_the_table_is_colorspaces_constants_in_the_kernels_order():
    tab = stacks_kernel.table()
    names = _enum_names()
    assert names[0] == "T_GRAY_R" and names[-1] == "TABLE_N"
    assert tab.dtype == np.float32 and tab.shape == (256 + len(names) - 1,)
    assert np.array_equal(tab[:256].view(np.int32), colorspace.SRGB_DECODE_LUT.view(np.int32))
    c = colorspace
    want = {"T_GRAY_R": 0.299, "T_GRAY_G": 0.587, "T_GRAY_B": 0.114,
            "T_INV_WHITE_X": c._INV_WHITE_X, "T_INV_WHITE_Z": c._INV_WHITE_Z,
            "T_THIRD": c._THIRD, "T_CUBE": c._CUBE, "T_LIN_DIV": c._LIN_DIV,
            "T_LIN_ADD": c._LIN_ADD}
    for i in range(3):
        for j in range(3):
            want[f"T_M{i}{j}"] = float(c._SRGB_TO_XYZ[i, j])
    assert set(want) == set(names[:-1])
    for k, name in enumerate(names[:-1]):
        assert tab[256 + k] == np.float32(want[name]), name
    assert f"CBRT_MAGIC = {c._CBRT_MAGIC:#X}".replace("0X", "0x") in CU.read_text()


def test_the_gray_weights_are_what_a_python_scalar_multiplies_by():
    """``0.299 * r`` on a float32 tensor multiplies by the float32 nearest
    0.299: the value the table holds."""
    x = torch.tensor([1.0, 3.0, 255.0, 97.0], dtype=torch.float32)
    tab = torch.from_numpy(stacks_kernel.table())
    for k, w in enumerate((0.299, 0.587, 0.114)):
        assert torch.equal(w * x, x * tab[256 + k])


def test_every_routed_preset_builds_its_stacks_through_stacks():
    """The kernel route's (r, D) are the presets' own: the wrappers of K1-K4
    take their stacks from ``common.stacks`` (the CPU path here)."""
    from aswstereomatch_torch.models import pipeline

    routed = {(c.window_radius, c.max_disparity) for c in PRESETS.values()
              if pipeline.kernel_for(c) is not None}
    assert routed == {(4, 16), (16, 64), (16, 128)}
    for kernel in {pipeline.kernel_for(c) for c in PRESETS.values()} - {None}:
        assert kernel.stacks is common.stacks
