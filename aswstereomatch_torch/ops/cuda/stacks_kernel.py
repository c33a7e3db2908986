"""Both views' edge-extended channel stacks in one launch: wrapper and plain version.

Counterpart of no Pallas kernel: the reference builds the stacks with jnp
ops (``channel_stack``, then ``jnp.pad`` in edge mode, in
``aswstereomatch_tpu/ops/pallas/asw_kernel.py::wta_outputs``) and leaves
them to XLA fusion.  The port's plain version (``reference``: ``preprocess.channel_stack``
and ``preprocess.pad_edge``) dispatches ~330 small ops a pair; the kernel
(``stacks_kernel.cu``, bound as ``torch.ops.asw_torch.channel_stacks`` by
``asw_binding.cpp``, built by ``build.py``) computes the same float32 function
bit for bit in one launch a pair.  ``common.stacks`` takes the plain version
for CPU tensors and the kernel for CUDA tensors.

``channel_stacks`` launches the kernel and raises on an input it cannot take
(a dtype other than float32, a non-contiguous image, views of different
shapes or devices, a device other than CUDA); it never falls back to the
plain version.  The kernel's constant table (``table()``: the sRGB LUT and
the colour constants, from ``utils.colorspace``) is written once per process
and device.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ...utils import colorspace
from .. import preprocess
from . import build

# Kernel launches since the last reset (chip_smoke.py and the tests read
# this to show that every kernel-route pair built its stacks in the kernel).
launches = 0

_written: set = set()  # device indices holding the constant table
_write_lock = threading.Lock()


def reference(left: torch.Tensor, right: torch.Tensor, r: int, D: int):
    """Plain PyTorch version, on any device: (7, H, W + 2r) and
    (7, H, W + 2r + D - 1)."""
    ls_ext = preprocess.pad_edge(preprocess.channel_stack(left), 2, r, r)
    rs_ext = preprocess.pad_edge(preprocess.channel_stack(right), 2, r + D - 1, r)
    return ls_ext, rs_ext


def table() -> np.ndarray:
    """The kernel's constant table: the 256-entry sRGB decode LUT, then the
    float32 constants in the order of stacks_kernel.cu's ``T_*`` indices."""
    c = colorspace
    consts = [0.299, 0.587, 0.114, *c._SRGB_TO_XYZ.ravel().tolist(),
              c._INV_WHITE_X, c._INV_WHITE_Z, c._THIRD, c._CUBE, c._LIN_DIV, c._LIN_ADD]
    return np.concatenate([c.SRGB_DECODE_LUT, np.asarray(consts, dtype=np.float32)])


def check(left: torch.Tensor, right: torch.Tensor, r: int, D: int) -> None:
    """Raises ``ValueError`` unless the kernel can take the pair."""
    if left.dtype != torch.float32 or right.dtype != torch.float32:
        raise ValueError(f"the stack kernel takes float32 images, got {left.dtype} "
                         f"and {right.dtype}")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError(f"the views differ: {tuple(left.shape)} on {left.device} and "
                         f"{tuple(right.shape)} on {right.device}")
    if not (left.ndim == 2 or (left.ndim == 3 and left.shape[2] == 3)) or left.numel() == 0:
        raise ValueError(f"the stack kernel takes (H, W, 3) or (H, W) images, got "
                         f"{tuple(left.shape)}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("the stack kernel takes contiguous images")
    if r < 0 or D < 1:
        raise ValueError(f"need r >= 0 and D >= 1, got r={r}, D={D}")
    if left.device.type != "cuda":
        raise ValueError(f"no stack kernel for device {left.device}")


def _write_table(index: int) -> None:
    with _write_lock:
        if index not in _written:
            torch.ops.asw_torch.channel_stacks_table(torch.from_numpy(table()), index)
            _written.add(index)


def channel_stacks(left: torch.Tensor, right: torch.Tensor, r: int, D: int):
    """Both views' stacks in one kernel launch: ``reference``'s bits."""
    global launches
    check(left, right, r, D)
    build.load()
    _write_table(left.device.index)  # a CUDA tensor's device has its index
    ls_ext, rs_ext = torch.ops.asw_torch.channel_stacks(left, right, r, D)
    launches += 1
    return ls_ext, rs_ext
