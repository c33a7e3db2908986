"""The WTA planes of an aggregated (H, W, D) volume in one launch: wrapper
and plain version.

Counterpart of no Pallas kernel: the reference leaves the volume's WTA to
XLA as jnp ops.  The port's plain version (``reference``, which is
``ops/wta.py::planes``) dispatches ~20 ops a volume: the argmin and three
gathers, the right view's inf pad, cat, int64 index, gather and second
argmin, and for ``ubest`` an int64 (H, W, D) ``abs`` volume, a compare, a
``where`` and an ``amin`` with a scalar copied from the host.  The kernel
(``wta_kernel.cu``, bound as ``torch.ops.asw_torch.wta_planes`` by
``asw_binding.cpp``, built by ``build.py``) computes the same planes bit
for bit in one launch, one read of the volume.  ``planes`` takes the plain
version for CPU volumes and the kernel for any other; the eager route ends
its aggregation there (``models/pipeline.py::_planes``).

``wta_planes`` raises on a volume the kernel cannot take (a dtype other
than float32, not three dimensions, empty, non-contiguous, D above MAX_D,
on a device other than CUDA); it never falls back to the plain version.
"""

from __future__ import annotations

import torch

from .. import wta
from . import build

# Kernel launches since the last reset (chip_smoke.py and the tests read
# this to show that planes came from the kernel).  One per volume.
launches = 0

MAX_D = 2048  # wta_kernel.cu's MAX_D: a block's shared memory stays under 227 KB


def reference(vol: torch.Tensor, *, rbestd: bool = True, ubest: bool = True) -> dict:
    """Plain PyTorch version, on any device: ``wta.planes``."""
    return wta.planes(vol, rbestd=rbestd, ubest=ubest)


def check(vol: torch.Tensor) -> None:
    """Raises ``ValueError`` unless the kernel can take the volume."""
    if vol.dtype != torch.float32:
        raise ValueError(f"the WTA kernel takes a float32 volume, got {vol.dtype}")
    if vol.ndim != 3 or vol.numel() == 0:
        raise ValueError(f"the WTA kernel takes a non-empty (H, W, D) volume, "
                         f"got {tuple(vol.shape)}")
    if vol.shape[2] > MAX_D:
        raise ValueError(f"the WTA kernel takes D <= {MAX_D}, got D={vol.shape[2]}")
    if not vol.is_contiguous():
        raise ValueError("the WTA kernel takes a contiguous volume")
    if vol.device.type != "cuda":
        raise ValueError(f"no WTA kernel for device {vol.device}")


def wta_planes(vol: torch.Tensor, *, rbestd: bool = True, ubest: bool = True) -> dict:
    """The planes ``reference`` returns, in one kernel launch: its bits."""
    global launches
    check(vol)
    build.load()
    out = torch.ops.asw_torch.wta_planes(vol, bool(rbestd), bool(ubest))
    launches += 1
    names = ["bestd", "bestc", "cm", "cp"] + ["rbestd"] * bool(rbestd) + ["ubest"] * bool(ubest)
    return dict(zip(names, out))


def planes(vol: torch.Tensor, *, rbestd: bool, ubest: bool) -> dict:
    """The WTA planes of an aggregated volume: the plain version for a CPU
    volume, otherwise the kernel, which raises on a volume it cannot take."""
    if vol.device.type == "cpu":
        return reference(vol, rbestd=rbestd, ubest=ubest)
    return wta_planes(vol, rbestd=rbestd, ubest=ubest)
