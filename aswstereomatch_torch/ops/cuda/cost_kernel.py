"""The raw (H, W', D) cost volume in one launch: wrapper and plain version.

Counterpart of no Pallas kernel: the reference builds the volume with jnp
ops (``aswstereomatch_tpu/ops/cost.py::cost_volume``) and leaves them to
XLA fusion.  The port's plain version (``reference``: ``cost.cost_plane``
once per disparity, then a ``torch.stack`` along the last axis) dispatches
~10 ops per disparity, ~1,300 a pair at D = 128; the kernel
(``cost_kernel.cu``, bound as ``torch.ops.asw_torch.cost_volume`` by
``asw_binding.cpp``, built by ``build.py``) computes the same float32
function bit for bit in one launch.  ``cost.cost_volume`` takes the plain
version for CPU tensors and the kernel for CUDA tensors.

``cost_volume`` launches the kernel over the planes ``cost.precompute``
returns and raises on planes it cannot take (a dtype other than float32,
a colour plane of other than 1 or 3 channels, planes whose shapes do not
fit one another and D, non-contiguous planes, planes on different devices
or on a device other than CUDA, D outside [1, MAX_D]); it never falls back
to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import StereoConfig
from .. import cost
from . import build
from .common import f32

# Kernel launches since the last reset (chip_smoke.py and the tests read
# this to show that a CUDA volume was built in the kernel).  One per volume.
launches = 0

MAX_D = 2048  # cost_kernel.cu's MAX_D: a block's shared memory stays under 48 KB


def reference(planes: cost.CostPlanes, cfg: StereoConfig) -> torch.Tensor:
    """Plain PyTorch version, on any device: one ``cost_plane`` per
    disparity, stacked into (H, W + 2*x_extend, D)."""
    return torch.stack(
        [cost.cost_plane(planes, d, cfg) for d in range(cfg.max_disparity)], dim=-1
    )


def check(planes: cost.CostPlanes, D: int) -> None:
    """Raises ``ValueError`` unless the kernel can take the planes."""
    lc, rc, gl, gr = planes.lc, planes.rc, planes.gl, planes.gr
    if any(t.dtype != torch.float32 for t in (lc, rc, gl, gr)):
        raise ValueError(f"the cost kernel takes float32 planes, got "
                         f"{[str(t.dtype) for t in (lc, rc, gl, gr)]}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"the cost kernel takes 1 <= D <= {MAX_D}, got D={D}")
    if lc.ndim != 3 or lc.shape[2] not in (1, 3) or lc.numel() == 0:
        raise ValueError(f"the cost kernel takes (H, W', 3) or (H, W', 1) colour planes, "
                         f"got {tuple(lc.shape)}")
    H, Wo, C = lc.shape
    if (tuple(rc.shape), tuple(gl.shape), tuple(gr.shape)) != (
            (H, Wo + D - 1, C), (H, Wo), (H, Wo + D - 1)):
        raise ValueError(f"the planes do not fit D={D}: lc {tuple(lc.shape)}, rc "
                         f"{tuple(rc.shape)}, gl {tuple(gl.shape)}, gr {tuple(gr.shape)}")
    if not all(t.is_contiguous() for t in (lc, rc, gl, gr)):
        raise ValueError("the cost kernel takes contiguous planes")
    if any(t.device != lc.device for t in (rc, gl, gr)):
        raise ValueError(f"the planes lie on different devices: "
                         f"{[str(t.device) for t in (lc, rc, gl, gr)]}")
    if lc.device.type != "cuda":
        raise ValueError(f"no cost kernel for device {lc.device}")


def mean_factor(n_out: int, n_in: int) -> float:
    """The factor torch.mean multiplies a CUDA sum by: float32 ``n_out``
    over float32 ``n_in``, divided in float32."""
    return float(np.float32(n_out) / np.float32(n_in))


def cost_volume(planes: cost.CostPlanes, cfg: StereoConfig) -> torch.Tensor:
    """The (H, W + 2*x_extend, D) raw volume in one kernel launch:
    ``reference``'s bits."""
    global launches
    D = cfg.max_disparity
    check(planes, D)
    build.load()
    H, Wo, C = planes.lc.shape
    vol = torch.ops.asw_torch.cost_volume(
        planes.lc, planes.rc, planes.gl, planes.gr, D, int(cfg.cost == "ad"),
        mean_factor(H * Wo, H * Wo * C), f32(cfg.alpha), f32(1.0 - cfg.alpha),
        f32(cfg.tau_color), f32(cfg.tau_grad))
    launches += 1
    return vol
