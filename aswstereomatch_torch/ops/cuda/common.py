"""What the kernel wrappers (``asw_kernel``, ``asw_sep_kernel``,
``asw_dlanes_kernel``, ``asw_sym_dlanes_kernel``) share.

The channel stacks every kernel takes, the order of their output planes,
the CPU/CUDA dispatch, the float32 rounding of scalar constants and the
constant tables kept on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import StereoConfig
from ...utils.profiling import span
from . import stacks_kernel

# The kernels' outputs, in the order the bound ops return them.
PLANES = ("bestd", "bestc", "cm", "cp", "ubest", "rbestd")


def stacks(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig):
    """Edge-extended channel stacks: (7, H, W + 2r) and (7, H, W + 2r + D - 1).
    The plain version for CPU tensors; otherwise the stack kernel, one launch
    for both views, which raises on an input it cannot take."""
    r = cfg.window_radius
    D = cfg.max_disparity
    with span("pipeline.preprocess"):
        if left.device.type == "cpu":
            return stacks_kernel.reference(left, right, r, D)
        return stacks_kernel.channel_stacks(left, right, r, D)


def dispatch(ls_ext: torch.Tensor, rs_ext: torch.Tensor, cfg: StereoConfig,
             plain, launch) -> dict:
    """``plain`` for CPU tensors, ``launch`` (the kernel, which raises if it
    cannot run) for CUDA tensors; any other device raises."""
    if ls_ext.device.type == "cpu":
        return plain(ls_ext, rs_ext, cfg)
    if ls_ext.device.type != "cuda":
        raise ValueError(f"no kernel for device {ls_ext.device}")
    return launch(ls_ext, rs_ext, cfg)


def f32(v: float) -> float:
    """A kernel constant, rounded to float32 as the Pallas kernels round it."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=32)
def device_table(make, cfg: StereoConfig, device: torch.device) -> torch.Tensor:
    """``make(cfg)``, a float32 numpy table, as a tensor on ``device``: built
    and copied once per table, config and device, not at every launch."""
    return torch.from_numpy(make(cfg)).to(device)
