"""The disparity map from one pair's WTA planes in one launch: wrapper and
plain version.

Counterpart of no Pallas kernel: the reference leaves subpixel, the LR
check, the uniqueness gate, hole filling and the 3x3 median to XLA as jnp
ops.  The port's plain version (``reference``) dispatches ~40 ops a map,
and its hole filling copies a scalar from the host, which makes the host
wait for the card; the kernel (``disparity_kernel.cu``, bound as
``torch.ops.asw_torch.disparity_map`` by ``asw_binding.cpp``, built by
``build.py``) computes the same float32 map bit for bit in one launch and
never waits.  ``models/pipeline.py`` takes the plain version for CPU planes
and the kernel for CUDA planes.

``disparity_map`` raises on planes the kernel cannot take (a missing
plane, a dtype other than int32 for ``bestd`` / ``rbestd`` and float32 for
the rest, planes of other shapes than one (H, W), empty or wider than
MAX_W, non-contiguous planes, planes on different devices or on a device
other than CUDA); it never falls back to the plain version.
"""

from __future__ import annotations

import torch

from ...config import StereoConfig
from .. import postprocess, wta
from . import build
from .common import f32

# Kernel launches since the last reset (chip_smoke.py and the tests read
# this to show that a map came from the kernel).  One per map.
launches = 0

MAX_W = 8192  # disparity_kernel.cu's MAX_W: a band's rows fit a block's shared memory


def reference(planes: dict, cfg: StereoConfig, median: bool) -> torch.Tensor:
    """Plain PyTorch version, on any device: subpixel, LR check, uniqueness
    gate and hole filling from the planes (everything row-local), then,
    where ``median``, the plain 3x3 median."""
    disp_i = planes["bestd"]
    if cfg.subpixel:
        disp = wta.subpixel_from_triple(
            disp_i, planes["bestc"], planes["cm"], planes["cp"], cfg.max_disparity
        )
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
    return postprocess.median3(disp) if median else disp


def _needed(cfg: StereoConfig) -> dict:
    """The planes the kernel reads under ``cfg``, with their dtypes."""
    need = {"bestd": torch.int32, "bestc": torch.float32, "cm": torch.float32,
            "cp": torch.float32}
    if cfg.lr_check:
        need["rbestd"] = torch.int32
    if cfg.uniqueness_ratio > 0:
        need["ubest"] = torch.float32
    return need


def check(planes: dict, cfg: StereoConfig) -> None:
    """Raises ``ValueError`` unless the kernel can take the planes."""
    need = _needed(cfg)
    missing = [k for k in need if k not in planes]
    if missing:
        raise ValueError(f"the disparity kernel needs the planes {missing} under this config")
    wrong = {k: str(planes[k].dtype) for k, t in need.items() if planes[k].dtype != t}
    if wrong:
        raise ValueError(f"the disparity kernel takes int32 bestd / rbestd and float32 "
                         f"bestc / cm / cp / ubest, got {wrong}")
    shape = tuple(planes["bestd"].shape)
    if len(shape) != 2 or 0 in shape or any(tuple(planes[k].shape) != shape for k in need):
        raise ValueError(f"the disparity kernel takes non-empty planes of one (H, W) shape, "
                         f"got {({k: tuple(planes[k].shape) for k in need})}")
    if shape[1] > MAX_W:
        raise ValueError(f"the disparity kernel takes W <= {MAX_W}, got W={shape[1]}")
    if not all(planes[k].is_contiguous() for k in need):
        raise ValueError("the disparity kernel takes contiguous planes")
    device = planes["bestd"].device
    if any(planes[k].device != device for k in need):
        raise ValueError(f"the planes lie on different devices: "
                         f"{({k: str(planes[k].device) for k in need})}")
    if device.type != "cuda":
        raise ValueError(f"no disparity kernel for device {device}")


def disparity_map(planes: dict, cfg: StereoConfig, median: bool) -> torch.Tensor:
    """The float32 (H, W) map in one kernel launch: ``reference``'s bits."""
    global launches
    check(planes, cfg)
    build.load()
    lr, uniq = cfg.lr_check, cfg.uniqueness_ratio > 0
    out = torch.ops.asw_torch.disparity_map(
        planes["bestd"], planes["bestc"], planes["cm"], planes["cp"],
        planes["rbestd"] if lr else None, planes["ubest"] if uniq else None,
        cfg.max_disparity, int(cfg.subpixel), int(lr), f32(cfg.lr_tol), int(uniq),
        f32(100.0 + cfg.uniqueness_ratio), int(cfg.fill_holes), int(median))
    launches += 1
    return out
