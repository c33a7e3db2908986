"""High-level sharded entry point driven by the config's declared layout.

Counterpart of ``aswstereomatch_tpu.parallel.api``.
``sharded_match_fn(cfg)`` turns a StereoConfig whose mesh fields declare a
multi-device layout (mesh_data x mesh_tile, tile_axis in {y, x, d}) into
the matching callable over the corresponding function of tiling / dshard —
the config-driven front door the CLI uses, so the layout lives in one place
(the config hash covers it).
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional, Sequence

import torch

from ..config import StereoConfig
from ..models import pipeline
from . import dshard, mesh as mesh_lib, tiling


def layout_fits(cfg: StereoConfig, devices: Optional[Sequence] = None) -> bool:
    """True iff cfg declares a > 1-device mesh that fits ``devices``
    (default: ``mesh.default_devices()``, the visible cards, which raises
    where there is none); a mesh that needs more warns that the run goes
    unsharded."""
    need = cfg.mesh_data * cfg.mesh_tile
    if need <= 1:
        return False
    devices = mesh_lib.default_devices() if devices is None else list(devices)
    if need > len(devices):
        warnings.warn(
            f"config declares a {cfg.mesh_data}x{cfg.mesh_tile} mesh but only "
            f"{len(devices)} device(s) are visible; running unsharded"
        )
        return False
    return True


def sharded_match_fn(cfg: StereoConfig, devices: Optional[Sequence] = None):
    """(left, right) -> disparity callable honoring cfg's mesh layout.

    Falls back to the single-device pipeline when the layout is 1x1 or does
    not fit the devices (with a warning).  ``devices`` defaults to the
    visible cards (``mesh.default_devices()``).
    """
    if not layout_fits(cfg, devices):
        return functools.partial(pipeline.match_pair, cfg=cfg)
    devices = mesh_lib.default_devices() if devices is None else list(devices)
    m = mesh_lib.mesh_from_config(cfg, devices)
    fn = {
        "y": tiling.match_pair_tiled,
        "x": tiling.match_pair_tiled_x,
        "d": dshard.match_pair_dsharded,
    }[cfg.tile_axis]
    return functools.partial(fn, cfg=cfg, device_mesh=m)


def sharded_batch_fn(cfg: StereoConfig, devices: Optional[Sequence] = None):
    """(lefts, rights) -> disparities callable honoring cfg's mesh layout.

    Batch mode shards "data" x y-tiles; for an x / d tile_axis each pair
    goes through the single-pair layout in turn.
    """
    if not layout_fits(cfg, devices):
        return functools.partial(pipeline.match_batch, cfg=cfg)
    devices = mesh_lib.default_devices() if devices is None else list(devices)
    m = mesh_lib.mesh_from_config(cfg, devices)
    if cfg.tile_axis == "y":
        return functools.partial(tiling.match_batch_sharded, cfg=cfg, device_mesh=m)
    single = sharded_match_fn(cfg, devices)

    def batch(lefts, rights):
        if lefts.shape[0] == 0:
            return pipeline.match_batch(lefts, rights, cfg)
        return torch.stack([single(l, r) for l, r in zip(lefts, rights)])

    return batch
