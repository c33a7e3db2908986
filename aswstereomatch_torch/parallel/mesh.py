"""Device meshes for the sharded layouts.

Counterpart of ``aswstereomatch_tpu.parallel.mesh``.  A ``Mesh`` is a
(data, tile) array of ``torch.device``s:

  - axis "data": independent stereo pairs (batch); no communication within
    a step;
  - axis "tile": one pair's image rows (y), columns (x) or disparities (d)
    (parallel/tiling.py, parallel/dshard.py); the halo and combine moves
    run between its devices.

The program is one controller, as the reference's ``shard_map`` is: a
layout function takes whole tensors, cuts them into per-shard blocks on the
shards' devices, runs the per-shard work there and moves blocks between
devices where the reference has a collective.  A device may repeat in the
array (``[cuda:0] * 4`` is a 4-shard mesh on one card; ``[cpu] * 8`` the
tests' mesh), which runs every sharded path with its shards in turn.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
TILE_AXIS = "tile"


class Mesh:
    """``devices``: a (data, tile) numpy object array of ``torch.device``;
    ``shape``: the axis sizes by name."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, tile) array, got {devices.shape}")
        self.devices = devices
        self.shape = {DATA_AXIS: devices.shape[0], TILE_AXIS: devices.shape[1]}

    def tile_devices(self, data_index: int = 0) -> list:
        """The devices of one data row, in tile order."""
        return list(self.devices[data_index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def visible_cards() -> list:
    """Every visible card, in index order (none on a machine without one)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_devices() -> list:
    """Every visible card, or the CPU where there is none."""
    return visible_cards() or [torch.device("cpu")]


def build_mesh(
    data: int = 1,
    tile: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh of shape (data, tile) over the given devices (default: every
    visible card), taken in order."""
    devices = [torch.device(d) for d in (visible_cards() if devices is None else devices)]
    need = data * tile
    if len(devices) < need:
        raise ValueError(
            f"mesh ({data} x {tile}) needs {need} devices, have {len(devices)}"
        )
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(data, tile))


def single_device_mesh(devices: Optional[Sequence] = None) -> Mesh:
    return build_mesh(1, 1, devices)


def mesh_from_config(cfg, devices: Optional[Sequence] = None) -> Mesh:
    """Mesh for a StereoConfig's declared (mesh_data, mesh_tile) layout."""
    return build_mesh(data=cfg.mesh_data, tile=cfg.mesh_tile, devices=devices)
