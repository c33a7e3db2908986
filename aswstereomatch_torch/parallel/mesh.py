"""Device meshes for the sharded layouts.

Counterpart of ``aswstereomatch_tpu.parallel.mesh``.  A ``Mesh`` is a
(data, tile) array of shard owners, each a ``(rank, torch.device)``: the
process that computes the shard and the device it computes it on.

  - axis "data": independent stereo pairs (batch); no communication within
    a step;
  - axis "tile": one pair's image rows (y), columns (x) or disparities (d)
    (parallel/tiling.py, parallel/dshard.py); the halo, strip, gather and
    reshard exchanges run between its shards (parallel/collectives.py).

The layouts are SPMD over the owners, as the reference's ``shard_map`` is:
every process runs the same layout function, computes only the shards it
owns, and receives its neighbours' blocks through the transport.  A mesh
whose owners are all this process (``build_mesh`` over local devices, the
only kind without a process group) is the case where every move stays in
the process.  A device may repeat in the array (``[cuda:0] * 4`` is a
4-shard mesh on one card; ``[cpu] * 8`` the tests' mesh), which runs every
sharded path with its shards in turn.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TILE_AXIS = "tile"


def this_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """``devices``: a (data, tile) numpy object array of ``torch.device``;
    ``ranks``: the (data, tile) array of the ranks that own them (default:
    every entry this process's); ``rank``: this process's rank;
    ``shape``: the axis sizes by name."""

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, tile) array, got {devices.shape}")
        self.devices = devices
        self.rank = this_rank()
        self.ranks = np.full(devices.shape, self.rank) if ranks is None else ranks
        self.shape = {DATA_AXIS: devices.shape[0], TILE_AXIS: devices.shape[1]}

    def tile_devices(self, data_index: int = 0) -> list:
        """The devices of one data row, in tile order."""
        return list(self.devices[data_index])

    def owners(self, data_index: int = 0) -> list:
        """The (rank, device) owners of one data row, in tile order."""
        return [(int(r), d) for r, d in zip(self.ranks[data_index], self.devices[data_index])]

    def local_shards(self) -> list:
        """The (data, tile) indices of the shards this process owns."""
        return [tuple(int(i) for i in ix) for ix in np.argwhere(self.ranks == self.rank)]

    @property
    def is_local(self) -> bool:
        """True where this process owns every shard."""
        return bool((self.ranks == self.rank).all())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.ranks.tolist()}, {self.devices.tolist()})"


class Shard(NamedTuple):
    """One block of a layout's result on a mesh that spans processes (the
    reference's ``addressable_shards``): ``index`` is its tuple of slices
    of the global result, ``data`` the block on its shard's device."""

    index: tuple
    data: torch.Tensor


def visible_cards() -> list:
    """Every visible card, in index order (none on a machine without one)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_devices() -> list:
    """Every visible card; raises where there is none (the CPU is asked
    for, never fallen back to)."""
    cards = visible_cards()
    if not cards:
        raise ValueError(
            "no card is visible; pass devices=[torch.device(\"cpu\")] to run a "
            "mesh on the CPU"
        )
    return cards


def build_mesh(
    data: int = 1,
    tile: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh of shape (data, tile) over the given devices (default: every
    visible card), taken in order.  An entry is a device of this process or
    a ``(rank, device)`` owner (``distributed.global_devices()``)."""
    owners = [d if isinstance(d, tuple) else (this_rank(), d)
              for d in (visible_cards() if devices is None else devices)]
    need = data * tile
    if len(owners) < need:
        raise ValueError(
            f"mesh ({data} x {tile}) needs {need} devices, have {len(owners)}"
        )
    arr = np.empty(need, dtype=object)
    arr[:] = [torch.device(d) for _, d in owners[:need]]
    ranks = np.array([int(r) for r, _ in owners[:need]]).reshape(data, tile)
    return Mesh(arr.reshape(data, tile), ranks)


def single_device_mesh(devices: Optional[Sequence] = None) -> Mesh:
    return build_mesh(1, 1, devices)


def mesh_from_config(cfg, devices: Optional[Sequence] = None) -> Mesh:
    """Mesh for a StereoConfig's declared (mesh_data, mesh_tile) layout."""
    return build_mesh(data=cfg.mesh_data, tile=cfg.mesh_tile, devices=devices)
