"""Multi-process runtime: one mesh over every process's devices.

Counterpart of ``aswstereomatch_tpu.parallel.distributed``.
``torch.distributed`` supplies the process group (world size and rank); the
global mesh's entries are (rank, device) owners, and the layouts of
parallel/tiling.py, parallel/dshard.py and parallel/reshard.py run SPMD
over them: each process computes the shards it owns and exchanges blocks
with the others through parallel/collectives.py.  The standard launch is
one process per card (``torchrun``), each passing its own card.

  - ``initialize()``: ``torch.distributed.init_process_group`` over the
    backend the caller names (NCCL by default; gloo where asked, as the
    tests and the one-card smoke run ask), from the environment
    (``env://``) or an explicit ``host:port`` with the world size and rank.
  - ``global_devices()``: every process's devices as owners, ordered by
    rank, then by local index (``jax.devices()``'s order).
  - ``global_mesh(tile)``: (data, tile) over the global devices; the tile
    axis spans processes where it is wider than one process's devices.
  - ``run_batch_distributed``: this process's shards of a batch.

Elastic recovery is re-dispatch: pair the batch runner with utils.manifest
to resume a sweep after a relaunch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import StereoConfig
from . import mesh as mesh_lib
from . import tiling


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """Bring up the process group over ``backend`` (NCCL for cards, gloo
    for the CPU or for several processes on one card).  Without an address
    the address, world size and rank come from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with one,
    ``coordinator_address`` is ``host:port``.  Returns at once if a group
    already exists."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def global_devices(devices: Optional[Sequence] = None) -> list:
    """Every process's ``devices`` (default: the visible cards) as (rank,
    device) owners, ordered by rank, then by local index; learned with one
    ``all_gather_object``.  On NCCL the current card is set to this
    process's first, and two ranks that name one card raise."""
    local = mesh_lib.default_devices() if devices is None else [torch.device(d) for d in devices]
    if not dist.is_initialized():
        return [(0, d) for d in local]
    nccl = dist.get_backend() == "nccl"
    if nccl:
        torch.cuda.set_device(local[0])
    mine = [(str(d), str(torch.cuda.get_device_properties(d).uuid) if nccl else None)
            for d in local]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if nccl:
        seen = {}
        for rank, names in enumerate(every):
            for name, card in names:
                if seen.setdefault(card, rank) != rank:
                    raise ValueError(
                        f"ranks {seen[card]} and {rank} name one card ({name}); NCCL takes "
                        "one card per rank: pass each process its own, e.g. "
                        "devices=[torch.device(\"cuda\", local_rank)]")
    return [(rank, torch.device(name)) for rank, names in enumerate(every) for name, _ in names]


def global_mesh(tile: Optional[int] = None, devices: Optional[Sequence] = None) -> mesh_lib.Mesh:
    """(data, tile) mesh over every process's ``devices`` (default: the
    visible cards), in ``global_devices`` order.

    ``tile`` defaults to this process's device count, so a pair's tiles
    stay within a process and the data axis maps across processes; a wider
    tile axis spans processes.  As in the reference, ``tile`` shrinks to
    the largest count that divides the global devices.
    """
    owners = global_devices(devices)
    n = len(owners)
    if tile is None:
        tile = min(sum(r == mesh_lib.this_rank() for r, _ in owners), n)
    while n % tile:
        tile -= 1
    return mesh_lib.build_mesh(n // tile, tile, owners)


def run_batch_distributed(
    lefts: np.ndarray,
    rights: np.ndarray,
    cfg: StereoConfig,
    device_mesh: Optional[mesh_lib.Mesh] = None,
) -> list:
    """Match this process's shards of a (B, H, W[, 3]) batch.

    B must divide by the mesh's data axis; data row i takes pairs
    [i * B/nd, (i + 1) * B/nd), y-tiled over its row's owners.  Returns
    this process's result blocks (``mesh.Shard``s), one per (data, tile)
    shard it owns, each with its global (batch, row) index, on its shard's
    device.
    """
    if device_mesh is None:
        device_mesh = global_mesh()
    as_tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return tiling.match_batch_shards(as_tensor(lefts), as_tensor(rights), cfg, device_mesh)


def weak_scaling_report(times_by_n: dict) -> dict:
    """Weak-scaling efficiency table from {n_devices: seconds_per_batch}
    where the batch grows proportionally with n (target: >= 0.8)."""
    if not times_by_n:
        return {}
    base_n = min(times_by_n)
    base_t = times_by_n[base_n]
    return {
        n: round(base_t / t, 4) if t > 0 else float("nan")
        for n, t in sorted(times_by_n.items())
    }
