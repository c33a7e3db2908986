"""Multi-process runtime: the batch ("data") axis across processes.

Counterpart of ``aswstereomatch_tpu.parallel.distributed``.  Stereo pairs
are independent, so across processes only the batch is split: each process
matches its contiguous slice of the batch on its own devices (data rows of
its local mesh, rows y-tiled over the tile axis there) and returns its
result shards, each with its global (batch, row) index.  No tensor crosses
a process boundary within a step; ``torch.distributed`` supplies the
process group (world size and rank).

  - ``initialize()``: ``torch.distributed.init_process_group`` over gloo on
    the CPU or NCCL on cards, from the environment (``env://``) or an
    explicit ``host:port`` with the world size and rank.
  - ``global_mesh(tile)``: the tile axis takes this process's local devices,
    the data axis spans processes x local data rows.
  - ``run_batch_distributed``: this process's slice of a batch.

A tile axis spanning processes (one pair's rows, columns or disparities
over devices of several processes) is not ported and raises.  Elastic
recovery is re-dispatch: pair the batch runner with utils.manifest to
resume a sweep after a relaunch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

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
) -> None:
    """Bring up the process group: gloo where no card is visible, NCCL on
    cards.  Without arguments the address, world size and rank come from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); with them, ``coordinator_address`` is ``host:port``.  Returns
    at once if a group already exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def _processes() -> tuple:
    """(process count, this process's index): (1, 0) without a group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class GlobalMesh(NamedTuple):
    """The data x tile layout over every process: ``local`` is this
    process's (local data, tile) mesh; the data axis spans ``processes`` of
    them, this one at ``process_index``."""

    local: mesh_lib.Mesh
    processes: int
    process_index: int

    @property
    def shape(self) -> dict:
        return {mesh_lib.DATA_AXIS: self.processes * self.local.shape[mesh_lib.DATA_AXIS],
                mesh_lib.TILE_AXIS: self.local.shape[mesh_lib.TILE_AXIS]}


def global_mesh(tile: Optional[int] = None, devices: Optional[Sequence] = None) -> GlobalMesh:
    """(data, tile) mesh over every process's ``devices`` (default: the
    visible cards, or the CPU where there is none).

    ``tile`` defaults to the local device count, so a pair's tiles stay
    within a process and the data axis maps across processes.  A tile axis
    larger than the local devices would span processes: not ported.
    """
    local = mesh_lib.default_devices() if devices is None else list(devices)
    n_proc, index = _processes()
    if tile is None:
        tile = len(local)
    if tile > len(local):
        raise ValueError(
            f"a tile axis of {tile} spans processes ({len(local)} local devices): "
            "one pair's shards over several processes is not ported (ROADMAP.md, "
            "section 1: the cross-process tile axis)"
        )
    while len(local) % tile:
        tile -= 1
    return GlobalMesh(mesh_lib.build_mesh(len(local) // tile, tile, local), n_proc, index)


class Shard(NamedTuple):
    """One block of a distributed result: ``index`` is its (batch, row)
    slice of the global (B, H, W) result, ``data`` the block on its
    (data, tile) device."""

    index: tuple
    data: torch.Tensor


def run_batch_distributed(
    lefts: np.ndarray,
    rights: np.ndarray,
    cfg: StereoConfig,
    device_mesh: Optional[GlobalMesh] = None,
) -> list:
    """Match this process's slice of a (B, H, W[, 3]) batch.

    B must divide by the global data axis; data row i of the global mesh
    takes pairs [i * B/nd, (i + 1) * B/nd), and this process holds rows
    [p * local, (p + 1) * local).  Returns this process's result blocks
    (``Shard``s), one per local (data, tile) device, each with its global
    (batch, row) index.
    """
    if device_mesh is None:
        device_mesh = global_mesh()
    nd = device_mesh.shape[mesh_lib.DATA_AXIS]
    local = device_mesh.local
    nd_local = local.shape[mesh_lib.DATA_AXIS]
    nt = local.shape[mesh_lib.TILE_AXIS]
    b, h = len(lefts), lefts.shape[1]
    if b % nd:
        raise ValueError(f"batch {b} not divisible by data axis {nd}")
    per = b // nd
    b0 = device_mesh.process_index * nd_local * per
    take = lambda a: torch.from_numpy(np.ascontiguousarray(a[b0:b0 + nd_local * per]))  # noqa: E731
    out = tiling.match_batch_sharded(take(lefts), take(rights), cfg, local)
    rows = -(-h // nt)
    shards = []
    for i in range(nd_local):
        for k in range(nt):
            bs = slice(b0 + i * per, b0 + (i + 1) * per)
            rs = slice(min(k * rows, h), min((k + 1) * rows, h))
            blk = out[i * per:(i + 1) * per, rs]
            shards.append(Shard((bs, rs), blk.to(local.devices[i, k])))
    return shards


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
