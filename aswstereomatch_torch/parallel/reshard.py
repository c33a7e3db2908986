"""All-to-all reshard between the column-sharded and the disparity-sharded
layouts of an aggregated volume — the Ulysses analog.

Counterpart of ``aswstereomatch_tpu.parallel.reshard``.  The spatially
sharded layout that cost construction likes (each shard holds all D for a
column band) and the disparity-sharded one that a WTA combine likes (each
shard holds a D-slab for all columns) are two placements of one (H, W, D)
volume; the switch is one all-to-all over the mesh "tile" axis, here a
split on each shard's device and a concatenation of the moved pieces on
the receiving one.

The end-to-end paths avoid it (K1 tracks the WTA online; dshard.py
aggregates slabs directly); it serves pipelines that materialize slabs.
Both functions take and return the list of per-shard blocks in tile order,
values unchanged.
"""

from __future__ import annotations

import torch

from . import mesh as mesh_lib
from .tiling import _to


def x_to_d(blocks: list, device_mesh: mesh_lib.Mesh) -> list:
    """Column-sharded (H, W/n, D) blocks -> disparity-sharded (H, W, D/n)
    blocks (the reference's ``P(None, "tile", None)`` to
    ``P(None, None, "tile")``): shard j receives its D-chunk of every
    shard's columns, concatenated in shard (= global column) order."""
    devices = device_mesh.tile_devices()
    _check(blocks, devices)
    pieces = [torch.tensor_split(b, len(devices), dim=2) for b in blocks]
    return [torch.cat([_to(p[j], dev) for p in pieces], dim=1)
            for j, dev in enumerate(devices)]


def d_to_x(blocks: list, device_mesh: mesh_lib.Mesh) -> list:
    """Inverse reshard: (H, W, D/n) blocks -> (H, W/n, D) blocks."""
    devices = device_mesh.tile_devices()
    _check(blocks, devices)
    pieces = [torch.tensor_split(b, len(devices), dim=1) for b in blocks]
    return [torch.cat([_to(p[i], dev) for p in pieces], dim=2)
            for i, dev in enumerate(devices)]


def _check(blocks: list, devices: list) -> None:
    if len(blocks) != len(devices):
        raise ValueError(f"{len(blocks)} blocks for {len(devices)} tile shards")
