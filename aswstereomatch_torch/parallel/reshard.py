"""All-to-all reshard between the column-sharded and the disparity-sharded
layouts of an aggregated volume — the Ulysses analog.

Counterpart of ``aswstereomatch_tpu.parallel.reshard``.  The spatially
sharded layout that cost construction likes (each shard holds all D for a
column band) and the disparity-sharded one that a WTA combine likes (each
shard holds a D-slab for all columns) are two placements of one (H, W, D)
volume; the switch is one all-to-all over the mesh "tile" axis
(``collectives.all_to_all``): each shard splits its block, and each
receives its pieces from every shard, within the process or through
``torch.distributed``.

The end-to-end paths avoid it (K1 tracks the WTA online; dshard.py
aggregates slabs directly); it serves pipelines that materialize slabs.
Both functions take and return this process's per-shard blocks in tile
order (every block, where the mesh is this process's), one shape on every
shard as the reference's tiled all_to_all has them, values unchanged.
"""

from __future__ import annotations

import torch

from . import collectives
from . import mesh as mesh_lib


def _all_to_all(blocks: list, device_mesh: mesh_lib.Mesh, split: int, concat: int) -> list:
    """Each block cut in n along ``split``, piece j to shard j; each shard's
    pieces from every shard concatenated along ``concat`` in shard order."""
    group = collectives.Group.of(device_mesh)
    if len(blocks) != len(group.local):
        raise ValueError(
            f"{len(blocks)} blocks for the {len(group.local)} tile shards this process owns")
    pieces = {k: torch.tensor_split(b, group.size, dim=split) for k, b in zip(group.local, blocks)}
    # shard i's piece for j has the shape of j's own piece j
    got = collectives.all_to_all(group, pieces,
                                 lambda i, j: (pieces[j][j].shape, pieces[j][j].dtype))
    return [torch.cat(got[j], dim=concat) for j in group.local]


def x_to_d(blocks: list, device_mesh: mesh_lib.Mesh) -> list:
    """Column-sharded (H, W/n, D) blocks -> disparity-sharded (H, W, D/n)
    blocks (the reference's ``P(None, "tile", None)`` to
    ``P(None, None, "tile")``): shard j receives its D-chunk of every
    shard's columns, concatenated in shard (= global column) order."""
    return _all_to_all(blocks, device_mesh, 2, 1)


def d_to_x(blocks: list, device_mesh: mesh_lib.Mesh) -> list:
    """Inverse reshard: (H, W, D/n) blocks -> (H, W/n, D) blocks."""
    return _all_to_all(blocks, device_mesh, 1, 2)
