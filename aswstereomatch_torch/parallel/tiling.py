"""Spatial tiling with halo exchange: y- and x-sharded layouts of one pair,
and data x tile batches.

Counterpart of ``aswstereomatch_tpu.parallel.tiling``, with the same
names, checks and messages.  The reference runs each layout under
``shard_map``; here each layout is SPMD over the mesh's owners
(parallel/mesh.py): every process runs the same function on the pair it
holds, cuts and computes only the shards it owns, and receives its
neighbours' rows, columns, strips and winner planes through the transport
(parallel/collectives.py), which moves a block within a process to the
shard's device and between processes through ``torch.distributed``.
Launches on distinct cards are asynchronous, so their shards overlap;
shards on one device run in turn.

  - y-tiling: each shard matches its rows plus ``halo_y`` rows from each
    neighbour through the single-device band function
    (``pipeline.tile_disparity``), so it reaches the kernels through
    ``kernel_for`` as an unsharded run does.  Boundary shards take
    edge-replicated rows; the median reads global-row-clamped rows.
  - x-tiling: the left stack travels with an r-column halo, the right stack
    with an (r + D - 1)-column left halo; each shard runs cost + aggregation
    + WTA on its columns (K1 with ``n_valid_cols`` and the right-view strip
    on the kernel route, the materialized volume on the eager one), merges
    its right view with the next shard's strip by strict < (first
    occurrence kept), and the small winner planes are gathered for the
    x-global post-processing.

A layout returns the whole map on the inputs' device where this process
owns every shard, and this process's ``mesh.Shard``s (a global index and
the block on its shard's device) on a mesh that spans processes.

Invariant (tested): every layout equals the unsharded run bit for bit.
"""

from __future__ import annotations

import torch

from ..config import StereoConfig
from ..models import pipeline
from ..ops import aggregate, preprocess
from ..ops.cuda import asw_kernel
from . import collectives
from . import mesh as mesh_lib
from .collectives import to_device
from .mesh import Shard


def _halo_rows(cfg: StereoConfig) -> int:
    """Image rows of halo each side (see StereoConfig.halo_y)."""
    return cfg.halo_y


def _shard_device(devices: list) -> torch.device:
    """The device whose type decides a layout's route: the tile devices',
    which must all be of one type (the inputs' device only receives the
    result)."""
    kinds = sorted({torch.device(d).type for d in devices})
    if len(kinds) > 1:
        raise ValueError(f"a layout's tile devices must be of one type, got {kinds}")
    return torch.device(devices[0])


def _edge(t: torch.Tensor, dim: int, count: int) -> torch.Tensor:
    """``count`` copies of a one-wide slice along ``dim``."""
    return t.expand(*[count if i == dim else s for i, s in enumerate(t.shape)])


def _exchange(group: collectives.Group, blocks: dict, halos: list, dim: int) -> dict:
    """Each local shard's parts extended along ``dim``, part p by
    ``halos[p]`` = (lo, hi) entries: ``lo`` from the previous shard's end
    and ``hi`` from the next shard's start (the reference's two
    ppermutes), on its own device; boundary shards take edge replicas of
    their own first / last entry (the untiled edge-replicated plane).
    ``blocks``: {k: [parts]} for the local shards, every shard's parts of
    one shape."""
    n = group.size

    def part(src, dst):
        if dst == src + 1:
            return [t.narrow(dim, t.shape[dim] - lo, lo) for t, (lo, _) in zip(blocks[src], halos)]
        return [t.narrow(dim, 0, hi) for t, (_, hi) in zip(blocks[src], halos)]

    def like(src, dst):
        sizes = [lo if dst == src + 1 else hi for lo, hi in halos]
        return [(tuple(size if i == dim else s for i, s in enumerate(t.shape)), t.dtype)
                for t, size in zip(blocks[dst], sizes)]

    msgs = [(k, k + 1) for k in range(n - 1)] + [(k + 1, k) for k in range(n - 1)]
    got = collectives.exchange(group, msgs, part, like, "halo")
    out = {}
    for k in group.local:
        ext = []
        for p, (t, (lo, hi)) in enumerate(zip(blocks[k], halos)):
            prev = got[(k - 1, k)][p] if k > 0 else _edge(t.narrow(dim, 0, 1), dim, lo)
            nxt = (got[(k + 1, k)][p] if k < n - 1
                   else _edge(t.narrow(dim, t.shape[dim] - 1, 1), dim, hi))
            ext.append(torch.cat([prev, t, nxt], dim=dim))
        out[k] = ext
    return out


def _rows_tiled(lefts: torch.Tensor, rights: torch.Tensor, cfg: StereoConfig,
                group: collectives.Group, true_h: int) -> dict:
    """Pairs (P, rows * n, W[, 3]), their rows sharded over ``group``'s n
    shards: {k: the owned rows (P, rows, W) of local shard k}.  One halo
    exchange carries the P pairs."""
    rows = lefts.shape[1] // group.size
    halo = _halo_rows(cfg)
    blocks = {k: [to_device(a[:, k * rows:(k + 1) * rows], group.device(k))
                  for a in (lefts, rights)] for k in group.local}
    ext = _exchange(group, blocks, [(halo, halo)] * 2, 1)
    return {k: torch.stack([pipeline.tile_disparity(l_ext, r_ext, cfg, halo, rows, true_h,
                                                    k * rows)
                            for l_ext, r_ext in zip(*ext[k])])
            for k in group.local}


def _span(k: int, size: int, end: int) -> slice:
    """Shard k's slice of an axis cut in ``size``s, clipped to ``end``."""
    return slice(min(k * size, end), min((k + 1) * size, end))


def _result(device_mesh: mesh_lib.Mesh, shards: list, shape: tuple, device):
    """A layout's result: this process's ``Shard``s on a mesh that spans
    processes; where every shard is local, the whole (float32) map on
    ``device``."""
    if not device_mesh.is_local:
        return shards
    out = torch.empty(shape, dtype=torch.float32, device=device)
    for s in shards:
        out[s.index].copy_(s.data)
    return out


def _pad_rows(n: int, cfg: StereoConfig, *imgs, dim: int = 0):
    """Bottom edge rows up to a multiple of ``n``; raises when a shard's
    rows are fewer than the halo."""
    h = imgs[0].shape[dim]
    pad = (-h) % n
    out = [preprocess.pad_edge(a, dim, 0, pad) if pad else a for a in imgs]
    rows = out[0].shape[dim] // n
    halo = _halo_rows(cfg)
    if rows < halo:
        raise ValueError(f"{rows} rows/shard < halo {halo}; use fewer tile shards")
    return out


def _reject_global_aggregation(cfg: StereoConfig) -> None:
    """Scanline-global modes cannot tile: SGM's path recurrences propagate
    across the whole image, so no finite halo reproduces the untiled
    result.  Reject instead of silently breaking the bit-exactness
    invariant (an unsharded run serves these configs)."""
    if cfg.aggregation == "sgm":
        raise ValueError(
            "aggregation='sgm' propagates globally along scanlines and "
            "does not support spatial tiling; run unsharded"
        )


def match_pair_tiled(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
):
    """Single pair, y-sharded over the mesh "tile" axis (the first data
    row's owners).

    Pads H to a multiple of the tile count (bottom, edge rows) and trims;
    real rows are bit-identical to the untiled pipeline.  Returns (H, W) on
    the inputs' device, or on a mesh that spans processes this process's
    ``Shard``s, each its rows of the map.
    """
    _reject_global_aggregation(cfg)
    n = device_mesh.shape[mesh_lib.TILE_AXIS]
    h, w = left.shape[:2]
    left, right = _pad_rows(n, cfg, left, right)
    rows = left.shape[0] // n
    outs = _rows_tiled(left[None], right[None], cfg, collectives.Group.of(device_mesh), h)
    shards = []
    for k, out in outs.items():
        span = _span(k, rows, h)
        shards.append(Shard((span, slice(0, w)), out[0, :span.stop - span.start]))
    return _result(device_mesh, shards, (h, w), left.device)


def match_batch_shards(
    lefts: torch.Tensor,
    rights: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
) -> list:
    """This process's ``Shard``s of ``match_batch_sharded``'s result, each a
    (batch, row) block of the (B, H, W) maps on its shard's device."""
    nd = device_mesh.shape[mesh_lib.DATA_AXIS]
    nt = device_mesh.shape[mesh_lib.TILE_AXIS]
    if nt > 1:
        # Pure data-axis sharding keeps every pair's scanlines intact, so
        # SGM batches shard fine at tile=1; only the spatial split is
        # rejected.
        _reject_global_aggregation(cfg)
    b, h = lefts.shape[0], lefts.shape[1]
    if b % nd:
        raise ValueError(f"batch {b} not divisible by data axis {nd}")
    per = b // nd
    mine = sorted({i for i, _ in device_mesh.local_shards()})
    if cfg.aggregation == "sgm":
        # Data-only layout (nt == 1, enforced above): each shard runs the
        # UNSHARDED pipeline on its local pairs — no y halos, because even
        # edge-replicated halo rows would perturb the global scanline
        # recurrence.
        return [Shard((slice(i * per, (i + 1) * per), slice(0, h)),
                      pipeline.match_batch(to_device(lefts[i * per:(i + 1) * per], dev),
                                           to_device(rights[i * per:(i + 1) * per], dev), cfg))
                for i in mine for dev in device_mesh.tile_devices(i)]
    lefts, rights = _pad_rows(nt, cfg, lefts, rights, dim=1)
    rows = lefts.shape[1] // nt
    shards = []
    for i in mine if per else ():
        batch = slice(i * per, (i + 1) * per)
        outs = _rows_tiled(lefts[batch], rights[batch], cfg,
                           collectives.Group.of(device_mesh, i), h)
        for k, out in outs.items():
            span = _span(k, rows, h)
            shards.append(Shard((batch, span), out[:, :span.stop - span.start]))
    return shards


def match_batch_sharded(
    lefts: torch.Tensor,
    rights: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
):
    """Batched throughput mode: batch over "data" x rows over "tile".

    (B, H, W[, 3]) inputs; data row i matches the i-th contiguous slice of
    the batch, one halo exchange for the slice's pairs, each pair y-tiled
    over its row's shards.  Returns (B, H, W) on the inputs' device, or on
    a mesh that spans processes this process's ``Shard``s
    (``match_batch_shards``).
    """
    shards = match_batch_shards(lefts, rights, cfg, device_mesh)
    return _result(device_mesh, shards, tuple(lefts.shape[:3]), lefts.device)


def shard_batch_arrays(arrays, device_mesh: mesh_lib.Mesh):
    """Each (B, H, ...) tensor of ``arrays`` cut data x tile: a list over the
    data axis of lists over the tile axis of blocks, block (i, k) holding
    the i-th batch slice's k-th row slice on device (i, k) (the reference's
    ``P("data", "tile")`` placement), or None where another process owns
    shard (i, k).  B must divide by the data axis; rows are cut as evenly
    as they go."""
    nd = device_mesh.shape[mesh_lib.DATA_AXIS]
    nt = device_mesh.shape[mesh_lib.TILE_AXIS]
    mine = set(device_mesh.local_shards())

    def put(a):
        if a.shape[0] % nd:
            raise ValueError(f"batch {a.shape[0]} not divisible by data axis {nd}")
        return [[to_device(blk, device_mesh.devices[i, k]) if (i, k) in mine else None
                 for k, blk in enumerate(torch.tensor_split(part, nt, dim=1))]
                for i, part in enumerate(torch.tensor_split(a, nd, dim=0))]

    return type(arrays)(put(a) for a in arrays)


# ---------------------------------------------------------------------------
# x-axis tiling — the ring / D_max-halo layout
# ---------------------------------------------------------------------------

def _kernel_route(cfg: StereoConfig, device, uses: str) -> bool:
    """True where ``cfg`` runs on a kernel on ``device``; a sharded layout
    then runs K1 (the x-lanes kernel's counterpart, for what ``uses``
    names), and refuses the configs K1 does not compute rather than run
    something else."""
    if pipeline._resolve_backend(cfg, device) != "cuda":
        return False
    if cfg.kernel_layout == "dlanes":
        raise ValueError(
            f"kernel_layout='dlanes' is a single-shard fast path; {uses} "
            "— use kernel_layout 'auto' or 'xlanes'"
        )
    if cfg.asw_separable:
        raise ValueError(
            "the exact x-lanes kernel does not implement separable ASW; "
            "sharded separable runs use the eager from_stacks path"
        )
    return True


def match_pair_tiled_x(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
):
    """Single pair, x-sharded over the mesh "tile" axis (ASW and box).

    Per shard: cost + aggregation + WTA over its columns from real
    neighbour columns; right-view partials merged with the next shard's
    (D-1)-column strip (strict <, preserving first-min); the small per-view
    winner planes are then gathered so the x-global post-processing stages
    (LR gather along x, row fill, median) run replicated, once per owner —
    bit-identical to the untiled pipeline.  Returns (H, W) on the inputs'
    device, or on a mesh that spans processes this process's ``Shard``s,
    each its columns of the map.

    Kernel route: x-tiling needs K1's right-view strip, so left-only ASW
    and box run K1 here even where the unsharded ``kernel_layout="auto"``
    resolves them to the d-lanes kernel: bit-exact vs the unsharded run at
    ``kernel_layout="xlanes"``.  An explicit ``kernel_layout="dlanes"`` and
    a separable config are refused there.
    """
    _reject_global_aggregation(cfg)
    if cfg.aggregation not in ("asw", "box"):
        raise ValueError("x-tiling covers the asw/box aggregations")
    n = device_mesh.shape[mesh_lib.TILE_AXIS]
    D = cfg.max_disparity
    hl_right, hr = cfg.halo_x  # right-stack halos: (r + D - 1, r)
    h, w = left.shape[:2]
    pad = (-w) % n
    ws = (w + pad) // n
    if hl_right > ws:
        raise ValueError(
            f"right-image halo {hl_right} exceeds {ws} cols/shard; "
            "use fewer x-shards"
        )
    use_kernel = _kernel_route(
        cfg, _shard_device(device_mesh.tile_devices()),
        "x-tiled runs use the x-lanes kernel (its right-view strip export)")
    group = collectives.Group.of(device_mesh)
    if not group.local:
        return _result(device_mesh, [], (h, w), left.device)

    # the stacks are built where this process's first shard runs, as an
    # unsharded run there builds them; each shard takes its columns
    home = group.device(group.local[0])
    ls = preprocess.channel_stack(to_device(left, home))
    rs = preprocess.channel_stack(to_device(right, home))
    if pad:
        ls = preprocess.pad_edge(ls, 2, 0, pad)
        rs = preprocess.pad_edge(rs, 2, 0, pad)
    blocks = {k: [to_device(a[..., k * ws:(k + 1) * ws], group.device(k)) for a in (ls, rs)]
              for k in group.local}
    ext = _exchange(group, blocks, [(hr, hr), (hl_right, hr)], 2)

    keys = ["bestd", "bestc", "cm", "cp"] + (["ubest"] if cfg.uniqueness_ratio > 0 else [])
    planes, own, strips = {}, {}, {}
    for k in group.local:
        l_ext, r_ext = ext[k]
        n_valid = min(max(w - k * ws, 0), ws)  # real left cols in this shard
        if use_kernel:
            outs = asw_kernel.wta_outputs_from_stacks(
                l_ext, r_ext, cfg, n_valid_cols=n_valid, want_strip=True)
        else:
            if cfg.aggregation == "box":
                vol = aggregate.aggregate_box(
                    aggregate.cost_volume_from_stacks(l_ext, r_ext, cfg), cfg)
            else:
                vol = aggregate.aggregate_asw_from_stacks(l_ext, r_ext, cfg)
            # the right-view partial over x' in [x0 - (D-1), x0 + ws): the
            # candidate (x', d) lives here iff left pixel x' + d is owned
            # and real; gathered over the local volume
            outs = asw_kernel.window_planes(vol, n_valid, 0, D, True)
        planes[k] = [outs[key] for key in keys]
        own[k] = (outs["rbestc"], outs["rbestd"])
        strips[k] = [outs["r_strip_c"], outs["r_strip_d"]]

    # Merge with the next shard's left strip (its candidates have strictly
    # larger d for the same x', so strict < keeps first-min).
    nb = collectives.exchange(group, [(k + 1, k) for k in range(n - 1)] if D > 1 else [],
                              lambda src, dst: strips[src],
                              lambda src, dst: [(t.shape, t.dtype) for t in strips[dst]],
                              "strip")
    rbestd = {}
    for k in group.local:
        own_c, own_d = own[k]
        if (k + 1, k) in nb:
            dev = own_c.device
            nb_c, nb_d = nb[(k + 1, k)]
            cand_c = torch.cat([torch.full((h, ws - (D - 1)), float("inf"), device=dev), nb_c], 1)
            cand_d = torch.cat([torch.zeros((h, ws - (D - 1)), dtype=torch.int32, device=dev),
                                nb_d], 1)
            take = cand_c < own_c
            own_d = torch.where(take, cand_d, own_d)
        rbestd[k] = own_d

    # Gather the small winner planes (and, for the weighted median, the
    # left Lab planes); the x-global post-processing runs replicated.
    names = keys + ["rbestd"]
    weighted = cfg.median_filter and cfg.median_mode == "weighted"
    parts = {k: planes[k] + [rbestd[k]] + ([blocks[k][0][4:7]] if weighted else [])
             for k in group.local}

    def post(gathered):
        full = [torch.cat(f, dim=-1)[..., :w].contiguous() for f in zip(*gathered)]
        guide = torch.movedim(full[-1], 0, -1) if weighted else None
        return pipeline.disparity(dict(zip(names, full)), cfg, guide)

    disp = collectives.replicated(group, parts, post)
    shards = []
    for k in group.local:
        span = _span(k, ws, w)
        shards.append(Shard((slice(0, h), span), disp[k][:, span]))
    return _result(device_mesh, shards, (h, w), left.device)
