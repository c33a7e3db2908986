"""Spatial tiling with halo exchange: y- and x-sharded layouts of one pair,
and data x tile batches.

Counterpart of ``aswstereomatch_tpu.parallel.tiling``, with the same
names, checks and messages.  The reference runs each layout under
``shard_map``; here one controller cuts the input into per-shard blocks on
the tile devices (parallel/mesh.py), runs the per-shard work there, and
moves blocks between devices where the reference has a collective: a
``ppermute`` is the neighbour's block moved to this shard's device, an
``all_gather`` a ``torch.cat`` on each device.  Launches on distinct cards
are asynchronous, so their shards overlap; shards on one device run in turn.

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

Invariant (tested): every layout equals the unsharded run bit for bit.
"""

from __future__ import annotations

import torch

from ..config import StereoConfig
from ..models import pipeline
from ..ops import aggregate, postprocess, preprocess
from ..ops.cuda import asw_kernel
from . import mesh as mesh_lib


def _halo_rows(cfg: StereoConfig) -> int:
    """Image rows of halo each side (see StereoConfig.halo_y)."""
    return cfg.halo_y


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """A block moved to ``device`` (a no-op on its own device).  A copy to a
    card is asynchronous; a copy to the CPU is not, since a non-blocking
    one would hand back a buffer that the card has yet to fill."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


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


def _exchange(blocks: list, lo: int, hi: int, dim: int) -> list:
    """Each block extended by ``lo`` entries along ``dim`` from the previous
    shard's end and ``hi`` from the next shard's start, moved to its own
    device; boundary shards take edge replicas of their own first / last
    entry (the untiled edge-replicated plane)."""
    n = len(blocks)
    out = []
    for i, b in enumerate(blocks):
        size = b.shape[dim]
        if i > 0:
            prev = _to(blocks[i - 1].narrow(dim, blocks[i - 1].shape[dim] - lo, lo), b.device)
        else:
            prev = _edge(b.narrow(dim, 0, 1), dim, lo)
        if i < n - 1:
            nxt = _to(blocks[i + 1].narrow(dim, 0, hi), b.device)
        else:
            nxt = _edge(b.narrow(dim, size - 1, 1), dim, hi)
        out.append(torch.cat([prev, b, nxt], dim=dim))
    return out


def _exchange_halos(blocks: list, halo: int) -> list:
    """Row halos: per-shard (rows, ...) blocks -> (halo + rows + halo, ...),
    each on its shard's device.  Boundary shards take edge-replicated rows."""
    return _exchange(blocks, halo, halo, 0)


def _rows_tiled(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                devices: list, true_h: int) -> torch.Tensor:
    """One pair, its rows (a multiple of len(devices)) sharded over
    ``devices``: the owned rows of every shard, concatenated on the
    caller's device."""
    n = len(devices)
    rows = left.shape[0] // n
    halo = _halo_rows(cfg)
    lb = [_to(left[k * rows:(k + 1) * rows], dev) for k, dev in enumerate(devices)]
    rb = [_to(right[k * rows:(k + 1) * rows], dev) for k, dev in enumerate(devices)]
    l_ext, r_ext = _exchange_halos(lb, halo), _exchange_halos(rb, halo)
    outs = [pipeline.tile_disparity(l_ext[k], r_ext[k], cfg, halo, rows, true_h, k * rows)
            for k in range(n)]
    return torch.cat([_to(o, left.device) for o in outs])


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
) -> torch.Tensor:
    """Single pair, y-sharded over the mesh "tile" axis (the first data
    row's devices).

    Pads H to a multiple of the tile count (bottom, edge rows) and trims;
    real rows are bit-identical to the untiled pipeline.  Returns (H, W) on
    the inputs' device.
    """
    _reject_global_aggregation(cfg)
    n = device_mesh.shape[mesh_lib.TILE_AXIS]
    h = left.shape[0]
    left, right = _pad_rows(n, cfg, left, right)
    return _rows_tiled(left, right, cfg, device_mesh.tile_devices(), h)[:h]


def match_batch_sharded(
    lefts: torch.Tensor,
    rights: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
) -> torch.Tensor:
    """Batched throughput mode: batch over "data" x rows over "tile".

    (B, H, W[, 3]) inputs; data row i matches the i-th contiguous slice of
    the batch, one pair after another (as ``pipeline.match_batch`` does),
    each y-tiled over its row's devices.  Returns (B, H, W) on the inputs'
    device.
    """
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
    if cfg.aggregation == "sgm":
        # Data-only layout (nt == 1, enforced above): each shard runs the
        # UNSHARDED pipeline on its local pairs — no y halos, because even
        # edge-replicated halo rows would perturb the global scanline
        # recurrence.
        outs = [pipeline.match_batch(_to(lefts[i * per:(i + 1) * per], dev[0]),
                                     _to(rights[i * per:(i + 1) * per], dev[0]), cfg)
                for i, dev in enumerate(device_mesh.devices)]
        return torch.cat([_to(o, lefts.device) for o in outs])
    lefts, rights = _pad_rows(nt, cfg, lefts, rights, dim=1)
    outs = []
    for i in range(nd):
        devices = device_mesh.tile_devices(i)
        for j in range(i * per, (i + 1) * per):
            outs.append(_rows_tiled(lefts[j], rights[j], cfg, devices, h)[:h])
    if not outs:
        return torch.empty((0, h, lefts.shape[2]), dtype=torch.float32, device=lefts.device)
    return torch.stack(outs)


def shard_batch_arrays(arrays, device_mesh: mesh_lib.Mesh):
    """Each (B, H, ...) tensor of ``arrays`` cut data x tile: a list over the
    data axis of lists over the tile axis of blocks, block (i, k) holding
    the i-th batch slice's k-th row slice on device (i, k) (the reference's
    ``P("data", "tile")`` placement).  B must divide by the data axis; rows
    are cut as evenly as they go."""
    nd = device_mesh.shape[mesh_lib.DATA_AXIS]
    nt = device_mesh.shape[mesh_lib.TILE_AXIS]

    def put(a):
        if a.shape[0] % nd:
            raise ValueError(f"batch {a.shape[0]} not divisible by data axis {nd}")
        return [[_to(blk, device_mesh.devices[i, k])
                 for k, blk in enumerate(torch.tensor_split(part, nt, dim=1))]
                for i, part in enumerate(torch.tensor_split(a, nd, dim=0))]

    return type(arrays)(put(a) for a in arrays)


# ---------------------------------------------------------------------------
# x-axis tiling — the ring / D_max-halo layout
# ---------------------------------------------------------------------------

def _exchange_halos_x(blocks: list, hl: int, hr: int) -> list:
    """Column halo exchange on the last axis: (..., ws) -> (..., hl+ws+hr).

    The left halo carries ``hl`` columns from the previous shard (for the
    right-image stack this is the aggregation radius + D_max strip);
    boundary shards substitute edge replicas, which equals the virtual
    padded plane.
    """
    return _exchange(blocks, hl, hr, blocks[0].ndim - 1)


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


def _replicated(parts_by_shard: list, devices: list, fn) -> dict:
    """``fn`` of every shard's parts, gathered onto each distinct device of
    ``devices`` in shard order (the reference's all_gather + replicated
    compute; a device that holds several shards computes once)."""
    out = {}
    for dev in devices:
        if dev not in out:
            out[dev] = fn([[_to(p, dev) for p in parts] for parts in parts_by_shard])
    return out


def match_pair_tiled_x(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
) -> torch.Tensor:
    """Single pair, x-sharded over the mesh "tile" axis (ASW and box).

    Per shard: cost + aggregation + WTA over its columns from real
    neighbour columns; right-view partials merged with the next shard's
    (D-1)-column strip (strict <, preserving first-min); the small per-view
    winner planes are then gathered so the x-global post-processing stages
    (LR gather along x, row fill, median) run replicated — bit-identical to
    the untiled pipeline.

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
    devices = device_mesh.tile_devices()
    dev0 = _shard_device(devices)
    use_kernel = _kernel_route(
        cfg, dev0, "x-tiled runs use the x-lanes kernel (its right-view strip export)")

    # the stacks are built where the shards run, as an unsharded run there
    # builds them
    ls = preprocess.channel_stack(_to(left, dev0))
    rs = preprocess.channel_stack(_to(right, dev0))
    if pad:
        ls = preprocess.pad_edge(ls, 2, 0, pad)
        rs = preprocess.pad_edge(rs, 2, 0, pad)
    l_blk = [_to(ls[..., k * ws:(k + 1) * ws], dev) for k, dev in enumerate(devices)]
    r_blk = [_to(rs[..., k * ws:(k + 1) * ws], dev) for k, dev in enumerate(devices)]
    l_ext = _exchange_halos_x(l_blk, hr, hr)
    r_ext = _exchange_halos_x(r_blk, hl_right, hr)

    keys = ["bestd", "bestc", "cm", "cp"] + (["ubest"] if cfg.uniqueness_ratio > 0 else [])
    planes, own, strips = [], [], []
    for k in range(n):
        n_valid = min(max(w - k * ws, 0), ws)  # real left cols in this shard
        if use_kernel:
            outs = asw_kernel.wta_outputs_from_stacks(
                l_ext[k], r_ext[k], cfg, n_valid_cols=n_valid, want_strip=True)
        else:
            if cfg.aggregation == "box":
                vol = aggregate.aggregate_box(
                    aggregate.cost_volume_from_stacks(l_ext[k], r_ext[k], cfg), cfg)
            else:
                vol = aggregate.aggregate_asw_from_stacks(l_ext[k], r_ext[k], cfg)
            # the right-view partial over x' in [x0 - (D-1), x0 + ws): the
            # candidate (x', d) lives here iff left pixel x' + d is owned
            # and real; gathered over the local volume
            outs = asw_kernel.window_planes(vol, n_valid, 0, D, True)
        planes.append([outs[key] for key in keys])
        own.append((outs["rbestc"], outs["rbestd"]))
        strips.append((outs["r_strip_c"], outs["r_strip_d"]))

    # Merge with the next shard's left strip (its candidates have strictly
    # larger d for the same x', so strict < keeps first-min).
    rbestd = []
    for k in range(n):
        own_c, own_d = own[k]
        if k < n - 1 and D > 1:
            dev = own_c.device
            nb_c, nb_d = (_to(t, dev) for t in strips[k + 1])
            cand_c = torch.cat([torch.full((h, ws - (D - 1)), float("inf"), device=dev), nb_c], 1)
            cand_d = torch.cat([torch.zeros((h, ws - (D - 1)), dtype=torch.int32, device=dev),
                                nb_d], 1)
            take = cand_c < own_c
            own_d = torch.where(take, cand_d, own_d)
        rbestd.append(own_d)

    # Gather the small winner planes (and, for the weighted median, the
    # left Lab planes); the x-global post-processing runs replicated.
    names = keys + ["rbestd"]
    weighted = cfg.median_filter and cfg.median_mode == "weighted"
    parts = [planes[k] + [rbestd[k]] + ([l_blk[k][4:7]] if weighted else []) for k in range(n)]

    def post(gathered):
        full = [torch.cat(f, dim=-1)[..., :w] for f in zip(*gathered)]
        disp = pipeline._disp_pre_from_wta(dict(zip(names, full)), cfg)
        if cfg.median_filter:
            guide = torch.movedim(full[-1], 0, -1) if weighted else None
            disp = postprocess.median_filter(disp, cfg, guide)
        return disp

    disp = _replicated(parts, devices, post)
    slices = [_to(disp[dev][:, k * ws:(k + 1) * ws], left.device) for k, dev in enumerate(devices)]
    return torch.cat(slices, dim=1)
