"""Disparity-axis sharding — the tensor-parallel analog.

Counterpart of ``aswstereomatch_tpu.parallel.dshard``.  Shards the
candidate-disparity axis over the mesh "tile" axis: each shard aggregates
only its D/n-candidate slab (cost + ASW for those d's), runs a local WTA
with the subpixel triple, and the global winner is a lexicographic (cost,
then lower-d) min-combine across shards.  The right-view partial argmin is
combined the same way.

First-occurrence argmin is preserved exactly: shard k owns disparities
[k*Ds, (k+1)*Ds), so an ordered strict-< merge over ascending shards
reproduces the untiled tie-break (never a min over a stacked shard axis,
whose index on ties is not pinned); aggregated values are the unsharded
ones bit for bit since each d is computed wholly on one shard.

Slabs carry one overlap disparity per side so the winner's parabola triple
(C[d*-1], C[d*+1]) is available locally even at slab boundaries.  On the
kernel route each shard runs K1 at D = Ds + 2 over the right stack shifted
by s0 = k*Ds - 1 columns with the window [1, Ds + 1) and the right-view
strip; on the eager route it aggregates the slab through
``aggregate.aggregate_asw(..., d_indices=...)``.
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
from .tiling import _kernel_route, _result, _shard_device


def _kernel_shard_wta(ls_ext_g, rs_pad_g, k, cfg, ds, D, h, w):
    """Windowed K1 WTA for d-shard ``k`` (global d in [k*ds, (k+1)*ds)), on
    pre-padded channel stacks: (bestc, bestd, cm, cp, rbestc, rbestd)."""
    r = cfg.window_radius
    dk = ds + 2  # slab + one overlap d per side for the subpixel triple
    s0 = k * ds - 1  # kernel-local d' <-> global d = s0 + d'
    # R'(v) = R(v - s0); slice the wide-padded stack so the kernel's
    # [-(r + dk - 1), W - 1 + r] window lands on real columns.
    start = D - (k + 1) * ds  # = (r + D) - (r + dk - 1) - s0
    rs_ext = rs_pad_g[:, :, start:start + w + 2 * r + dk - 1]
    kouts = asw_kernel.wta_outputs_from_stacks(
        ls_ext_g, rs_ext, cfg.replace(max_disparity=dk), n_valid_cols=w,
        want_strip=True, d_window=(1, ds + 1),
    )
    bestd = s0 + kouts["bestd"]
    # Right view: kernel column u is real right col x' = u - s0.  Kernel
    # u < 0 lives in the strip (shard 0's x' = 0 sits at u = -1); u beyond
    # W - 1 would be x' whose slab candidates all have x' + d >= W (no left
    # pixel): absent, padded inf.
    full_c = torch.cat([kouts["r_strip_c"], kouts["rbestc"]], dim=1)  # u in [-(dk-1), W)
    full_d = torch.cat([kouts["r_strip_d"], kouts["rbestd"]], dim=1)
    pc = torch.nn.functional.pad(full_c, (0, D), value=float("inf"))
    pd = torch.nn.functional.pad(full_d, (0, D))
    st = s0 + dk - 1  # index of real x' = 0 (= k*ds + ds >= 0)
    rbestc = pc[:, st:st + w]
    rbestd = s0 + pd[:, st:st + w]
    return kouts["bestc"], bestd, kouts["cm"], kouts["cp"], rbestc, rbestd


def _stacks_g(left, right, cfg):
    """The left stack edge-padded by r and the right one by (r + D, r + 1):
    wide enough for every slab's shifted window."""
    r = cfg.window_radius
    D = cfg.max_disparity
    ls_ext_g = preprocess.pad_edge(preprocess.channel_stack(left), 2, r, r)
    rs_pad_g = preprocess.pad_edge(preprocess.channel_stack(right), 2, r + D, r + 1)
    return ls_ext_g, rs_pad_g


def shard_wta_outputs(left, right, cfg, k: int, n: int):
    """Run shard ``k`` of ``n``'s windowed-kernel WTA on the images' device,
    no mesh required.  Returns the per-shard (bestc, bestd, cm, cp, rbestc,
    rbestd) tuple the combine step merges."""
    D = cfg.max_disparity
    if D % n:
        raise ValueError(f"max_disparity {D} not divisible by {n} d-shards")
    h, w = left.shape[:2]
    return _kernel_shard_wta(*_stacks_g(left, right, cfg), k, cfg, D // n, D, h, w)


def _eager_shard_wta(l_img, r_img, k, cfg, ds, D, w):
    """The slab of shard ``k`` with one overlap d per side (clamped),
    aggregated eagerly: the same six planes."""
    d0 = k * ds
    take = lambda a, i: torch.gather(a, -1, i.to(torch.int64)[..., None])[..., 0]  # noqa: E731
    d_idx = (d0 + torch.arange(ds + 2) - 1).clamp(0, D - 1).tolist()
    slab = aggregate.aggregate_asw(l_img, r_img, cfg, d_indices=d_idx)
    interior = slab[..., 1:1 + ds]  # (H, W, ds)
    loc = torch.argmin(interior, dim=-1).to(torch.int32)
    bestc = take(interior, loc)
    cm = take(slab, loc)  # slab index loc = interior loc - 1
    cp = take(slab, loc + 2)
    # Local right-view partial: C_R(x', d) = C_L(x'+d, d), d in the slab.
    dev = interior.device
    idx = torch.arange(w, device=dev)[None, :, None] + (d0 + torch.arange(ds, device=dev))
    gathered = torch.gather(interior, 1, idx.clamp(max=w - 1).expand(interior.shape))
    rslab = torch.where(idx <= w - 1, gathered, torch.tensor(float("inf"), device=dev))
    rloc = torch.argmin(rslab, dim=-1).to(torch.int32)
    return bestc, d0 + loc, cm, cp, take(rslab, rloc), d0 + rloc


def _merge(parts: list) -> tuple:
    """Ordered strict-< merge of the shards' planes over ascending shards:
    the left view's (bestc, bestd, cm, cp) and the right view's (rbestc,
    rbestd) each keep the first shard with the least cost."""
    bc, bd, bcm, bcp, rc, rd = parts[0]
    for c_i, d_i, cm_i, cp_i, rc_i, rd_i in parts[1:]:
        win = c_i < bc
        bc, bd = torch.where(win, c_i, bc), torch.where(win, d_i, bd)
        bcm, bcp = torch.where(win, cm_i, bcm), torch.where(win, cp_i, bcp)
        rwin = rc_i < rc
        rc, rd = torch.where(rwin, rc_i, rc), torch.where(rwin, rd_i, rd)
    return bc, bd, bcm, bcp, rc, rd


def match_pair_dsharded(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    device_mesh: mesh_lib.Mesh,
):
    """Single pair with the disparity axis sharded over "tile".

    Each process builds its stacks from the pair it holds (the reference
    replicates the images, ~100x smaller than the volume); only per-shard
    winner planes move in the combine step, gathered in shard order onto
    each owner, where the ordered merge and the post-processing run.
    Returns (H, W) on the inputs' device, or on a mesh that spans processes
    this process's ``Shard``s, each the whole (replicated) map.

    Kernel route: d-sharding needs K1's [lo, hi) disparity window, so
    left-only ASW and box run K1 here even where the unsharded
    ``kernel_layout="auto"`` resolves them to the d-lanes kernel: bit-exact
    vs the unsharded run at ``kernel_layout="xlanes"``.  An explicit
    ``kernel_layout="dlanes"`` and a separable config are refused there.
    """
    n = device_mesh.shape[mesh_lib.TILE_AXIS]
    D = cfg.max_disparity
    if D % n:
        raise ValueError(f"max_disparity {D} not divisible by {n} d-shards")
    if cfg.uniqueness_ratio > 0:
        # Each shard sees only its d-slab, so the second-best-excluding-
        # best+-1 operand would be per-slab, not global.  The y/x-tiled
        # layouts keep full d rows per pixel and support the gate.
        raise ValueError(
            "uniqueness_ratio is not supported with disparity sharding "
            "(per-shard slabs cannot form the global second-best cost); "
            "use tile_axis 'y'/'x' or an unsharded run"
        )
    ds = D // n
    h, w = left.shape[:2]
    dev0 = _shard_device(device_mesh.tile_devices())
    use_kernel = pipeline._resolve_backend(cfg, dev0) == "cuda"
    if cfg.aggregation != "asw" and not (cfg.aggregation == "box" and use_kernel):
        raise ValueError("disparity sharding covers asw (both backends) and box (cuda)")
    use_kernel = use_kernel and _kernel_route(
        cfg, dev0,
        "disparity-sharded runs use the x-lanes kernel (its [lo, hi) disparity window)")
    group = collectives.Group.of(device_mesh)

    stacks = {}  # the padded stacks, built once per device of this process
    parts = {}
    for k in group.local:
        dev = group.device(k)
        if use_kernel:
            if dev not in stacks:
                stacks[dev] = _stacks_g(to_device(left, dev), to_device(right, dev), cfg)
            parts[k] = list(_kernel_shard_wta(*stacks[dev], k, cfg, ds, D, h, w))
        else:
            parts[k] = list(_eager_shard_wta(to_device(left, dev), to_device(right, dev),
                                             k, cfg, ds, D, w))

    # Global combine: every shard's planes gathered onto each owner, the
    # ordered merge and the post-processing run replicated there.
    def combine(gathered):
        bc, bd, bcm, bcp, _, rd = _merge(gathered)
        planes = {"bestc": bc, "bestd": bd, "cm": bcm, "cp": bcp, "rbestd": rd}
        guide = pipeline.guide_lab(to_device(left, bd.device), cfg) if cfg.median_filter else None
        return pipeline.disparity(planes, cfg, guide)

    disp = collectives.replicated(group, parts, combine)
    shards = [Shard((slice(0, h), slice(0, w)), disp[k]) for k in group.local]
    return _result(device_mesh, shards, (h, w), left.device)
