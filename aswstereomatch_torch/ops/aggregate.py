"""Cost aggregation in PyTorch (the plain, materializing versions).

Counterpart of ``aswstereomatch_tpu.ops.aggregate`` for the exact window
aggregators, under the pinned virtual padded-plane border semantics
(config.py):

  - ``aggregate_box``: fixed-window mean — x taps slide VALID over the
    x-extended cost, y taps over edge-replicated rows.
  - ``aggregate_asw``: Yoon-Kweon adaptive-support-weight aggregation with
    symmetric two-view (or left-only) weights.  The left weight planes are
    built once and reused across all d; the right planes live on the
    x-extended right domain and step d reads the window starting at
    (D-1) - d.  One raw cost plane exists at a time.
  - ``aggregate_asw_separable_from_stacks``: the two-pass separable speed
    mode (``asw_separable``): a vertical bilateral pass over the x-extended
    cost, then a horizontal one, with the right-view factor in both passes
    in symmetric mode.
  - ``aggregate_sgm``: semi-global scanline aggregation of the raw cost
    volume (``ops/cuda/sgm_kernel``: its CUDA kernel on the card, its plain
    version on the CPU).

The window aggregators materialize weight planes ((H, W, K^2) for the exact
window, about 2 GB each at KITTI geometry, r=16; (H, W, K) for the
separable passes) and the (H, W, D) output volume: they are the readable
references the CUDA kernels (ops/cuda/asw_kernel, asw_sep_kernel,
asw_dlanes_kernel, asw_sym_dlanes_kernel) are tested against, not the main
path on the card.
"""

from __future__ import annotations

import torch

from ..config import StereoConfig
from ..utils.convert import axial_weights_np, spatial_weights_np
from ..utils.profiling import span
from . import cost as cost_ops
from . import preprocess
from .cuda import cost_kernel, sgm_kernel, stacks_kernel


def _patches_2d(arr: torch.Tensor, radius: int, x_valid: bool = False) -> torch.Tensor:
    """All (2r+1)^2 window taps of a 2D array -> (H, W_out, O).

    y: edge-replicate padding.  x: edge-replicate padding, or — when
    ``x_valid`` — the array is already x-extended by ``radius`` per side and
    taps slide VALID.  Offsets are in row-major (wy, wx) order, matching the
    NumPy oracle's window loops.
    """
    k = 2 * radius + 1
    h = arr.shape[0]
    pad = preprocess.pad_edge(arr, 0, radius, radius)
    if not x_valid:
        pad = preprocess.pad_edge(pad, 1, radius, radius)
    w_out = pad.shape[1] - 2 * radius
    # (H, W_out, k_wy, k_wx) view -> contiguous (H, W_out, O)
    return pad.unfold(0, k, 1).unfold(1, k, 1).reshape(h, w_out, k * k)


def _window_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of the last axis of (..., k * k) window taps, in an order that
    does not depend on where a pixel's taps lie in memory.

    PyTorch's CUDA reduction reads a row of 128 or more values with 16-byte
    loads, starting with the few values before the row's first aligned
    address, so its order follows the row's address: a band of rows
    (``y_chunks``) would sum some pixels in another order than the whole
    image.  Rows shorter than 128 are summed in one fixed order, so a
    window of 128 taps or more is summed as k rows of dx taps (k < 128, r
    <= 63), then over dy."""
    if k * k < 128:
        return x.sum(dim=-1)
    return x.unflatten(-1, (k, k)).sum(dim=-1).sum(dim=-1)


def _tap_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the last axis (a 1-D window's K taps) as a fixed pairwise
    tree of elementwise adds: each level adds the upper half of the taps
    onto the lower half and, for an odd count, the last tap onto the first.
    An elementwise add gives each pixel the same bits whatever the layout,
    the pixel's place or the thread that computes it.  A plain ``sum(-1)``
    does not: the separable passes' (H, W, K) products lie K-major in
    memory, and PyTorch's CPU sum reduces the pixels at the end of each
    chunk it vectorises in another order than the rest, so a band of
    columns (x-tiling) or another thread count would change the last bits.
    ceil(log2 K) levels, each reading the taps left once."""
    k = x.shape[-1]
    while k > 1:
        half = k // 2
        acc = x[..., :half] + x[..., half:2 * half]
        if k % 2:
            acc[..., :1] += x[..., 2 * half:]
        x, k = acc, half
    return x[..., 0]


def bilateral_planes_from_lab(lab_ext: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Per-center ASW weight planes w(p, p+o) from a pre-extended Lab image.

    lab_ext: (H, We + 2r, 3) covering [centers - r, centers + r].  Returns
    (H, We, O).
    """
    r = cfg.window_radius
    we = lab_ext.shape[-2]
    d2 = None
    for c in range(3):
        p = _patches_2d(lab_ext[..., c], r, x_valid=True)
        diff = p - lab_ext[:, r : we - r, c : c + 1]
        d2 = diff * diff if d2 is None else d2 + diff * diff
        del p, diff
    sw = torch.from_numpy(spatial_weights_np(cfg).reshape(-1)).to(lab_ext.device)
    d2.sqrt_().neg_().div_(cfg.gamma_color).exp_().mul_(sw)
    return d2.to(torch.float32)


def _patches_1d_y(arr: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W) -> (H, W, K) vertical window taps, edge-replicated in y."""
    return preprocess.pad_edge(arr, 0, radius, radius).unfold(0, 2 * radius + 1, 1)


def _patches_1d_x(arr: torch.Tensor, radius: int) -> torch.Tensor:
    """x-extended (H, W + 2r) -> (H, W, K) horizontal taps, VALID slide."""
    return arr.unfold(1, 2 * radius + 1, 1)


def _bilateral_1d(lab: torch.Tensor, cfg: StereoConfig, axis: str) -> torch.Tensor:
    """1D bilateral weight planes w(p, p + o*e_axis) -> (H, W_out, K).

    axis "y": taps run down the column (edge-replicated rows), W_out = W.
    axis "x": lab is pre-extended by r per side and taps slide VALID,
    W_out = W - 2r.  Spatial factor exp(-|o| / gamma_p), the separable (L1)
    form, multiplied after the color factor.
    """
    r = cfg.window_radius
    if axis == "y":
        patches, center = _patches_1d_y, lab
    else:
        patches, center = _patches_1d_x, lab[:, r : lab.shape[1] - r]
    d2 = None
    for c in range(3):
        diff = patches(lab[..., c], r) - center[..., c : c + 1]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    aw = torch.from_numpy(axial_weights_np(cfg)).to(lab.device)
    return (torch.exp(-torch.sqrt(d2) / cfg.gamma_color) * aw).to(torch.float32)


def aggregate_asw_separable_from_stacks(
    l_stack_ext: torch.Tensor,
    r_stack_ext: torch.Tensor,
    cfg: StereoConfig,
    d_indices=None,
    storage_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Two-pass separable ASW from pre-extended channel stacks.

    The documented speed-mode approximation of Yoon-Kweon (``asw_separable``):

        numv[y, u, d] = sum_dy wvL(y, u; dy) wvR(y, u-d; dy) C[y+dy-r, u, d]
        num [y, x, d] = sum_dx whL(y, x; dx) whR(y, x-d; dx) numv[y, x+dx-r, d]

    (denominators the same sums without C; right factors only in symmetric
    mode), so the window weight is wh(p, p + dx e_x) * wv(p + dx e_x, dy e_y)
    with spatial factor exp(-(|dy| + |dx|) / gamma_p).  Borders as
    ``aggregate_asw_from_stacks``: y taps read edge-clamped rows, the
    horizontal weights re-extend the Lab plane by r with edge replicas, and
    the right factor at step d reads the window starting at (D-1) - d of the
    right stack's extended domain.  Returns (H, W, len(d_indices)).

    ``storage_dtype`` rounds each raw cost plane to that dtype and back
    before aggregation (the separable kernel's ``volume_dtype="bfloat16"``
    storage mode); accumulation stays float32.
    """
    r = cfg.window_radius
    D = cfg.max_disparity
    we = l_stack_ext.shape[2]  # W + 2r

    planes = cost_ops.planes_from_stacks(l_stack_ext, r_stack_ext, r)
    lab_l = torch.movedim(l_stack_ext[4:7], 0, -1)  # (H, W + 2r, 3)
    # Vertical weights for every column the horizontal pass can tap.
    wvl = _bilateral_1d(lab_l, cfg, "y")  # (H, W + 2r, K)
    # Horizontal weights need taps r beyond the centers: re-extend by edge
    # replication (identical to the virtual plane's columns there).
    whl = _bilateral_1d(preprocess.pad_edge(lab_l, 1, r, r), cfg, "x")[:, r : we - r]
    if cfg.asw_symmetric:
        lab_r = torch.movedim(r_stack_ext[4:7], 0, -1)  # (H, W + 2r + D - 1, 3)
        wvr = _bilateral_1d(lab_r, cfg, "y")
        whr = _bilateral_1d(preprocess.pad_edge(lab_r, 1, r, r), cfg, "x")

    out = []
    for d in range(D) if d_indices is None else d_indices:
        d = int(d)
        plane = cost_ops.cost_plane(planes, d, cfg)  # (H, W + 2r)
        if storage_dtype is not None:
            plane = plane.to(storage_dtype).to(torch.float32)
        start = (D - 1) - d
        wv, wh = wvl, whl
        if cfg.asw_symmetric:
            wv = wv * wvr[:, start : start + we]
            wh = wh * whr[:, start + r : start + we - r]
        numv = _tap_sum(wv * _patches_1d_y(plane, r))  # (H, W + 2r)
        denv = _tap_sum(wv)
        num = _tap_sum(wh * _patches_1d_x(numv, r))  # (H, W)
        den = _tap_sum(wh * _patches_1d_x(denv, r))
        out.append((num / den).to(torch.float32))
    return torch.stack(out, dim=-1)


def aggregate_box(vol_ext: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Mean over the (2r+1)^2 window.  vol_ext: x-extended (H, W+2r, D)."""
    r = cfg.window_radius
    if r == 0:
        return vol_ext
    k = 2 * r + 1
    h, we = vol_ext.shape[:2]
    w = we - 2 * r
    pad = preprocess.pad_edge(vol_ext, 0, r, r)
    col = pad[0:h].clone()
    for wy in range(1, k):
        col += pad[wy : wy + h]
    summed = col[:, 0:w].clone()
    for wx in range(1, k):
        summed += col[:, wx : wx + w]
    return (summed / float(k * k)).to(torch.float32)


def cost_volume_from_stacks(
    l_stack_ext: torch.Tensor, r_stack_ext: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """x-extended raw cost volume (H, W + 2r, D) from pre-extended stacks:
    the cost kernel's plain version, on any device."""
    planes = cost_ops.planes_from_stacks(l_stack_ext, r_stack_ext, cfg.window_radius)
    return cost_kernel.reference(planes, cfg)


def aggregate_asw_from_stacks(
    l_stack_ext: torch.Tensor,
    r_stack_ext: torch.Tensor,
    cfg: StereoConfig,
    d_indices=None,
) -> torch.Tensor:
    """Exact ASW-aggregated cost volume from pre-extended channel stacks.

    l_stack_ext: (7, H, W + 2r); r_stack_ext: (7, H, W + 2r + D - 1) —
    preprocess.channel_stack layout, columns edge-extended per the pinned
    padded-plane semantics.  Returns (H, W, D), or (H, W, len(d_indices))
    for the given d's (a d-shard's slab, each plane bit for bit the whole
    volume's).  Each step builds its tap and weight planes and frees them
    before the next, so peak memory stays at a few (H, W, K^2) planes
    whatever D is.  A separable config goes to
    ``aggregate_asw_separable_from_stacks``.
    """
    if cfg.asw_separable:
        return aggregate_asw_separable_from_stacks(l_stack_ext, r_stack_ext, cfg, d_indices)
    r = cfg.window_radius
    D = cfg.max_disparity
    k = cfg.window_size
    w = l_stack_ext.shape[2] - 2 * r

    planes = cost_ops.planes_from_stacks(l_stack_ext, r_stack_ext, r)
    wl = bilateral_planes_from_lab(torch.movedim(l_stack_ext[4:7], 0, -1), cfg)
    if cfg.asw_symmetric:
        # Right-weight planes on centers x' in [-(D-1), W-1]; step d reads
        # the window starting at (D-1) - d.
        wr = bilateral_planes_from_lab(torch.movedim(r_stack_ext[4:7], 0, -1), cfg)
    else:
        den_left = _window_sum(wl, k)

    out = []
    for d in range(D) if d_indices is None else d_indices:
        d = int(d)
        plane = cost_ops.cost_plane(planes, d, cfg)  # (H, W + 2r)
        taps = _patches_2d(plane, r, x_valid=True)  # (H, W, O), fresh
        if cfg.asw_symmetric:
            start = (D - 1) - d
            wgt = wl * wr[:, start : start + w]
            num = _window_sum(taps.mul_(wgt), k)
            den = _window_sum(wgt, k)
            del wgt
        else:
            num = _window_sum(taps.mul_(wl), k)
            den = den_left
        del taps
        out.append((num / den).to(torch.float32))
    return torch.stack(out, dim=-1)


def aggregate_asw(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoConfig,
    d_indices=None,
) -> torch.Tensor:
    """ASW-aggregated cost volume for a full pair (at ``d_indices`` only,
    when given): the edge-extended channel stacks (the stack kernel's plain
    version, on any device), then ``aggregate_asw_from_stacks``."""
    ls_ext, rs_ext = stacks_kernel.reference(left, right, cfg.window_radius, cfg.max_disparity)
    return aggregate_asw_from_stacks(ls_ext, rs_ext, cfg, d_indices)


def aggregate_sgm(vol: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Semi-global aggregation of a raw (H, W, D) cost volume, 4 or 8
    paths summed in the pinned order (``sgm_kernel``: the kernel for a CUDA
    tensor, the plain version for a CPU one)."""
    return sgm_kernel.aggregate(vol, cfg)


def aggregated_volume(
    left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig
) -> torch.Tensor:
    """(H, W, D) aggregated cost volume per the configured cost/aggregation."""
    if cfg.aggregation == "asw":
        return aggregate_asw(left, right, cfg)
    if cfg.aggregation == "box":
        vol_ext = cost_ops.cost_volume(left, right, cfg, x_extend=cfg.window_radius)
        return aggregate_box(vol_ext, cfg)
    if cfg.aggregation == "sgm":
        with span("pipeline.cost"):
            vol = cost_ops.cost_volume(left, right, cfg)
        with span("pipeline.sgm"):
            return aggregate_sgm(vol, cfg)
    return cost_ops.cost_volume(left, right, cfg)
