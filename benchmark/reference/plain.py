"""The plain reference of a stereo pair's disparity map: float32 PyTorch on
any device, with TF32 off, computed in blocks of rows so that it fits.

A frozen copy of the program's plain stage mathematics, so that a change to
the program cannot move the yardstick:

  - ``gray`` / ``lab`` / ``channel_stack``: ``aswstereomatch_torch/utils/
    colorspace.py`` and ``ops/preprocess.py`` (Rec.601 gray, the central-
    difference x-gradient, CIELab from the float64-built sRGB LUT and the
    Newton cube root);
  - ``cost_plane``: ``ops/cost.py`` (AD or TAD+gradient on the edge-padded
    planes);
  - ``disp_pre`` / ``median3``: ``ops/wta.py``,
    ``ops/postprocess.py`` and ``models/pipeline.py::disp_pre_from_volume``
    (first-occurrence argmin, the parabola, the right view by volume reuse,
    the LR check, the uniqueness gate, the nearest-valid fill, the 3x3
    median);
  - ``spatial_weights`` / ``axial_weights``: ``utils/convert.py``.

It imports neither ``jax`` nor either engine package.  The aggregations
are in ``asw_exact.py``, ``asw_separable.py`` and ``sgm.py``; a
configuration's file names its module under ``"reference"``.  A module
aggregates a block of rows with its halo; one that sets ``WHOLE_IMAGE =
True`` (SGM, whose vertical paths run across every row) is handed the
whole image as one block.

``precision="tf32"`` is the benchmark's control: the operands of every
weighted window sum, or of every step of an SGM path, rounded to TF32 (10
mantissa bits, as the tensor cores take them) with float32 accumulation.
It must come out as not correct.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import torch

PRECISIONS = ("float32", "tf32")

# ---------------------------------------------------------------- colorspace
_SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_WHITE_D65 = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)
_INV_WHITE_X = float(np.float32(1.0 / _WHITE_D65[0]))
_INV_WHITE_Z = float(np.float32(1.0 / _WHITE_D65[2]))
_THIRD = float(np.float32(1.0 / 3.0))
_DELTA = 6.0 / 29.0
_CUBE = float(np.float32(_DELTA**3))
_LIN_DIV = float(np.float32(3.0 * _DELTA**2))
_LIN_ADD = float(np.float32(4.0 / 29.0))
_CBRT_MAGIC = 0x2A514067


def _make_srgb_lut() -> np.ndarray:
    c = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


SRGB_DECODE_LUT = _make_srgb_lut()


def gray(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of (..., 3) [0, 255] RGB."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b).to(torch.float32)


def _cbrt_newton(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32)
    y = (t.view(torch.int32) // 3 + _CBRT_MAGIC).view(torch.float32)
    for _ in range(4):
        y = (2.0 * y + t / (y * y)) * _THIRD
    return torch.where(t > 0, y, torch.zeros_like(y))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    lin = t / torch.tensor(_LIN_DIV, dtype=torch.float32, device=t.device)
    lin = lin + _LIN_ADD
    return torch.where(t > _CUBE, _cbrt_newton(t), lin)


def lab(rgb: torch.Tensor) -> torch.Tensor:
    """CIELab (L in [0, 100]) of (..., 3) [0, 255] RGB on the 8-bit grid."""
    idx = torch.clamp(torch.round(rgb), 0, 255).to(torch.int64)
    lin = torch.from_numpy(SRGB_DECODE_LUT).to(rgb.device)[idx]
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _SRGB_TO_XYZ.tolist()
    x = (r * m[0][0] + g * m[0][1] + b * m[0][2]) * _INV_WHITE_X
    y = r * m[1][0] + g * m[1][1] + b * m[1][2]
    z = (r * m[2][0] + g * m[2][1] + b * m[2][2]) * _INV_WHITE_Z
    fx, fy, fz = _lab_f(x), _lab_f(y), _lab_f(z)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)],
                       dim=-1).to(torch.float32)


# ---------------------------------------------------------------- preprocess
def pad_edge(arr: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """Edge-replicate padding along one dimension."""
    n = arr.shape[dim]
    idx = torch.arange(-before, n + after, device=arr.device).clamp_(0, n - 1)
    return arr.index_select(dim, idx)


def channel_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float32 image -> (7, H, W): RGB, x-gradient, Lab."""
    rgb = torch.movedim(img, -1, 0)
    g = pad_edge(gray(img), 1, 1, 1)
    grad = (g[:, 2:] - g[:, :-2]).to(torch.float32)[None]
    return torch.cat([rgb, grad, torch.movedim(lab(img), -1, 0)], dim=0)


def spatial_weights(cfg) -> np.ndarray:
    """(K, K) exp(-|o|_2 / gamma_p), float64 then float32."""
    r = cfg.window_radius
    wy, wx = np.mgrid[-r: r + 1, -r: r + 1]
    dist = np.sqrt((wy**2 + wx**2).astype(np.float64))
    return np.exp(-dist / cfg.gamma_spatial).astype(np.float32)


def axial_weights(cfg) -> np.ndarray:
    """(K,) exp(-|o| / gamma_p) of the separable passes."""
    r = cfg.window_radius
    o = np.abs(np.arange(-r, r + 1)).astype(np.float64)
    return np.exp(-o / cfg.gamma_spatial).astype(np.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as a tensor core takes a float32 operand."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


# ---------------------------------------------------------------------- cost
def cost_plane(ls: torch.Tensor, rs: torch.Tensor, d: int, cfg) -> torch.Tensor:
    """Raw cost of disparity ``d`` over stacks of the same rows: ``ls``
    (7, h, We), ``rs`` (7, h, We + D - 1) -> (h, We)."""
    D = cfg.max_disparity
    we = ls.shape[2]
    start = (D - 1) - d
    lc = torch.movedim(ls[0:3], 0, -1)
    rc = torch.movedim(rs[0:3, :, start: start + we], 0, -1)
    ad = torch.abs(lc - rc).mean(dim=-1)
    if cfg.cost == "ad":
        return ad.to(torch.float32)
    grad = torch.abs(ls[3] - rs[3, :, start: start + we])
    out = cfg.alpha * torch.clamp(ad, max=cfg.tau_color) + (
        1.0 - cfg.alpha) * torch.clamp(grad, max=cfg.tau_grad)
    return out.to(torch.float32)


# ---------------------------------------------------------- WTA, post-process
def _take(vol: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(vol, -1, idx.to(torch.int64)[..., None])[..., 0]


def right_volume(vol: torch.Tensor) -> torch.Tensor:
    """C_R(x', d) = C_L(x' + d, d); candidates past the right edge +inf."""
    h, w, D = vol.shape
    inf_cols = torch.full((h, D - 1, D), float("inf"), dtype=vol.dtype, device=vol.device)
    m = torch.cat([vol, inf_cols], dim=1)
    x = torch.arange(w, device=vol.device)[:, None]
    d = torch.arange(D, device=vol.device)[None, :]
    return torch.gather(m, 1, (x + d).expand(h, w, D)).to(torch.float32)


def lr_check(disp_l: torch.Tensor, disp_r: torch.Tensor, cfg) -> torch.Tensor:
    h, w = disp_l.shape
    dl = disp_l.to(torch.float32)
    dli = torch.round(dl).to(torch.int64)
    xr = torch.arange(w, device=dl.device)[None, :] - dli
    in_range = (xr >= 0) & (xr < w) & (dli >= 0) & (dli < cfg.max_disparity)
    dr = torch.gather(disp_r.to(torch.float32), 1, xr.clamp(0, w - 1))
    return in_range & (torch.abs(dl - dr) <= cfg.lr_tol)


def fill_holes(disp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Invalid pixels take min(nearest valid left, nearest valid right)."""
    h, w = disp.shape
    cols = torch.arange(w, device=disp.device).expand(h, w)
    left_idx = torch.where(valid, cols, torch.full_like(cols, -1)).cummax(dim=1).values
    right_idx = torch.where(valid, cols, torch.full_like(cols, w))
    right_idx = right_idx.flip(1).cummin(dim=1).values.flip(1)
    inf = torch.tensor(float("inf"), device=disp.device)
    dl = torch.where(left_idx >= 0, torch.gather(disp, 1, left_idx.clamp(min=0)), inf)
    dr = torch.where(right_idx < w, torch.gather(disp, 1, right_idx.clamp(max=w - 1)), inf)
    fill = torch.minimum(dl, dr)
    fill = torch.where(torch.isinf(fill), torch.zeros_like(fill), fill)
    return torch.where(valid, disp, fill)


def disp_pre(vol: torch.Tensor, cfg) -> torch.Tensor:
    """WTA, subpixel, LR and uniqueness gates and fill of an (h, W, D)
    aggregated volume (all row-local)."""
    D = vol.shape[-1]
    disp_i = torch.argmin(vol, dim=-1).to(torch.int32)
    disp = disp_i.to(torch.float32)
    if cfg.subpixel:
        d = disp_i.to(torch.int64)
        c0 = _take(vol, d)
        cm = _take(vol, torch.clamp(d - 1, 0, D - 1))
        cp = _take(vol, torch.clamp(d + 1, 0, D - 1))
        denom = cp - 2.0 * c0 + cm
        off = torch.clamp((cp - cm) / (2.0 * denom), -0.5, 0.5)
        ok = (disp_i > 0) & (disp_i < D - 1) & (torch.abs(denom) > 1e-6)
        disp = torch.where(ok, disp - off, disp)
    valid = None
    if cfg.lr_check:
        valid = lr_check(disp_i, torch.argmin(right_volume(vol), dim=-1).to(torch.int32), cfg)
    if cfg.uniqueness_ratio > 0:
        best = _take(vol, disp_i)
        far = torch.abs(torch.arange(D, device=vol.device) - disp_i[..., None].to(torch.int64)) > 1
        inf = torch.tensor(float("inf"), dtype=vol.dtype, device=vol.device)
        second = torch.amin(torch.where(far, vol, inf), dim=-1)
        uv = second * 100.0 >= best * (100.0 + cfg.uniqueness_ratio)
        valid = uv if valid is None else valid & uv
    if valid is not None:
        if cfg.fill_holes:
            disp = fill_holes(disp, valid)
        else:
            disp = torch.where(valid, disp, torch.full_like(disp, -1.0))
    return disp.to(torch.float32)


def median3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median, replicate border."""
    h, w = disp.shape
    pad = pad_edge(pad_edge(disp, 0, 1, 1), 1, 1, 1)
    taps = torch.stack([pad[dy: dy + h, dx: dx + w] for dy in range(3) for dx in range(3)],
                       dim=-1)
    return torch.sort(taps, dim=-1).values[..., 4].to(torch.float32)


# --------------------------------------------------------------- the map
def config(fields: dict) -> SimpleNamespace:
    """The configuration's ``stereo_config`` fields, checked for what this
    reference computes."""
    cfg = SimpleNamespace(**fields)
    if cfg.median_filter and cfg.median_mode != "plain":
        raise ValueError("the plain reference computes the plain 3x3 median only")
    if cfg.cost not in ("ad", "tad_grad"):
        raise ValueError(f"the plain reference has no cost {cfg.cost!r}")
    return cfg


def _block_rows(stack: torch.Tensor, y0: int, y1: int, halo: int) -> torch.Tensor:
    """Rows [y0 - halo, y1 + halo) of a (C, H, W') stack, edge-clamped."""
    idx = torch.arange(y0 - halo, y1 + halo, device=stack.device).clamp_(0, stack.shape[1] - 1)
    return stack.index_select(1, idx)


def disparity(left, right, fields: dict, aggregation: str, device="cpu",
              precision: str = "float32", block_rows: int = 48) -> np.ndarray:
    """The float32 (H, W) disparity map of one pair of (H, W, 3) uint8
    images under the configuration ``fields``, with the aggregation of
    ``benchmark/reference/<aggregation>.py``.  ``block_rows`` rows are
    aggregated at a time, or all of them where the module sets
    ``WHOLE_IMAGE``; the result does not depend on it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    cfg = config(fields)
    agg = importlib.import_module(f"{__package__}.{aggregation}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    r, D = cfg.window_radius, cfg.max_disparity
    with torch.no_grad():
        imgs = [torch.from_numpy(np.ascontiguousarray(a)).to(device).to(torch.float32)
                for a in (left, right)]
        ls = pad_edge(channel_stack(imgs[0]), 2, r, r)
        rs = pad_edge(channel_stack(imgs[1]), 2, r + D - 1, r)
        h = ls.shape[1]
        if getattr(agg, "WHOLE_IMAGE", False):
            block_rows = h
        rows = []
        for y0 in range(0, h, block_rows):
            y1 = min(h, y0 + block_rows)
            vol = agg.aggregate_block(_block_rows(ls, y0, y1, r), _block_rows(rs, y0, y1, r),
                                      cfg, precision)
            rows.append(disp_pre(vol, cfg))
            del vol
        disp = torch.cat(rows, dim=0)
        if cfg.median_filter:
            disp = median3(disp)
        return disp.cpu().numpy()
