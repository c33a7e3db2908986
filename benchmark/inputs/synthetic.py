"""Synthetic rectified stereo pairs with exact ground-truth disparity.

Copied from ``aswstereomatch_torch/utils/synthetic.py`` (``make_pair``,
``make_dataset_pair``, ``GEOMETRIES`` and their helpers), so that a change to
the program cannot move the benchmark's inputs.  A textured background plane
plus textured foreground rectangles, each at a constant disparity; both views
are rendered from the same layer stack, so ground truth and occlusion masks
are exact by construction.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int, octaves: int = 4) -> np.ndarray:
    """Procedural multi-octave smooth noise texture, float32 RGB in [0,255]."""
    img = np.zeros((h, w, 3), np.float32)
    amp = 1.0
    for o in range(octaves):
        sh = max(2, h >> (octaves - 1 - o)), max(2, w >> (octaves - 1 - o))
        coarse = rng.standard_normal((sh[0], sh[1], 3)).astype(np.float32)
        # bilinear upsample to (h, w)
        yi = np.linspace(0, sh[0] - 1, h, dtype=np.float32)
        xi = np.linspace(0, sh[1] - 1, w, dtype=np.float32)
        y0 = np.floor(yi).astype(np.int32)
        x0 = np.floor(xi).astype(np.int32)
        y1 = np.minimum(y0 + 1, sh[0] - 1)
        x1 = np.minimum(x0 + 1, sh[1] - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        up = (
            coarse[y0][:, x0] * (1 - fy) * (1 - fx)
            + coarse[y0][:, x1] * (1 - fy) * fx
            + coarse[y1][:, x0] * fy * (1 - fx)
            + coarse[y1][:, x1] * fy * fx
        )
        img += amp * up
        amp *= 0.6
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    # Pin to the 8-bit integer grid (the colorspace spec requires it).
    return np.round(img).astype(np.float32)


def _sample_x(tex: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Sample tex (H,W,3) at fractional x coords xq (H,W), clamped, linear."""
    h, w = tex.shape[:2]
    xq = np.clip(xq, 0, w - 1)
    x0 = np.floor(xq).astype(np.int32)
    x1 = np.minimum(x0 + 1, w - 1)
    f = (xq - x0)[..., None]
    rows = np.arange(h)[:, None]
    return tex[rows, x0] * (1 - f) + tex[rows, x1] * f


def _flatten_patches(
    tex: np.ndarray, rng: np.random.Generator, count: int
) -> np.ndarray:
    """Replace ``count`` random rectangles of a texture with their mean color
    (textureless regions); applied to the texture, so both views stay
    photometrically consistent and ground truth remains exact."""
    h, w = tex.shape[:2]
    out = tex.copy()
    for _ in range(count):
        rh = int(rng.integers(h // 6, h // 3))
        rw = int(rng.integers(w // 6, w // 3))
        y0 = int(rng.integers(0, h - rh))
        x0 = int(rng.integers(0, w - rw))
        patch = out[y0 : y0 + rh, x0 : x0 + rw]
        out[y0 : y0 + rh, x0 : x0 + rw] = np.round(patch.mean(axis=(0, 1)))
    return out


def make_pair(
    height: int = 96,
    width: int = 128,
    max_disparity: int = 16,
    num_layers: int = 3,
    seed: int = 0,
    fractional: bool = False,
    flat_patches: int = 0,
) -> Dict[str, np.ndarray]:
    """Render a layered synthetic stereo pair.

    Returns dict with:
      left, right  : float32 RGB (H,W,3) in [0,255]
      gt           : float32 (H,W) left-view disparity (exact)
      occluded     : bool (H,W) left pixels whose right-view match is hidden
      layer_left   : int32 (H,W) topmost layer id per left pixel
    """
    rng = np.random.default_rng(seed)
    h, w = height, width
    d_bg = 1.0 if max_disparity > 2 else 0.0
    # Layer disparities strictly increasing (nearer layers later); degrade
    # gracefully for tiny disparity ranges (layers collapse toward d_bg).
    max_d = max(float(max_disparity - 2), d_bg)
    lo = min(d_bg + 1.0, max_d)
    ds = np.sort(rng.uniform(lo, max(max_d, lo + 1e-6), size=num_layers))
    if not fractional:
        ds = np.round(ds)
        d_bg = round(d_bg)

    textures = [_texture(rng, h, w, octaves=4) for _ in range(num_layers + 1)]
    if flat_patches:
        textures = [_flatten_patches(t, rng, flat_patches) for t in textures]
    disps = [float(d_bg)] + [float(d) for d in ds]

    # Layer masks in LEFT coordinates (background covers everything).
    masks = [np.ones((h, w), bool)]
    for i in range(num_layers):
        rh = int(rng.integers(h // 5, h // 2))
        rw = int(rng.integers(w // 5, w // 2))
        y0 = int(rng.integers(0, h - rh))
        x0 = int(rng.integers(int(disps[i + 1]) + 1, max(w - rw, int(disps[i + 1]) + 2)))
        m = np.zeros((h, w), bool)
        m[y0 : y0 + rh, x0 : x0 + rw] = True
        masks.append(m)

    xs = np.arange(w, dtype=np.float32)[None, :].repeat(h, axis=0)

    # Render left view + GT, back to front.
    left = np.zeros((h, w, 3), np.float32)
    gt = np.zeros((h, w), np.float32)
    layer_left = np.zeros((h, w), np.int32)
    for i, (tex, d, m) in enumerate(zip(textures, disps, masks)):
        left[m] = tex[m]
        gt[m] = d
        layer_left[m] = i

    # Render right view: right pixel x shows layer i where (y, x + d_i) is in
    # the layer's left-coordinate mask (drawn back to front).
    right = np.zeros((h, w, 3), np.float32)
    layer_right = np.full((h, w), -1, np.int32)
    for i, (tex, d, m) in enumerate(zip(textures, disps, masks)):
        xl = xs + d  # matching left x-coordinate
        inside = xl <= w - 1
        if float(d).is_integer():
            di = int(d)
            src = np.roll(m, -di, axis=1)
            src[:, w - di :] = False if di > 0 else src[:, w - di :]
            vis = src & inside
            shifted = np.roll(tex, -di, axis=1)
            right[vis] = shifted[vis]
        else:
            xi = np.clip(np.round(xl).astype(np.int32), 0, w - 1)
            rows = np.arange(h)[:, None].repeat(w, axis=1)
            vis = m[rows, xi] & inside
            right[vis] = _sample_x(tex, xl)[vis]
        layer_right[vis] = i

    # Fill any never-covered right columns (x + d_bg > w-1) with clamped bg.
    uncovered = layer_right < 0
    if uncovered.any():
        right[uncovered] = _sample_x(textures[0], xs + disps[0])[uncovered]
        layer_right[uncovered] = 0

    # Occlusion: left pixel of layer i is occluded if the right pixel it maps
    # to shows a different (nearer) layer.
    xr = np.clip(np.round(xs - gt).astype(np.int32), 0, w - 1)
    rows = np.arange(h)[:, None].repeat(w, axis=1)
    occluded = layer_right[rows, xr] != layer_left
    occluded |= (xs - gt) < 0

    return {
        "left": np.round(left).astype(np.float32),
        "right": np.round(right).astype(np.float32),
        "gt": gt,
        "occluded": occluded,
        "layer_left": layer_left,
    }


# Geometry presets mirroring the BASELINE configs' datasets: (H, W, D).
GEOMETRIES = {
    "tsukuba": (288, 384, 16),
    "venus": (375, 450, 64),
    "teddy": (375, 450, 64),
    "cones": (375, 450, 64),
    "kitti": (375, 1242, 128),
}


# Same-geometry dataset names get distinct scene content (teddy/cones share
# venus's 450x375 D=64 geometry but must not be the identical image pair).
_SCENE_SEED_OFFSET = {"teddy": 1009, "cones": 2003}


def make_dataset_pair(name: str, seed: int = 0, **kw) -> Dict[str, np.ndarray]:
    """``make_pair`` at the named dataset's geometry (``GEOMETRIES``)."""
    h, w, d = GEOMETRIES[name.lower()]
    seed = seed + _SCENE_SEED_OFFSET.get(name.lower(), 0)
    return make_pair(height=h, width=w, max_disparity=d, seed=seed, **kw)
