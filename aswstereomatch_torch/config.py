"""Canonical configuration for the PyTorch/CUDA stereo-matching engine.

A copy of ``aswstereomatch_tpu.config`` (which cannot be imported here: any
module of that package loads jax) with the same fields, defaults, validation
and presets.  Only ``backend`` speaks another vocabulary: "auto" | "eager" |
"cuda".  ``utils.convert`` carries a reference config across, and
tests/test_torch_config.py holds the two modules equal field for field.

Pinned numeric conventions (all implementations MUST follow these):
  - Images are float32 RGB in [0, 255] on the 8-bit integer grid, (H, W, 3).
  - Grayscale: Rec.601, ``0.299 R + 0.587 G + 0.114 B`` (matches cv2 RGB2GRAY).
  - x-gradient: central difference ``g(x) = I(x+1) - I(x-1)`` on grayscale with
    replicate border (matches ``cv2.Sobel(..., ksize=1)`` + BORDER_REPLICATE).
  - **Virtual padded-plane border semantics**: all out-of-image accesses read
    edge-replicated (replicate-border) virtual planes with *unclamped
    arithmetic indices* — conceptually ``Lp = pad_edge(left, r)`` in x/y and
    ``Rp = pad_edge(right, (r + D - 1, r))`` in x — rather than re-clamping
    composed coordinates.  This makes every access in every stage a pure
    shift (no gathers), so the loop oracle, the vectorized jnp path and the
    tiled Pallas kernels agree bit-for-bit by construction.
  - AD cost: ``C(x, d) = mean_c |Lp_c(x) - Rp_c(x - d)|``, defined for the
    x-extended domain ``x in [-r, W-1+r]`` that aggregation taps.
  - TAD+grad cost: ``alpha * min(AD, tau1) + (1-alpha) * min(|gLp - gRp|, tau2)``.
  - Box aggregation: mean over the (2r+1)^2 window; x taps hit the extended
    cost domain, y taps the edge-replicated rows.
  - ASW weights (Yoon-Kweon TPAMI 2006): CIELab color distance, D65, sRGB
    gamma; ``w(p,q) = exp(-dLab(p,q)/gamma_c - |p-q|_2/gamma_p)`` with the
    spatial term from the *nominal* window offset; left weights from Lp,
    right weights from Rp centered at ``x - d``; symmetric two-view product
    ``wL * wR`` unless ``asw_symmetric=False``.
  - WTA: first-occurrence argmin over d.
  - Subpixel: parabola ``d* = d - (C+ - C-)/(2 (C+ - 2 C0 + C-))``, offset
    clamped to [-0.5, 0.5], only applied for 0 < d < D-1 and |denom| > 1e-6.
  - Right disparity by volume reuse: ``C_R(x', d) = C_L(x' + d, d)`` where
    candidates with ``x' + d > W - 1`` are **excluded** from the argmin
    (no left pixel exists for them).
  - LR check: valid iff ``x - round(dL) >= 0`` and
    ``|dL(x) - dR(x - round(dL(x)))| <= lr_tol``.
  - Fill: per-row, each invalid pixel takes ``min(nearest valid to the left,
    nearest valid to the right)`` (background bias); one-sided at row edges.
  - Median: 3x3 median on the float disparity map, replicate border, last.
  - Weighted median ("weighted" mode): 3x3 window; weights
    ``exp(-dLab(center, tap)/gamma_c - |o|_2/gamma_p)`` from the LEFT image
    (edge-replicated taps, nominal-offset spatial term); taps sorted
    ascending by disparity (stable); output is the first tap value whose
    cumulative weight reaches half the total.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Frozen parameter block for one stereo-matching run.

    Field for field the reference's ``StereoConfig``.  ``match_pair`` runs
    one pair on one device; the mesh fields (``mesh_data``, ``mesh_tile``,
    ``tile_axis``) are read by ``parallel/`` (``parallel.api`` and the CLI's
    ``--mesh``).
    """

    # ---- geometry -----------------------------------------------------------
    max_disparity: int = 64            # D: candidate disparities are [0, D)
    # ---- cost ---------------------------------------------------------------
    cost: str = "tad_grad"             # "ad" | "tad_grad"
    tau_color: float = 40.0            # tau1: truncation of the color AD term
    tau_grad: float = 10.0             # tau2: truncation of the gradient term
    alpha: float = 0.9                 # blend: alpha*AD + (1-alpha)*grad
    # ---- aggregation --------------------------------------------------------
    aggregation: str = "asw"           # "none" | "box" | "asw" | "sgm"
    window_radius: int = 16            # r: window is (2r+1) x (2r+1)
    gamma_color: float = 14.0          # gamma_c: Lab color bandwidth (ASW)
    gamma_spatial: float = 31.0        # gamma_p: spatial bandwidth (ASW)
    asw_symmetric: bool = True         # two-view (wL*wR) vs left-only weights
    # Semi-global aggregation (4- or 8-path scanline propagation over the
    # raw cost volume, recurrence as pinned in the reference's config.py).
    sgm_p1: float = 8.0                # small-slant penalty (|dd| = 1)
    sgm_p2: float = 32.0               # discontinuity penalty (|dd| > 1)
    sgm_paths: int = 4                 # 4 (axial) | 8 (+ diagonals)
    asw_separable: bool = False        # two-pass separable approximation of
                                       # the ASW window (a documented speed
                                       # mode, not the exact Yoon-Kweon sum)
    # ---- post-processing ----------------------------------------------------
    lr_check: bool = True
    lr_tol: float = 1.0                # max |dL - dR| to accept a pixel
    uniqueness_ratio: float = 0.0      # WTA-uniqueness gate: reject a pixel
                                       # unless second*100 >= best*(100+ratio),
                                       # second = best cost over d outside
                                       # [best-1, best+1].  0.0 disables it.
    fill_holes: bool = True
    subpixel: bool = True
    median_filter: bool = True         # final 3x3 median
    median_mode: str = "plain"         # "plain" | "weighted"
    # ---- memory -------------------------------------------------------------
    y_chunks: int = 1                  # >1: stream row bands (eager path)
    volume_dtype: str = "float32"      # separable kernel's cost storage
    # ---- parallelism (read by parallel/: parallel.api, the CLI's --mesh) ----
    mesh_data: int = 1                 # chips along the batch ("data") axis
    mesh_tile: int = 1                 # chips along the spatial ("tile") axis
    tile_axis: str = "y"               # what "tile" shards: "y" | "x" | "d"
    # ---- backend selection --------------------------------------------------
    backend: str = "auto"              # "auto" | "eager" | "cuda"
    kernel_layout: str = "auto"        # "auto" | "xlanes" | "dlanes"; picks
                                       # the kernel as the reference does
                                       # (pipeline.kernel_for); separable +
                                       # "xlanes" runs eager

    def __post_init__(self):
        if self.cost not in ("ad", "tad_grad"):
            raise ValueError(f"unknown cost {self.cost!r}")
        if self.aggregation not in ("none", "box", "asw", "sgm"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if self.aggregation == "sgm":
            if self.sgm_p1 < 0 or self.sgm_p2 < self.sgm_p1:
                raise ValueError("require 0 <= sgm_p1 <= sgm_p2")
            if self.sgm_paths not in (4, 8):
                raise ValueError("sgm_paths must be 4 or 8")
        if self.tile_axis not in ("y", "x", "d"):
            raise ValueError("tile_axis must be 'y', 'x' or 'd'")
        if self.max_disparity < 1:
            raise ValueError("max_disparity must be >= 1")
        if self.uniqueness_ratio < 0:
            raise ValueError("uniqueness_ratio must be >= 0")
        if self.window_radius < 0:
            raise ValueError("window_radius must be >= 0")
        if self.backend not in ("auto", "eager", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.median_mode not in ("plain", "weighted"):
            raise ValueError(f"unknown median_mode {self.median_mode!r}")
        if self.kernel_layout not in ("auto", "xlanes", "dlanes"):
            raise ValueError(f"unknown kernel_layout {self.kernel_layout!r}")
        if self.asw_separable and self.aggregation != "asw":
            raise ValueError("asw_separable requires aggregation='asw'")
        if self.volume_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown volume_dtype {self.volume_dtype!r}")
        if self.volume_dtype == "bfloat16":
            # Consumed only by the separable d-lanes kernel; configs that can
            # never route there are rejected (the reference's rule).
            if not self.asw_separable:
                raise ValueError("volume_dtype='bfloat16' requires asw_separable")
            routable = (
                2 <= self.max_disparity <= 128
                and self.window_radius <= 32
                and self.kernel_layout != "xlanes"
            )
            if not routable:
                raise ValueError(
                    "volume_dtype='bfloat16' is consumed only by the "
                    "separable d-lanes kernel, which this config cannot "
                    "route to (requires max_disparity in [2, 128], "
                    "window_radius <= 32, kernel_layout != 'xlanes')"
                )

    # -- derived --------------------------------------------------------------
    @property
    def window_size(self) -> int:
        return 2 * self.window_radius + 1

    @property
    def halo_y(self) -> int:
        """Rows of image halo a y-tile needs on each side for exact tiling:
        window_radius for aggregation + 1 for the final 3x3 median."""
        r = self.window_radius if self.aggregation != "none" else 0
        return r + (1 if self.median_filter else 0)

    @property
    def halo_x(self) -> Tuple[int, int]:
        """(left, right) columns of image halo an x-tile needs: the right
        stack reaches ``max_disparity - 1`` columns further left."""
        r = self.window_radius if self.aggregation != "none" else 0
        return (r + self.max_disparity - 1, r)

    def config_hash(self) -> str:
        """Stable short hash for observability / manifest keys."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def replace(self, **kw) -> "StereoConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The BASELINE configs as named presets.  Dataset geometries:
#   Tsukuba 384x288 D=16; Venus/Teddy/Cones 450x375 D=64; KITTI 1242x375 D=128.
# ---------------------------------------------------------------------------

# Separable-mode accuracy contract vs exact ASW at KITTI geometry (the
# reference's tools/pin_sep_accuracy.py and tests/test_accuracy_regression.py).
SEP_CONTRACT = {"delta_bad2_max": 0.01, "gt_bad2_cost_max": 0.003}

PRESETS = {
    # Tsukuba (384x288, D=16), AD cost + fixed-window aggregation.
    "tsukuba_ad_box": StereoConfig(
        max_disparity=16,
        cost="ad",
        aggregation="box",
        window_radius=4,
        lr_check=False,
        fill_holes=False,
        subpixel=False,
        median_filter=False,
    ),
    # Venus/Teddy/Cones (450x375, D=64), TAD+gradient cost, ASW aggregation.
    "middlebury_asw": StereoConfig(
        max_disparity=64,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=False,
        fill_holes=False,
        subpixel=False,
        median_filter=False,
    ),
    # ASW with 33x33 windows + LR consistency, fill, subpixel and median:
    # the main path.
    "middlebury_asw_full": StereoConfig(
        max_disparity=64,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
    ),
    # KITTI (1242x375, D=128), exact symmetric ASW; mesh_tile declares the
    # 4-shard y-tiled layout parallel.api runs where four devices fit.
    "kitti_tiled": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_tile=4,
    ),
    # Batched KITTI sequence sharded across hosts (mesh_data x mesh_tile).
    "kitti_batch": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_data=2,
        mesh_tile=4,
    ),
    # Separable symmetric ASW at KITTI geometry (speed mode, accuracy-
    # contracted against exact ASW by SEP_CONTRACT).
    "kitti_sep": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        asw_separable=True,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_tile=4,
    ),
    # Separable left-only ASW at KITTI geometry.
    "kitti_seplo": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="asw",
        window_radius=16,
        asw_separable=True,
        asw_symmetric=False,
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
        mesh_tile=4,
    ),
    # Semi-global mode: 4-path scanline propagation over the raw TAD+grad
    # cost.
    "kitti_sgm": StereoConfig(
        max_disparity=128,
        cost="tad_grad",
        aggregation="sgm",
        lr_check=True,
        fill_holes=True,
        subpixel=True,
        median_filter=True,
    ),
}


def get_preset(name: str) -> StereoConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
