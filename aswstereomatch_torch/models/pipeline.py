"""End-to-end stereo matching pipeline in PyTorch.

Counterpart of ``aswstereomatch_tpu.models.pipeline``.  ``match_pair(left,
right, cfg)`` runs one pair: images -> cost (fused into aggregation) -> WTA
-> subpixel -> LR check -> fill -> median -> float32 (H, W) disparity map.

Backends:
  - "eager": the plain PyTorch stages (ops/) over the materialized
             aggregated volume — runs on any device; the oracle for the
             kernels.  It stores the volume in float32 whatever
             ``volume_dtype`` says (and warns when that says bfloat16).
  - "cuda":  a hand-written CUDA kernel (ops/cuda) for cost + aggregation +
             WTA.  ``kernel_for`` picks it from the config alone, as the
             reference's ``_kernel_wta`` picks its Pallas kernel:
             ``asw_sep_kernel`` for
             ``asw_separable``; ``asw_sym_dlanes_kernel`` for symmetric ASW
             pinned to ``kernel_layout="dlanes"``; ``asw_dlanes_kernel``
             for left-only ASW, box at D > 64 and either pinned to
             "dlanes"; ``asw_kernel`` (fused exact ASW or box) for the
             rest.  "dlanes" on a geometry no d-lanes kernel supports
             raises.
  - "auto":  "cuda" for CUDA tensors when a kernel serves the config,
             "eager" otherwise.

Both backends end the aggregation stage at the same WTA planes (the
kernel's outputs, or the eager volume's, one launch of the WTA kernel
(ops/cuda/wta_kernel) on the card and ``wta.planes`` on the CPU), and one
post-process turns planes into a map: ``disparity``, which is ``disp_pre``
(row-local) then the median, and which the sharded layouts in
``parallel/`` call too.  On CUDA planes it is one launch of the disparity
kernel (ops/cuda/disparity_kernel), on CPU planes that kernel's plain ops.

SGM (``aggregation="sgm"``) runs on the eager backend: its aggregation
stage is the hand-written scan kernel (ops/cuda/sgm_kernel) on a CUDA
tensor.  ``y_chunks > 1`` streams row bands on the eager path
(``match_pair_chunked``); ``match_pair_with_confidence`` returns the
disparity with the uniqueness margin and the LR mask.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import StereoConfig, get_preset
from ..ops import aggregate, postprocess, preprocess
from ..ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel, asw_sym_dlanes_kernel,
                        disparity_kernel, wta_kernel)
from ..utils.profiling import span


def kernel_for(cfg: StereoConfig):
    """The kernel module that serves ``cfg`` on the card, or None when no
    kernel does (the eager path serves it).  Raises where the reference
    raises: ``kernel_layout="dlanes"`` on a geometry its d-lanes kernel does
    not support.

    The reference's choice, in its order: its ``_resolve_backend`` keeps
    separable configs its separable kernel routes and exact ``asw``/``box``
    configs (``asw_kernel.supports``), then its ``_kernel_wta`` tries the
    symmetric d-lanes kernel, the d-lanes kernel and the x-lanes kernel.
    The reference's work threshold for small box problems is not kept (it
    was measured on a TPU)."""
    if cfg.asw_separable:
        return asw_sep_kernel if asw_sep_kernel.routed(cfg) else None
    if not asw_kernel.supports(cfg):
        return None
    if asw_sym_dlanes_kernel.routed(cfg):
        return asw_sym_dlanes_kernel
    if asw_dlanes_kernel.routed(cfg):
        return asw_dlanes_kernel
    return asw_kernel


def _resolve_backend(cfg: StereoConfig, device: torch.device) -> str:
    """Which backend runs ``cfg`` on tensors on ``device``: "cuda" when the
    tensors are on the card and ``kernel_for`` names a kernel (which raises
    for an unsupported "dlanes" pin), "eager" otherwise.  As in the
    reference, a separable config's routing is checked on every device, an
    exact one's only where a kernel would run.  A bfloat16
    ``volume_dtype`` resolved to the eager path warns: that path stores the
    volume in float32."""
    if cfg.backend == "eager":
        return _eager(cfg)
    on_card = torch.device(device).type == "cuda"
    if cfg.backend == "cuda" and not on_card:
        raise ValueError("backend='cuda' needs tensors on a CUDA device")
    kernel = kernel_for(cfg) if on_card or cfg.asw_separable else None
    if on_card and kernel is not None:
        return "cuda"
    if cfg.backend == "cuda":
        raise ValueError(
            "backend='cuda' has no kernel for this config (the kernels serve "
            "exact 'asw' and 'box' aggregation, and separable ASW with D in "
            "[2, 128], r <= 32 and kernel_layout != 'xlanes')"
        )
    return _eager(cfg)


def _eager(cfg: StereoConfig) -> str:
    if cfg.volume_dtype == "bfloat16":
        # bf16 cost storage exists only inside the separable kernel; the
        # eager path computes in float32, which the declared dtype (and the
        # config hash) would otherwise misstate.
        warnings.warn(
            "volume_dtype='bfloat16' config resolved to the eager backend "
            "(no CUDA tensors / unsupported geometry): the run stores the "
            "volume in float32",
            stacklevel=3,
        )
    return "eager"


def _kernel_wta(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> dict:
    """Kernel WTA outputs from the kernel ``kernel_for`` picks.  A config no
    kernel serves raises: in particular the exact kernels must never compute
    a separable config's window."""
    kernel = kernel_for(cfg)
    if kernel is None:
        if cfg.asw_separable:
            raise ValueError(
                "separable ASW has no xlanes kernel and requires "
                "max_disparity in [2, 128] and window_size <= 65 "
                "(kernel_layout 'auto'/'dlanes'); use backend='auto'/'eager'"
            )
        raise ValueError("no kernel serves this config; use backend='auto'/'eager'")
    with span("pipeline.aggregate"):
        return kernel.wta_outputs(left, right, cfg)


def _planes(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig, backend: str,
            ubest: bool = False) -> dict:
    """One pair's WTA planes, where the aggregation stage ends on either
    route: the kernel's outputs, or the eager volume's planes
    (``wta_kernel.planes``: one launch of the WTA kernel on the card, the
    plain ``wta.planes`` on the CPU; ``rbestd`` where the LR check reads
    it, ``ubest`` where the uniqueness gate or the caller does), both
    inside ``pipeline.aggregate``; the volume's WTA in its own span,
    ``pipeline.wta``."""
    if backend == "cuda":
        return _kernel_wta(left, right, cfg)
    with span("pipeline.aggregate"):
        vol = aggregate.aggregated_volume(left, right, cfg)
        with span("pipeline.wta"):
            return wta_kernel.planes(vol, rbestd=cfg.lr_check,
                                     ubest=ubest or cfg.uniqueness_ratio > 0)


def _planes_to_map(planes: dict, cfg: StereoConfig, median: bool) -> torch.Tensor:
    """Subpixel + LR + uniqueness + fill from one pair's WTA planes, then,
    where ``median``, the plain 3x3 median: the plain ops for CPU planes,
    one launch of the disparity kernel for any other (which raises on
    planes it cannot take)."""
    if planes["bestd"].device.type == "cpu":
        return disparity_kernel.reference(planes, cfg, median)
    return disparity_kernel.disparity_map(planes, cfg, median)


def disp_pre(planes: dict, cfg: StereoConfig) -> torch.Tensor:
    """Subpixel + LR + uniqueness + fill from one pair's WTA planes
    (everything row-local; no median)."""
    return _planes_to_map(planes, cfg, median=False)


def guide_lab(left: torch.Tensor, cfg: StereoConfig):
    """The weighted median's guide, the left view in Lab, or None where
    the median is plain or off."""
    if cfg.median_filter and cfg.median_mode == "weighted":
        return preprocess.rgb_to_lab(left)
    return None


def disparity(planes: dict, cfg: StereoConfig, guide) -> torch.Tensor:
    """The float32 (H, W) map from one pair's WTA planes: ``disp_pre``,
    then the 3x3 median, weighted by ``guide`` (``guide_lab``).  The plain
    median runs in the same launch as ``disp_pre`` on the card; the
    weighted one follows it as plain ops."""
    if cfg.median_filter and cfg.median_mode == "weighted":
        return postprocess.median_filter(disp_pre(planes, cfg), cfg, guide)
    return _planes_to_map(planes, cfg, median=cfg.median_filter)


def tile_disparity(
    left_ext: torch.Tensor,
    right_ext: torch.Tensor,
    cfg: StereoConfig,
    halo: int,
    rows: int,
    true_h: int,
    start: int,
) -> torch.Tensor:
    """Disparity for one row band given halo-extended image tiles:
    left_ext / right_ext (halo + rows + halo, W[, 3]) -> (rows, W).

    Routes through the kernel when ``_resolve_backend`` picks one (each
    pixel's kernel result does not depend on its position, so only the
    trimmed halo rows see the band's edge).  The band's 3x3 median takes
    its rows by global-row-clamped index, so rows at the image's true top
    and bottom reproduce the unbanded edge clamp: banded == unbanded bit
    for bit hinges on it."""
    planes = _planes(left_ext, right_ext, cfg, _resolve_backend(cfg, left_ext.device))
    with span("pipeline.postprocess"):
        disp = disp_pre(planes, cfg)
        if not cfg.median_filter:
            return disp[halo : halo + rows]
        g = torch.arange(start - 1, start + rows + 1, device=disp.device).clamp(0, true_h - 1)
        local = (g - (start - halo)).clamp(0, disp.shape[0] - 1)  # global rows +-1
        guide = guide_lab(left_ext.index_select(0, local), cfg)
        return postprocess.median_filter(disp.index_select(0, local), cfg, guide)[1 : 1 + rows]


def match_pair_chunked(left: torch.Tensor, right: torch.Tensor,
                       cfg: StereoConfig) -> torch.Tensor:
    """Memory-streaming mode: ``cfg.y_chunks`` row bands one after another,
    each written into the (H, W) output before the next is built, so only
    one band's volume is alive at a time.  Bit for bit the unchunked
    pipeline.  SGM propagates along whole scanlines and is refused."""
    if cfg.aggregation == "sgm":
        raise ValueError(
            "aggregation='sgm' propagates globally along scanlines; "
            "y_chunks row streaming cannot reproduce the unchunked result"
        )
    h, w = left.shape[:2]
    n = cfg.y_chunks
    halo = cfg.halo_y
    pad = (-h) % n
    lp = preprocess.pad_edge(left, 0, 0, pad)
    rp = preprocess.pad_edge(right, 0, 0, pad)
    rows = lp.shape[0] // n
    if rows < halo:
        raise ValueError(f"{rows} rows/chunk < halo {halo}; reduce y_chunks")
    lp = preprocess.pad_edge(lp, 0, halo, halo)
    rp = preprocess.pad_edge(rp, 0, halo, halo)
    out = torch.empty((n * rows, w), dtype=torch.float32, device=left.device)
    for i in range(n):
        start = i * rows
        band = slice(start, start + rows + 2 * halo)
        out[start : start + rows] = tile_disparity(lp[band], rp[band], cfg, halo, rows, h, start)
    return out[:h]


def match_pair(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Match one rectified pair of float32 (H, W[, 3]) images -> float32
    (H, W) disparity, on the images' device.  The kernel path never
    materializes the volume and ignores ``y_chunks``, as the reference's
    does."""
    backend = _resolve_backend(cfg, left.device)
    if backend != "cuda" and cfg.y_chunks > 1:
        return match_pair_chunked(left, right, cfg)
    planes = _planes(left, right, cfg, backend)
    with span("pipeline.postprocess"):
        return disparity(planes, cfg, guide_lab(left, cfg))


def match_pair_with_confidence(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig):
    """Match one pair and return ``(disp, uniq_pct, lr_valid)``:

      - ``disp``: ``match_pair``'s disparity, every configured gate applied;
      - ``uniq_pct``: the WTA-uniqueness margin ``(second / best - 1) * 100``,
        ``second`` the best aggregated cost over d outside [best-1, best+1],
        clipped to [0, 1e6]; 1e6 where no such d exists and where
        best == 0 (the gate ``second * 100 >= best * (100 + r)`` accepts
        such a pixel at every ratio).  ``lr_valid & (uniq_pct >= r)``
        reproduces the ``uniqueness_ratio=r`` gate, up to f32 division
        rounding on exact knife-edge ties;
      - ``lr_valid``: the LR-consistency mask (all True when ``lr_check`` is
        off).

    All three come from one pair's WTA planes, the kernel's or the eager
    volume's; the eager path refuses ``y_chunks > 1`` rather than build the
    whole volume a chunked config exists to avoid."""
    backend = _resolve_backend(cfg, left.device)
    if backend != "cuda" and cfg.y_chunks > 1:
        raise ValueError(
            "match_pair_with_confidence does not support y_chunks > 1 "
            "on the eager path; use y_chunks=1 (or a kernel-backed config)"
        )
    planes = _planes(left, right, cfg, backend, ubest=True)
    with span("pipeline.postprocess"):
        disp = disparity(planes, cfg, guide_lab(left, cfg))
    bestc, second, disp_i = planes["bestc"], planes["ubest"], planes["bestd"]
    pos = bestc > 0.0
    margin = torch.clamp((second / torch.where(pos, bestc, 1.0) - 1.0) * 100.0, 0.0, 1e6)
    uniq_pct = torch.where(pos, margin, torch.full_like(margin, 1e6))
    if cfg.lr_check:
        lr_valid = postprocess.lr_check(disp_i, planes["rbestd"], cfg)
    else:
        lr_valid = torch.ones(disp_i.shape, dtype=torch.bool, device=disp_i.device)
    return disp, uniq_pct, lr_valid


def match_batch(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """(B, H, W[, 3]) x2 -> (B, H, W): one pair at a time (a single pair
    already fills the card).  Zero pairs give a (0, H, W) float32 tensor, as
    the reference's batch of none does."""
    if left.shape[0] == 0:
        return torch.empty((0, *left.shape[1:3]), dtype=torch.float32, device=left.device)
    return torch.stack(
        [match_pair(l, r, cfg) for l, r in zip(left, right)]
    )


class StereoMatcher:
    """A configured matcher bound to one device.

    >>> m = StereoMatcher.from_preset("middlebury_asw_full")   # device="cuda"
    >>> disp = m(left, right)             # single pair, (H, W) float32 tensor
    >>> disps = m.batch(lefts, rights)    # (B, H, W)

    Inputs are numpy arrays or tensors, uint8 (widened to float32 on the
    device, lossless) or float32.  The default device is "cuda"; building a
    matcher for a CUDA device on a machine without one raises — it never
    falls back to the CPU.
    """

    def __init__(self, cfg: StereoConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StereoMatcher(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the eager path on the CPU"
            )
        self.cfg = cfg

    @classmethod
    def from_preset(cls, name: str, device="cuda", **overrides) -> "StereoMatcher":
        cfg = get_preset(name)
        if overrides:
            cfg = cfg.replace(**overrides)
        return cls(cfg, device=device)

    def _as_input(self, img) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(img)) if isinstance(img, np.ndarray) else img
        return t.to(self.device).to(torch.float32)

    @staticmethod
    def _validate(left, right, batched: bool):
        want = 3 if batched else 2
        if left.ndim not in (want, want + 1):
            raise ValueError(
                f"expected {'(B, H, W[, 3])' if batched else '(H, W[, 3])'} "
                f"images, got shape {tuple(left.shape)}"
            )
        if left.shape != right.shape:
            raise ValueError(
                f"left/right shape mismatch: {tuple(left.shape)} vs {tuple(right.shape)}"
            )

    def __call__(self, left, right) -> torch.Tensor:
        with span("pipeline.call"):
            with span("pipeline.input"):
                self._validate(left, right, batched=False)
                left, right = self._as_input(left), self._as_input(right)
            return match_pair(left, right, self.cfg)

    def batch(self, lefts, rights) -> torch.Tensor:
        with span("pipeline.call"):
            with span("pipeline.input"):
                self._validate(lefts, rights, batched=True)
                lefts, rights = self._as_input(lefts), self._as_input(rights)
            return match_batch(lefts, rights, self.cfg)
