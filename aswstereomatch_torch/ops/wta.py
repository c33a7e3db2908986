"""Winner-take-all disparity selection + subpixel refinement in PyTorch.

Counterpart of ``aswstereomatch_tpu.ops.wta``.  Per the pinned spec
(config.py): first-occurrence argmin over d (``torch.argmin`` returns the
first minimum); parabola subpixel ``d* = d - (C+ - C-) / (2 (C+ - 2 C0 + C-))``
with the offset clamped to [-0.5, 0.5], applied only for 0 < d < D-1 and
|denom| > 1e-6.
"""

from __future__ import annotations

import torch

from . import postprocess


def _take(vol: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vol[..., idx]`` for an int64 index plane."""
    return torch.gather(vol, -1, idx[..., None])[..., 0]


def wta(vol: torch.Tensor) -> torch.Tensor:
    """(H, W, D) -> int32 (H, W) argmin (first minimum wins)."""
    return torch.argmin(vol, dim=-1).to(torch.int32)


def wta_with_triple(vol: torch.Tensor) -> dict:
    """Argmin plus the (C[d*-1], C[d*], C[d*+1]) parabola triple; cm/cp at
    the d-range edges are clamped reads (masked later by the subpixel
    guard).  The winner is cast to int64 once for the three gathers."""
    D = vol.shape[-1]
    d = wta(vol)
    i = d.to(torch.int64)
    return {
        "bestd": d,
        "bestc": _take(vol, i),
        "cm": _take(vol, torch.clamp(i - 1, 0, D - 1)),
        "cp": _take(vol, torch.clamp(i + 1, 0, D - 1)),
    }


def planes(vol: torch.Tensor, *, rbestd: bool = True, ubest: bool = True) -> dict:
    """The WTA planes of an (H, W, D) aggregated volume, the form the
    kernels return and the post-process reads: the argmin and its
    (cm, bestc, cp) triple always; ``rbestd``, the right view's argmin by
    volume reuse, and ``ubest``, the second best outside the winner's
    +-1, when asked for.  The kernels' plain versions ask for all six, the
    eager route for what its config reads."""
    out = wta_with_triple(vol)
    if rbestd:
        out["rbestd"] = wta(postprocess.right_volume(vol))
    if ubest:
        out["ubest"] = second_best_excl_neighbors(vol, out["bestd"])
    return out


def subpixel_from_triple(
    disp: torch.Tensor,
    c0: torch.Tensor,
    cm: torch.Tensor,
    cp: torch.Tensor,
    max_disparity: int,
) -> torch.Tensor:
    """Parabola refinement from an online-tracked (C[d-1], C[d], C[d+1])
    triple (the fused kernel's output form)."""
    d = disp.to(torch.int32)
    denom = cp - 2.0 * c0 + cm
    off = torch.clamp((cp - cm) / (2.0 * denom), -0.5, 0.5)
    ok = (d > 0) & (d < max_disparity - 1) & (torch.abs(denom) > 1e-6)
    df = d.to(torch.float32)
    return torch.where(ok, df - off, df)


def second_best_excl_neighbors(vol: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Second-best aggregated cost excluding d within +-1 of the winner;
    +inf where every candidate lies within the excluded window (D <= 3)."""
    d_idx = torch.arange(vol.shape[-1], device=vol.device)
    far = torch.abs(d_idx - disp[..., None].to(torch.int64)) > 1
    inf = torch.tensor(float("inf"), dtype=vol.dtype, device=vol.device)
    return torch.amin(torch.where(far, vol, inf), dim=-1)


def uniqueness_valid(
    best: torch.Tensor, second: torch.Tensor, ratio: float
) -> torch.Tensor:
    """cv2-style uniqueness gate: accept iff ``second*100 >= best*(100+ratio)``."""
    return second * 100.0 >= best * (100.0 + ratio)
