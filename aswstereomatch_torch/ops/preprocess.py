"""Preprocess stage in PyTorch: grayscale, x-gradient, CIELab, channel stack.

Counterpart of ``aswstereomatch_tpu.ops.preprocess``; conversions come from
``utils.colorspace``.
"""

from __future__ import annotations

import torch

from ..utils import colorspace


def pad_edge(arr: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """Edge-replicate padding along one dimension (``np.pad(mode="edge")``)."""
    n = arr.shape[dim]
    idx = torch.arange(-before, n + after, device=arr.device).clamp_(0, n - 1)
    return arr.index_select(dim, idx)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    if img.ndim == 2:
        return img.to(torch.float32)
    return colorspace.rgb_to_gray(img)


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    if img.ndim == 2:
        img = torch.stack([img] * 3, dim=-1)
    return colorspace.rgb_to_lab(img)


def x_gradient(gray: torch.Tensor) -> torch.Tensor:
    """Central difference g(x) = I(x+1) - I(x-1), replicate border."""
    pad = pad_edge(gray, 1, 1, 1)
    return (pad[:, 2:] - pad[:, :-2]).to(torch.float32)


def channel_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W[,3]) image -> (7, H, W): RGB, x-gradient, Lab.

    All channels are pointwise except the gradient, so the stack is computed
    over the whole image and then edge-padded or sliced."""
    if img.ndim == 2:
        rgb = torch.stack([img] * 3, dim=0).to(torch.float32)
    else:
        rgb = torch.movedim(img.to(torch.float32), -1, 0)
    grad = x_gradient(rgb_to_gray(img))[None]
    lab = torch.movedim(rgb_to_lab(img), -1, 0)
    return torch.cat([rgb, grad, lab], dim=0)
