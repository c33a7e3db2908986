"""Carry the reference's state across to the port.

The system has no learned weights: a ``StereoConfig`` plus three constant
tables — the (K, K) spatial weights of the ASW window, the (K,) axial weights
of the separable passes and the 256-entry sRGB decode LUT — are its whole
parameter set.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import StereoConfig
from .colorspace import SRGB_DECODE_LUT

# reference backend name -> port backend name
_BACKEND_FROM_REF = {"auto": "auto", "jnp": "eager", "pallas": "cuda"}


def from_reference(ref_fields: dict) -> StereoConfig:
    """Port config from ``dataclasses.asdict`` of a reference StereoConfig
    (``jnp`` becomes ``eager``, ``pallas`` becomes ``cuda``)."""
    fields = dict(ref_fields)
    fields["backend"] = _BACKEND_FROM_REF[fields["backend"]]
    return StereoConfig(**fields)


def spatial_weights_np(cfg: StereoConfig) -> np.ndarray:
    """(K, K) spatial factor exp(-|o|_2 / gamma_p) over the nominal window
    offsets, computed in float64 and stored as float32."""
    r = cfg.window_radius
    wy, wx = np.mgrid[-r : r + 1, -r : r + 1]
    dist = np.sqrt((wy**2 + wx**2).astype(np.float64))
    return np.exp(-dist / cfg.gamma_spatial).astype(np.float32)


def axial_weights_np(cfg: StereoConfig) -> np.ndarray:
    """(K,) spatial factor exp(-|o| / gamma_p) of the separable passes (the
    L1 form), computed in float64 and stored as float32."""
    r = cfg.window_radius
    o = np.abs(np.arange(-r, r + 1)).astype(np.float64)
    return np.exp(-o / cfg.gamma_spatial).astype(np.float32)


def constant_tables(cfg: StereoConfig, device) -> dict:
    """The config's constant tables as float32 tensors on ``device``:
    ``spatial_weights`` (K, K), ``axial_weights`` (K,) and ``srgb_lut``
    (256,)."""
    return {
        "spatial_weights": torch.from_numpy(spatial_weights_np(cfg)).to(device),
        "axial_weights": torch.from_numpy(axial_weights_np(cfg)).to(device),
        "srgb_lut": torch.from_numpy(SRGB_DECODE_LUT).to(device),
    }
