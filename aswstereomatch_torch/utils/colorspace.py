"""Color-space conversions on torch tensors.

The torch twin of ``aswstereomatch_tpu.utils.colorspace``, whose ``xp``-generic
code cannot take torch tensors (it calls ``.astype``).  Same arithmetic, op
for op, so on the CPU every function here is bit-equal to the reference's
NumPy path (tests/test_torch_stages.py):
  - sRGB gamma decode is the 256-entry float64-precomputed LUT (inputs are
    rounded half-to-even to the 8-bit grid first);
  - the CIE cube root is an exponent-bit-hack seed + 4 Newton iterations,
    only IEEE mul/add/div — no ``pow``, whose f32 result differs between
    libraries by enough to flip near-tie WTA winners;
  - the XYZ matrix product is written as explicit mul/adds, never a matmul.

Division by a constant divides by a 0-dim tensor on the input's device:
PyTorch's CUDA division by a Python scalar multiplies by the reciprocal,
which is not the IEEE quotient the reference computes.

Pinned conventions (see config.py):
  - input RGB is float32 in [0, 255] on the 8-bit integer grid
  - grayscale is Rec.601 (matches cv2 RGB2GRAY)
  - Lab is CIE L*a*b* with D65 white and sRGB gamma; L in [0, 100]
"""

from __future__ import annotations

import numpy as np
import torch

# D65 reference white (2 degree observer), sRGB primaries.
_SRGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_WHITE_D65 = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)

# f32 constants, each evaluated exactly as the reference's NumPy expression.
_INV_WHITE_X = float(np.float32(1.0 / _WHITE_D65[0]))
_INV_WHITE_Z = float(np.float32(1.0 / _WHITE_D65[2]))
_THIRD = float(np.float32(1.0 / 3.0))
_DELTA = 6.0 / 29.0
_CUBE = float(np.float32(_DELTA**3))
_LIN_DIV = float(np.float32(3.0 * _DELTA**2))
_LIN_ADD = float(np.float32(4.0 / 29.0))
_CBRT_MAGIC = 0x2A514067


def _make_srgb_lut() -> np.ndarray:
    """256-entry sRGB electro-optical transfer LUT, computed in float64."""
    c = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


SRGB_DECODE_LUT = _make_srgb_lut()


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma on [0,255] RGB -> [0,255] gray.  rgb: (..., 3)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b).to(torch.float32)


def cbrt_newton(t: torch.Tensor) -> torch.Tensor:
    """Cube root for t >= 0 via exponent-bit seed + 4 Newton steps."""
    t = t.to(torch.float32)
    # int32 floor division equals NumPy's for the non-negative bit patterns
    # of t >= 0; the seed for t < 0 is garbage and masked below.
    seed_bits = t.view(torch.int32) // 3 + _CBRT_MAGIC
    y = seed_bits.view(torch.float32)
    for _ in range(4):
        y = (2.0 * y + t / (y * y)) * _THIRD
    # Exact at t == 0 (seed path would give garbage only for t < 0).
    return torch.where(t > 0, y, torch.zeros_like(y))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    """CIE Lab forward nonlinearity: cbrt above (6/29)^3, linear below."""
    lin = t / torch.tensor(_LIN_DIV, dtype=torch.float32, device=t.device)
    lin = lin + _LIN_ADD
    return torch.where(t > _CUBE, cbrt_newton(t), lin)


def srgb_decode(rgb255: torch.Tensor) -> torch.Tensor:
    """[0,255] 8-bit-grid RGB -> linear RGB in [0,1] via the pinned LUT."""
    idx = torch.clamp(torch.round(rgb255), 0, 255).to(torch.int64)
    return torch.from_numpy(SRGB_DECODE_LUT).to(rgb255.device)[idx]


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,255] (..., 3) -> CIELab (L in [0,100]), (..., 3) float32."""
    lin = srgb_decode(rgb)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _SRGB_TO_XYZ.tolist()
    x = (r * m[0][0] + g * m[0][1] + b * m[0][2]) * _INV_WHITE_X
    y = r * m[1][0] + g * m[1][1] + b * m[1][2]
    z = (r * m[2][0] + g * m[2][1] + b * m[2][2]) * _INV_WHITE_Z
    fx = _lab_f(x)
    fy = _lab_f(y)
    fz = _lab_f(z)
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L, a, bb], dim=-1).to(torch.float32)
