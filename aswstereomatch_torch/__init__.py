"""aswstereomatch_torch — the stereo-matching engine in PyTorch and CUDA.

The port of ``aswstereomatch_tpu`` (the JAX/Pallas reference, which stays
beside it) to one NVIDIA H100: Yoon-Kweon adaptive-support-weight
matching (exact or separable) and box matching through hand-written CUDA
kernels (ops/cuda), with plain PyTorch stages around them.  Imports torch and numpy, never jax.
"""

import torch

# Near-tie WTA winners flip on TF32's ~1e-3 relative error: keep f32 exact.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import PRESETS, StereoConfig, get_preset  # noqa: E402,F401
from .models.pipeline import StereoMatcher, match_batch, match_pair  # noqa: E402,F401

__version__ = "0.1.0"
