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

# PyTorch's CPU sqrt, exp and log call MKL's vector math.  When the first
# such call in a process runs on several threads at once, one thread's share
# of it can come out ~1e-4 off (relative), so the eager path and the plain
# kernel versions would not repeat their own bits (tests/test_torch_cpu_math.py).
# One call on one thread first initialises it.
torch.ones(1).sqrt()

from .config import PRESETS, StereoConfig, get_preset  # noqa: E402,F401
from .models.pipeline import StereoMatcher, match_batch, match_pair  # noqa: E402,F401

__version__ = "0.1.0"
