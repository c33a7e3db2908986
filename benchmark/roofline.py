"""The least time the card could take for a kernel's function: the published
peaks of one H100 SXM and the operations and bytes each function needs.

Copied from ``chip_smoke.py`` (``FP32_FLOPS``, ``MUFU_OPS``, ``HBM_BYTES``,
``_bound``, ``k1_bound``, ``k2_bound``, ``box_bound``, ``sgm_bound``), so that
a change to the program cannot move the yardstick.  Each bound counts the
function's work from its shapes, not what a kernel does: a kernel that
replaces another is read against the same work.  ``cfg`` is any object with
the configuration's fields as attributes.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, the dense rates at
# the 700 W limit): FP32 outside the tensor cores, HBM3.  The special
# function units (exp2, rsqrt) return 16 results per clock per SM against
# 128 FP32 lanes doing 2 flops (an FMA) each: 1/16 of the FP32 flop rate.
FP32_FLOPS = 67e12
MUFU_OPS = FP32_FLOPS / 16
HBM_BYTES = 3.35e12


def _bound(flops: float, mufu: float, nbytes: float) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operation
    time (FP32 flops and special-function ops at their peaks) and the byte
    time over the memory rate."""
    ops_s = max(flops / FP32_FLOPS, mufu / MUFU_OPS)
    bytes_s = nbytes / HBM_BYTES
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes")


def k1_bound(H: int, W: int, cfg) -> tuple:
    """K1's function (exact ASW) at its least work.  Per (pixel, d, tap):
    the weight product, the num FMA and the den add in symmetric mode (4
    flops); in left-only mode only the num FMA, since den does not depend
    on d (one add per (pixel, tap)).  Each distinct weight once, an expf +
    sqrtf and ~10 flops: the left one per (pixel, tap), the right one per
    (right column x - d, tap).  Each distinct raw cost once, ~12 flops per
    (row, extended column, d).  Bytes: the two stacks in, six (H, W)
    planes out."""
    assert cfg.aggregation == "asw", "the bound counts ASW work"
    r, D = cfg.window_radius, cfg.max_disparity
    K = 2 * r + 1
    sym = cfg.asw_symmetric
    taps = H * W * D * K * K
    weights = H * K * K * (W + ((W + D - 1) if sym else 0))
    flops = (4 * taps if sym else 2 * taps + H * W * K * K)
    flops += 10 * weights + 12 * H * (W + 2 * r) * D
    nbytes = 4 * (7 * H * (W + 2 * r) + 7 * H * (W + 2 * r + D - 1) + 6 * H * W)
    return _bound(flops, 2.0 * weights, nbytes)


def k2_bound(H: int, W: int, cfg) -> tuple:
    """K2's function (separable ASW) at its least work.  Symmetric mode:
    per vertical tap (H*(W+2r)*D*K) the weight product, num FMA and den add
    (4 flops), per horizontal tap (H*W*D*K) the weight product and two FMAs
    (5 flops).  Left-only mode: one num FMA per tap, den once per (column,
    tap), as it does not depend on d.  Each entry of the 1-D weight planes
    once (an expf + sqrtf and ~10 flops); each raw cost once, ~12 flops per
    (row, extended column, d).  Bytes: the stacks in, six (H, W) planes out
    (the kernel's weight-plane scratch is not the function's)."""
    r, D = cfg.window_radius, cfg.max_disparity
    K = 2 * r + 1
    sym = cfg.asw_symmetric
    WL, WR = W + 2 * r, W + 2 * r + D - 1
    vtaps, htaps = H * WL * D * K, H * W * D * K
    entries = H * K * (WL + W + ((WR + W + D - 1) if sym else 0))
    flops = (4 * vtaps + 5 * htaps if sym
             else 2 * (vtaps + htaps) + H * K * (WL + 2 * W))
    flops += 10 * entries + 12 * H * WL * D
    nbytes = 4 * (7 * H * (WL + WR) + 6 * H * W)
    return _bound(flops, 2.0 * entries, nbytes)


def box_bound(H: int, W: int, cfg) -> tuple:
    """The box function at its least work: separable running sums, ~4
    flops per (pixel, d) (an add and a subtract along each axis), and each
    raw cost once, ~12 flops per (row, extended column, d); not the K^2
    taps per (pixel, d) of a direct window sum.  Bytes: the two stacks in,
    six (H, W) planes out."""
    assert cfg.aggregation == "box", "the bound counts box work"
    r, D = cfg.window_radius, cfg.max_disparity
    flops = 4 * H * W * D + 12 * H * (W + 2 * r) * D
    nbytes = 4 * (7 * H * (W + 2 * r) + 7 * H * (W + 2 * r + D - 1) + 6 * H * W)
    return _bound(flops, 0.0, nbytes)


def sgm_bound(H: int, W: int, cfg) -> tuple:
    """SGM's function at its least work: bytes, one read of the raw (H, W,
    D) cost volume and one write of S, 2 x 4 H W D (the kernel's one pass
    per direction moves 3 P - 1 volumes for P paths).  Operations: per
    (pixel, d, path) two adds of a penalty, three mins, the add and the
    subtract of the step and the add into S, 8 FP32 operations."""
    assert cfg.aggregation == "sgm", "the bound counts SGM work"
    n = H * W * cfg.max_disparity
    return _bound(8.0 * n * cfg.sgm_paths, 0.0, 2 * 4 * n)
