"""Time K1 (``ops/cuda/asw_kernel.cu``) under several tile plans on the card.

    python -m aswstereomatch_torch.utils.plan_sweep [--reps 5]

For each geometry (synthetic pairs at full width) it runs the kernel over
pre-built channel stacks with ``asw_kernel.tile_plan``'s plan and with the
plans of 1, 2, 4, ... rows (up to the default's, and at least 4) that fit,
checks that each plan gives the default plan's six planes bit for bit,
and prints the median ms per call (CUDA events, after one warm-up call).
K4 (``asw_sym_dlanes_kernel``) is timed over the same stacks where it takes
the function (symmetric ASW, D <= 128).  It prints the card's name and
power limit and ptxas' register and spill lines first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from .. import get_preset
from ..ops.cuda import asw_kernel, asw_sym_dlanes_kernel, build, common
from . import synthetic

GEOMETRIES = {
    "middlebury 450x375 D=64": ("middlebury_asw_full", {}, 375, 450),
    "kitti 1242x375 D=128": ("kitti_tiled", {}, 375, 1242),
    "kitti left-only": ("kitti_tiled", dict(asw_symmetric=False, kernel_layout="xlanes"), 375, 1242),
    "kitti box": ("kitti_tiled", dict(aggregation="box", kernel_layout="xlanes"), 375, 1242),
    "tsukuba box 384x288 D=16": ("tsukuba_ad_box", {}, 288, 384),
}


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def plans(H: int, W: int, D: int, r: int, mode: int) -> list:
    """The default plan, then the others of ty in 1, 2, 4, ..."""
    best = asw_kernel.tile_plan(H, W, D, r, mode)
    out = [best]
    ty = 1
    while ty <= max(best.ty, 4):
        p = best._replace(ty=ty, kx=2 * r + 1)
        if p.fits(mode) and p not in out:
            out.append(p)
        ty *= 2
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--geometry", nargs="*", default=list(GEOMETRIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    build.load()
    for ln in build.build_log().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("ptxas:", ln.strip())
    dev = torch.device("cuda", 0)
    for name in args.geometry:
        preset, overrides, H, W = GEOMETRIES[name]
        cfg = get_preset(preset).replace(**overrides)
        D, r = cfg.max_disparity, cfg.window_radius
        p = synthetic.make_pair(height=H, width=W, max_disparity=D, seed=31)
        ls, rs = common.stacks(torch.from_numpy(p["left"]).to(dev),
                               torch.from_numpy(p["right"]).to(dev), cfg)
        mode = asw_kernel._mode(cfg)
        ref = None
        for plan in plans(H, W, D, r, mode):
            out = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, plan)
            if ref is None:
                ref = out
            same = all(torch.equal(out[k], ref[k]) for k in ref)
            ms = median_ms(lambda: asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, plan),
                           args.reps)
            print(f"{name} on {card}: K1 {tuple(plan)} threads {plan.threads()} smem "
                  f"{plan.smem_bytes(mode)} B: {ms:.3f} ms, same bits as the default "
                  f"plan: {same}", flush=True)
            if not same:
                return 1
        if cfg.aggregation == "asw" and cfg.asw_symmetric and D <= 128:
            cfg4 = cfg.replace(kernel_layout="dlanes")
            ms = median_ms(lambda: asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg4),
                           args.reps)
            print(f"{name} on {card}: K4 over the same stacks {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
