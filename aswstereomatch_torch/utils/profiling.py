"""Where a pair's time goes on the card: host latency, device busy time by
kernel, device idle share and peak memory for the main path.

    python -m aswstereomatch_torch.utils.profiling
        [--geometry middlebury kitti kitti_sep kitti_seplo kitti_lo kitti_box
                    kitti_dlanes kitti_sgm] [--pairs 3] [--out DIR]

For each geometry it builds the preset's ``StereoMatcher`` (with the
geometry's overrides) on cuda:0, makes
one synthetic uint8 pair, runs one warm-up call (kernel build, allocator),
then

  - ``latency_ms``: median host wall time of ``--pairs`` calls, each ending
    in ``torch.cuda.synchronize()``, with no profiler running;
  - one ``torch.profiler`` window over ``--pairs`` more calls: the union of
    the device intervals of every CUDA kernel and copy (``busy_ms``), the
    host wall of the same calls inside that window (``window_ms``), and
    ``idle_share = 1 - busy_ms / window_ms`` (both from that one window);
  - device time per kernel name, largest first, per pair;
  - ``peak_alloc_mib``: ``torch.cuda.max_memory_allocated`` over a call.

Prints the card's name and power limit (nvidia-smi), then one JSON object
per geometry; with ``--out``, also writes the profiler's ``key_averages``
table there.  Needs a CUDA device.

The CLI's helpers live here too: ``force_sync`` (wait for the card),
``trace`` (a ``torch.profiler`` Chrome trace) and ``time_fn``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..models.pipeline import StereoMatcher
from . import synthetic

# geometry -> (preset, overrides, height, width); D comes from the preset
GEOMETRIES = {
    "middlebury": ("middlebury_asw_full", {}, 375, 450),
    "kitti": ("kitti_tiled", {}, 375, 1242),
    "kitti_sep": ("kitti_sep", {}, 375, 1242),
    "kitti_seplo": ("kitti_seplo", {}, 375, 1242),
    # the d-lanes paths: left-only ASW and box at D > 64 (K3), symmetric
    # ASW pinned to kernel_layout="dlanes" (K4)
    "kitti_lo": ("kitti_tiled", {"asw_symmetric": False}, 375, 1242),
    "kitti_box": ("kitti_tiled", {"aggregation": "box"}, 375, 1242),
    "kitti_dlanes": ("kitti_tiled", {"kernel_layout": "dlanes"}, 375, 1242),
    # semi-global aggregation: the raw cost volume, then the SGM scan kernel
    "kitti_sgm": ("kitti_sgm", {}, 375, 1242),
}


def force_sync(out) -> None:
    """Wait for the card to finish the work behind ``out`` (a tensor, or a
    tuple / list / dict of them); nothing to wait for on the CPU."""
    if isinstance(out, dict):
        out = list(out.values())
    leaves = out if isinstance(out, (tuple, list)) else [out]
    for leaf in leaves:
        if isinstance(leaf, (tuple, list, dict)):
            force_sync(leaf)
        elif isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` window that writes ``trace.json`` (Chrome trace
    format, with the card's kernels when CUDA is available) into
    ``log_dir``; does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2):
    """``(best_s, mean_s, out)``: host wall time of ``fn(*args)``, each call
    ending when the card has finished it (``force_sync``); ``out`` is the
    last call's result."""
    for _ in range(warmup):
        force_sync(fn(*args))
    times = []
    out = None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        force_sync(out)
        times.append(time.perf_counter() - t0)
    return min(times), float(np.mean(times)), out


def _device_intervals(prof) -> list:
    """(start_us, end_us, name) of every event that ran on the card."""
    return [
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]


def _union_us(intervals) -> float:
    total, cur_start, cur_end = 0.0, None, None
    for start, end, _ in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def profile_geometry(name: str, pairs: int, out: Path | None) -> dict:
    preset, overrides, h, w = GEOMETRIES[name]
    matcher = StereoMatcher.from_preset(preset, device="cuda", **overrides)
    D = matcher.cfg.max_disparity
    p = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=41)
    left, right = p["left"].astype(np.uint8), p["right"].astype(np.uint8)

    def call():
        matcher(left, right)
        torch.cuda.synchronize()

    call()  # warm-up: kernel build and allocator
    walls = []
    for _ in range(pairs):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    call()
    peak = torch.cuda.max_memory_allocated() / 2**20

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(pairs):
            call()
        window_ms = (time.perf_counter() - t0) * 1e3
    intervals = _device_intervals(prof)
    if not intervals:
        raise RuntimeError("the profiler recorded no device events")
    by_name: dict = {}
    for start, end, kname in intervals:
        by_name[kname] = by_name.get(kname, 0.0) + (end - start) / 1e3 / pairs
    busy_ms = _union_us(intervals) / 1e3
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"profile_{name}.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "geometry": f"{w}x{h}", "preset": preset, "overrides": overrides,
        "max_disparity": D,
        "pairs": pairs,
        "latency_ms": float(np.median(walls)),
        "window_ms_per_pair": window_ms / pairs,
        "busy_ms_per_pair": busy_ms / pairs,
        "idle_share": 1.0 - busy_ms / window_ms,
        "peak_alloc_mib": peak,
        "device_ms_per_pair": {k: v for k, v in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometry", nargs="+", default=sorted(GEOMETRIES),
                    choices=sorted(GEOMETRIES))
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for name in args.geometry:
        print(json.dumps(profile_geometry(name, args.pairs, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
