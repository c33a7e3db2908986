"""The headline rate with its decomposition: device time against dispatch.

The counterpart of the repository's ``tools/headline_variance.py``, for
``kitti_sep`` (1242x375 D=128, ``synthetic.make_dataset_pair("kitti",
seed=0)``, the pair the CLI's ``--synthetic kitti`` makes):

1. **Device-time rate.**  ``--chain`` + 1 pairs run back to back in this
   process, each left input carrying an epsilon, always zero, taken from
   the previous pair's output (so each pair depends on the one before, as
   the reference's chained loop does).  One chain runs under
   ``torch.profiler``: the union of the card's busy intervals over the
   chain, per pair, is ``device_s_per_pair``.  ``--reps`` more chains are
   timed without the profiler by CUDA events (``dispatch_times_s``: the
   wall of a chain, host dispatch included).
2. **Session sweep.**  ``--sessions`` fresh processes of the port's CLI
   (``python -m aswstereomatch_torch.cli --synthetic kitti --preset
   kitti_sep --iters 20 --json ...``), each reading ``best_s`` / ``mean_s``
   from the CLI's record: each session pays the process start, the CUDA
   context and the library load in ``compile_s``, and its ``mean_s`` is a
   synchronised call's time.  The sessions run without the device lock, as
   the reference's do; the CLI takes none.
3. ``dispatch_overhead_s_per_pair`` = the sessions' median ``mean_s`` -
   ``device_s_per_pair``: the host's share of a synchronised pair.

The CLI times synchronised calls only, so the reference's queued fields
are null here.  The record goes to ``results_torch/headline_variance.json``.

    python -m aswstereomatch_torch.tools.headline_variance [--sessions 5] [--chain 19]
    python -m aswstereomatch_torch.tools.headline_variance --device cpu --dataset tsukuba \\
        --radius 2 --max-disparity 8 --chain 1 --sessions 2 --iters 2
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import get_preset
from ..models import pipeline
from ..utils import profiling, synthetic
from . import common

PRESET = "kitti_sep"


def _config(max_disparity=None, radius=None):
    over = {}
    if max_disparity is not None:
        over["max_disparity"] = max_disparity
    if radius is not None:
        over["window_radius"] = radius
    return get_preset(PRESET).replace(**over)


def _chain(left, right, cfg, chain: int):
    """``chain`` + 1 pairs, each left input offset by an epsilon (zero at run
    time) from the previous pair's output; the last pair's map."""
    l = left
    for _ in range(chain):
        disp = pipeline.match_pair(l, right, cfg)
        eps = torch.where(disp[0, 0] > 1e30, 1e-6, 0.0).to(left.dtype)
        l = left + eps
    return pipeline.match_pair(l, right, cfg)


def device_time_rate(device, chain: int, dataset: str = "kitti", max_disparity=None,
                     radius=None, reps: int = 3) -> dict:
    """The chain's device busy time per pair (profiler) and its wall per pair."""
    device = torch.device(device)
    cfg = _config(max_disparity, radius)
    pair = synthetic.make_dataset_pair(dataset, seed=0)
    l, r = common.to_device(pair, device)
    t0 = time.perf_counter()
    profiling.force_sync(_chain(l, r, cfg, chain))
    first_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        profiling.force_sync(_chain(l, r, cfg, chain))
        window_s = time.perf_counter() - t0
    intervals = profiling._device_intervals(prof)
    busy_s = profiling._union_us(intervals) / 1e6 if intervals else None
    if device.type == "cuda" and busy_s is None:
        raise RuntimeError("the profiler recorded no device events")
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            _chain(l, r, cfg, chain)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            _chain(l, r, cfg, chain)
            times.append(time.perf_counter() - t0)
    n = chain + 1
    dev_s = busy_s / n if busy_s is not None else None
    return {
        "chain": n,
        "reps": reps,
        "dispatch_times_s": times,
        "wall_s_per_pair": min(times) / n,
        # busy time of the card, None where nothing ran on one
        "device_s_per_pair": dev_s,
        "device_pairs_per_s": 1.0 / dev_s if dev_s else None,
        "profiled_window_s_per_pair": window_s / n,
        "device_busy_share_of_wall": dev_s * n / min(times) if dev_s else None,
        "compile_source": "build.load" if device.type == "cuda" else "none (CPU)",
        "compile_or_load_s": first_s,
        "config_hash": cfg.config_hash(),
    }


def session_sweep(device, n: int, dataset: str = "kitti", max_disparity=None, radius=None,
                  iters: int = 20, timeout_s: float = 600.0, progress=print) -> list:
    """``n`` fresh CLI processes; each one's times from its record."""
    rows = []
    with tempfile.TemporaryDirectory(prefix="headline_variance_") as tmp:
        for i in range(n):
            path = os.path.join(tmp, f"session{i}.json")
            cmd = [sys.executable, "-m", "aswstereomatch_torch.cli", "--synthetic", dataset,
                   "--preset", PRESET, "--iters", str(iters), "--json", path,
                   "--device", torch.device(device).type]
            if max_disparity is not None:
                cmd += ["--max-disparity", str(max_disparity)]
            if radius is not None:
                cmd += ["--window-radius", str(radius)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                                  env=common.child_env(), cwd=str(common.REPO))
            process_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"CLI session {i} exited {proc.returncode}:\n"
                                   + proc.stderr[-4000:])
            with open(path) as f:
                rec = json.load(f)
            row = {"session": i, "value": rec["pairs_per_s"], "stale": False,
                   "queued_s": None, "best_s": rec["best_s"], "mean_s": rec["mean_s"],
                   "compile_s": rec["compile_s"], "compile_source": "build.load",
                   "process_s": round(process_s, 3), "device": rec["device"]}
            rows.append(row)
            progress(f"session {i}: {row}")
    return rows


def run(device, sessions: int = 5, chain: int = 19, dataset: str = "kitti",
        max_disparity=None, radius=None, iters: int = 20, lock: bool = False,
        progress=print) -> dict:
    """Both measurements; with ``lock``, the device-time part holds the
    device lock on the card (the sessions never do)."""
    device = torch.device(device)
    measure = lambda: device_time_rate(device, chain, dataset, max_disparity, radius)  # noqa: E731
    dev = common.run_main("headline_variance", device, measure) if lock else measure()
    progress(f"device-time rate: {dev['device_pairs_per_s']} pairs/s (device "
             f"{dev['device_s_per_pair']} s/pair; chain wall {dev['wall_s_per_pair']:.6f} "
             f"s/pair)")
    rows = session_sweep(device, sessions, dataset, max_disparity, radius, iters,
                         progress=progress)
    means = sorted(r["mean_s"] for r in rows)
    med = float(np.median(means))
    dev_s = dev["device_s_per_pair"]
    return {
        "preset": PRESET,
        "dataset": dataset,
        "device_time": dev,
        "sessions": rows,
        "median_queued_s": None,
        "median_queued_pairs_per_s": None,
        "queued_spread_s": None,
        "median_mean_s": med,
        "median_mean_pairs_per_s": 1.0 / med,
        "mean_spread_s": [means[0], means[-1]],
        "median_best_s": float(np.median([r["best_s"] for r in rows])),
        "dispatch_overhead_s_per_pair": med - dev_s if dev_s is not None else None,
        "note": "device_s_per_pair: the card's busy time over a chain of serial pairs, per "
                "pair (profiler); mean_s / best_s: fresh CLI processes, synchronised calls "
                "(the CLI queues none, so the queued fields are null); "
                "dispatch_overhead = median mean_s - device_s_per_pair",
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("headline_variance", __doc__)
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--chain", type=int, default=19)
    ap.add_argument("--iters", type=int, default=20, help="timed calls per CLI session")
    ap.add_argument("--dataset", default="kitti",
                    help="the synthetic scene geometry (the CLI's --synthetic)")
    ap.add_argument("--max-disparity", type=int, help="in place of the preset's 128")
    ap.add_argument("--radius", type=int, help="in place of the preset's 16")
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = run(device, args.sessions, args.chain, args.dataset, args.max_disparity,
              args.radius, args.iters, lock=True)
    common.write_record(args.out, rec)
    print(json.dumps({k: rec[k] for k in ("median_mean_pairs_per_s",
                                          "dispatch_overhead_s_per_pair")}))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
