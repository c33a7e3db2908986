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
  - ``peak_alloc_mib``: ``torch.cuda.max_memory_allocated`` over a call;
  - ``stage_host_ms_per_pair``: host time per pair inside each stage span
    of the profiler window (a stage's total, nested stages included);
  - ``span_clock_us``: ``span_clock_error_us`` of that window.

Prints the card's name and power limit (nvidia-smi), then one JSON object
per geometry; with ``--out``, also writes the profiler's ``key_averages``
table there.  Needs a CUDA device.

The CLI's helpers live here too: ``force_sync`` (wait for the card),
``trace`` (a ``torch.profiler`` Chrome trace) and ``time_fn``.

So do the pipeline's stage spans.  ``span(name)`` marks a stage: while a
``torch.profiler`` records on the calling thread it enters a
``record_function`` of that name (so the stage shows in the profiler's
timeline and Chrome trace) and logs one ``SpanRecord`` with the host's
``time.time_ns()`` at its start and end, the clock the profiler stamps its
events with, the card's included; otherwise it does nothing.  The pipeline
opens five: ``pipeline.call`` around each ``StereoMatcher`` request, and
inside it ``pipeline.input`` (the input's copy and widening),
``pipeline.aggregate`` (the kernel wrapper or the eager volume),
``pipeline.preprocess`` (the kernels' channel stacks, inside
``pipeline.aggregate``) and ``pipeline.postprocess``.  SGM's aggregation
opens two more inside ``pipeline.aggregate``: ``pipeline.cost`` (the raw
cost volume) and then ``pipeline.sgm`` (the scan).  The eager route, SGM's
included, ends ``pipeline.aggregate`` with ``pipeline.wta``: the WTA planes
of its volume (``ops/wta.py::planes``).  ``spans()`` returns
the log, which keeps the last ``SPAN_LOG_RECORDS`` records;
``clear_spans()`` empties it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

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


ROOT_SPAN = "pipeline.call"
SPAN_LOG_RECORDS = 1 << 18  # a 30 s traced window of the fastest preset logs ~10k


class SpanRecord(NamedTuple):
    """One span: ``request`` is the id its outermost ``pipeline.call`` drew
    (None outside any), ``parent`` the enclosing span's name on the same
    thread, ``thread`` that thread's ``threading.get_ident()``; the times
    are ``time.time_ns()`` just inside the span's ``record_function``."""

    request: Optional[int]
    name: str
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_RECORDS)
_REQUESTS = itertools.count()
_OPEN = threading.local()  # .stack: (name, request) of the thread's open spans
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_record", "_parent", "_request", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self._parent, self._request = stack[-1] if stack else (None, None)
        if self._request is None and self.name == ROOT_SPAN:
            self._request = next(_REQUESTS)
        stack.append((self.name, self._request))
        self._record = torch.profiler.record_function(self.name)
        self._record.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._record.__exit__(*exc)
        _OPEN.stack.pop()
        _LOG.append(SpanRecord(self._request, self.name, self._parent,
                               threading.get_ident(), self._start, end))
        return False


def span(name: str):
    """A context that marks a pipeline stage while a ``torch.profiler``
    records on this thread, and one shared no-op context otherwise (one
    flag check; nothing recorded, nothing allocated)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def spans() -> list:
    """A copy of the span log, oldest first."""
    return list(_LOG)


def clear_spans() -> None:
    _LOG.clear()


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
    """(start_us, end_us, name) of every event that ran on the card; not the
    card-side copies of the host's ``record_function`` spans, which cover
    the device work they enqueued and idle time alike."""
    return [
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
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


def span_clock_error_us(prof, records) -> float | None:
    """The farthest, in microseconds, that a logged span's start or end
    lies outside the profiler's own host event of the same name (0 when
    every span lies inside its event): whether the spans share the
    profiler's clock.  The k-th span of a name is held to the k-th host
    event of that name, so ``records`` are those of ``prof``'s window; None
    without records."""
    if not records:
        return None
    names = {r.name for r in records}
    events: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    worst = 0
    for name in names:
        mine = sorted((r.start_ns, r.end_ns) for r in records if r.name == name)
        theirs = sorted(events.get(name, []))
        if len(mine) != len(theirs):
            raise ValueError(f"{len(mine)} {name} spans against {len(theirs)} profiler events")
        for (s, e), (s0, e0) in zip(mine, theirs):
            worst = max(worst, s0 - s, e - e0)
    return worst / 1e3


def profile_geometry(name: str, pairs: int, out: Path | None) -> dict:
    from ..models.pipeline import StereoMatcher

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
    clear_spans()
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
    records = spans()
    stage_ms: dict = {}
    for r in records:
        stage_ms[r.name] = stage_ms.get(r.name, 0.0) + (r.end_ns - r.start_ns) / 1e6 / pairs
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
        "stage_host_ms_per_pair": stage_ms,
        "span_clock_us": span_clock_error_us(prof, records),
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
    # The package's own module, whose span log the pipeline writes to.
    from aswstereomatch_torch.utils import profiling

    raise SystemExit(profiling.main())
