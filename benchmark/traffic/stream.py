"""Runner of the "stream" traffic kind: one caller in the benchmark's own
process, closed loop, one pair in flight.

Set-up builds the configuration's ``StereoMatcher`` on the card and sends
``warmup`` pairs through it (the first builds or loads the kernels).  In the
window the caller hands in the pool's uint8 (H, W, 3) numpy pairs in turn,
calls ``StereoMatcher.__call__`` and fetches each disparity map to host
memory before it sends the next pair.  A pair's latency runs from the call
to the map in host memory; ``call_s`` is the call alone, until it returned
(the host's enqueue, with whatever waits on the card inside it).

Mix file keys: ``kind`` ("stream"), ``pool`` (pairs made from the seed) and
``warmup`` (pairs sent before the window).
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from .. import correctness, tracing
from ..harness import Observed, Request


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run(ctx) -> Observed:
    from aswstereomatch_torch.config import StereoConfig, get_preset
    from aswstereomatch_torch.models.pipeline import StereoMatcher

    conf = ctx.config
    cfg = StereoConfig(**conf["stereo_config"])
    if cfg != get_preset(conf["preset"]).replace(**conf["overrides"]):
        raise ValueError(f"{conf['name']}: stereo_config is not its preset with its overrides")
    device = torch.device(ctx.device)
    on_card = device.type == "cuda"
    matcher = StereoMatcher(cfg, device=device)
    pool = ctx.pool
    first = pool[0]
    for j in range(ctx.traffic["warmup"]):  # the first builds or loads the kernels
        matcher(pool[j % len(pool)]["left"], pool[j % len(pool)]["right"]).cpu()
    if ctx.trace:  # the profiler's own first start stays out of the window
        with _profiler():
            matcher(first["left"], first["right"]).cpu()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    sample = correctness.Sample(ctx.seed)
    draw = sample.drawer(0)
    requests = []
    # Spans of the harness's own steps name the device's idle gaps.
    mark = torch.profiler.record_function if ctx.trace else (lambda name: contextlib.nullcontext())
    prof = _profiler() if ctx.trace else contextlib.nullcontext()
    with prof:
        with mark(tracing.WINDOW_SPAN):
            start = time.perf_counter()
            end = start + ctx.seconds
            i = 0
            while True:
                t0 = time.perf_counter()
                if t0 >= end:
                    break
                key = i % len(pool)
                with mark("bench.call"):
                    out = matcher(pool[key]["left"], pool[key]["right"])
                t_call = time.perf_counter()
                with mark("bench.fetch"):
                    host = out.cpu().numpy()
                t1 = time.perf_counter()
                requests.append(Request(key, t0, t1, call_s=t_call - t0))
                if draw():
                    sample.keep(requests[-1], host)
                i += 1
            window_s = time.perf_counter() - start
    trace = tracing.from_profiler(prof, window_s) if ctx.trace else None
    obs = Observed(
        requests=requests, window_start=start, window_s=window_s, sample=sample,
        answer_form="float32",
        memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)) if on_card else 0,
        trace=trace)
    del matcher, out, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return obs
