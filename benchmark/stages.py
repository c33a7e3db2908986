"""The program's stage spans against a traced window's device trace.

While a profiler records, ``aswstereomatch_torch/utils/profiling.py::span``
logs each pipeline stage with the host's ``time.time_ns()`` at its start
and end: the clock the profiler stamps its events with, so the spans and
the trace's device intervals (``tracing.Trace.device``, microseconds) share
one time line.

The window's requests are the last ``len(obs.requests)`` ``pipeline.call``
roots of the log (the runner's warm-up call under the profiler comes before
them).  ``W`` runs from the first of those roots' start to the last one's
start: ``N - 1`` whole cycles, each from one call's start to the next's.
Every instant of ``W`` at which no device operation runs goes to the
innermost span open at that instant on the roots' thread, and to
``caller`` where none is: the caller's own fetch and loop, outside the
program.  The root's own instants, between its stages, go to
``pipeline.input``: the pipeline's few microseconds of routing between
stages are host work of the same layer.  So the five buckets partition the
idle time of ``W``.  A span of another name, nested inside one of theirs,
takes the idle instants at which it is the innermost, and ``idle_ms``
reads it by its name.

Every reader returns None where the log holds fewer roots than the window
has requests (a daemon's spans live in its own process; a program without
spans logs none).
"""

from __future__ import annotations

import numpy as np

from aswstereomatch_torch.utils import profiling

ROOT = "pipeline.call"
BUCKETS = ("pipeline.input", "pipeline.preprocess", "pipeline.aggregate",
           "pipeline.postprocess", "caller")
OUTSIDE = "caller"

_memo: tuple = (None, None)  # (obs, its reading): each metric file reads once per run


def _log():
    read = getattr(profiling, "spans", None)  # a program without spans has none
    return read() if read is not None else []


def window_roots(obs, records) -> list | None:
    """The window's ``pipeline.call`` roots, oldest first, or None."""
    n = len(obs.requests)
    roots = sorted((r for r in records if r.name == ROOT and r.parent is None),
                   key=lambda r: r.start_ns)
    if n < 2 or len(roots) < n:
        return None
    return roots[-n:]


def innermost(spans) -> list:
    """Nested (start, end, name) spans of one thread as disjoint sorted
    (start, end, name) segments, each named by the innermost span open."""
    segs, stack, t = [], [], None

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, name = stack.pop()
            segs.append((t, end, name))
            t = end

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(start)
        if stack:
            segs.append((t, start, stack[-1][1]))
        stack.append((end, name))
        t = start
    close_until(float("inf"))
    return [s for s in segs if s[1] > s[0]]


def idle_by_span(device, spans, w0: float, w1: float) -> dict:
    """Idle time of [w0, w1] (ns) by the innermost span open, ``OUTSIDE``
    where none is: every bucket, and every span name of ``spans`` that
    meets the window, idle or not.  ``device``: (start_ns, end_ns)
    intervals; ``spans``: (start_ns, end_ns, name) of one thread, nested."""
    busy = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    segs = [(max(s, w0), min(e, w1), n) for s, e, n in innermost(spans) if e > w0 and s < w1]
    out = dict.fromkeys(BUCKETS, 0.0)
    out.update((name, 0.0) for s, e, name in spans if e > w0 and s < w1 and name not in out)
    j = 0
    for a, b in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name] += part
                covered += part
            k += 1
        out[OUTSIDE] += (b - a) - covered
    return out


def _reading(obs):
    """(idle ns by bucket over W, N - 1) or None."""
    global _memo
    if _memo[0] is obs:
        return _memo[1]
    reading = None
    records = _log()
    roots = window_roots(obs, records)
    if obs.trace is not None and roots is not None:
        thread = roots[-1].thread
        # Times relative to the first root, so float64 keeps every nanosecond
        # (the device's start_ns / 1e3 already rounds to ~0.25 us).
        o = roots[0].start_ns
        o_us, o_ns = divmod(o, 1000)
        device = [((s - o_us) * 1e3 - o_ns, (e - o_us) * 1e3 - o_ns)
                  for s, e, _ in obs.trace.device]
        spans = [(r.start_ns - o, r.end_ns - o, r.name) for r in records if r.thread == thread]
        idle = idle_by_span(device, spans, 0, roots[-1].start_ns - o)
        idle["pipeline.input"] += idle.pop(ROOT, 0.0)
        reading = (idle, len(roots) - 1)
    _memo = (obs, reading)
    return reading


def idle_ms(obs, bucket: str):
    """Device idle per cycle, in ms, while ``bucket`` is the innermost span:
    one of ``BUCKETS``, or any span name, which reads 0.0 where the window
    holds such a span that saw no idle time and None where it holds none."""
    reading = _reading(obs)
    if reading is None or bucket not in reading[0]:
        return None
    idle, cycles = reading
    return idle[bucket] / cycles / 1e6


def host_ms_p50(obs, name: str):
    """Median over the window's requests of each request's summed host time
    in spans named ``name``, in ms."""
    records = _log()
    roots = window_roots(obs, records) if obs.trace is not None else None
    if roots is None:
        return None
    per = {r.request: 0 for r in roots}
    for r in records:
        if r.name == name and r.request in per:
            per[r.request] += r.end_ns - r.start_ns
    return float(np.percentile(list(per.values()), 50)) / 1e6
