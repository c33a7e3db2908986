"""What a traced window's profiler trace says: device busy time, time by
device operation, and the device's idle gaps named by what the host was
doing.

The busy time is the interval union of ``aswstereomatch_torch/utils/
profiling.py`` (``_union_us``), the same arithmetic: the device is busy
where any of its operations (kernels, copies, sets) runs, and idle in the
rest of the window.  Under the profiler
the host runs slower, so the idle share of a traced window is an upper bound
on the idle share of an untraced one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "bench.window"
NAME_CHARS = 100  # a name in ``breakdown`` is cut to this many characters


def merged(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint (start, end)."""
    out = []
    for start, end, *_ in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def kernel_pattern(names) -> re.Pattern:
    """A pattern that finds any of the function ``names`` as a whole word of
    a device operation's (demangled) name."""
    return re.compile(r"(?<![A-Za-z0-9_])(?:" + "|".join(map(re.escape, names))
                      + r")(?![A-Za-z0-9_])")


@dataclass
class Trace:
    """A traced window: device intervals (start_us, end_us, name), the
    window's length on the harness clock, and the idle gaps' names."""

    device: list
    window_s: float
    gaps: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in merged(self.device)) / 1e6

    def seconds(self, pattern: re.Pattern | None = None, exclude: bool = False) -> float:
        """Summed device seconds of the operations whose name ``pattern``
        finds (all of them without a pattern; the others with ``exclude``)."""
        total = 0.0
        for start, end, name in self.device:
            if pattern is None or bool(pattern.search(name)) != exclude:
                total += end - start
        return total / 1e6

    def breakdown(self) -> dict:
        by_name: dict = {}
        for start, end, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}

    def summary(self) -> dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "device": self.device, "gaps": self.gaps}

    @classmethod
    def from_summary(cls, d: dict) -> "Trace":
        return cls([tuple(e) for e in d["device"]], d["window_s"], d["gaps"])


def _events(prof):
    """(name, is_device, start_us, end_us, thread) of every profiled event
    but the device-side copies of the host's spans (user annotations)."""
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:  # an older profiler: the parsed events
        for e in prof.events():
            if e.device_type == cuda and getattr(e, "is_user_annotation", False):
                continue
            yield (e.name, e.device_type == cuda, e.time_range.start, e.time_range.end, e.thread)
        return
    for e in results.events():
        on_device = e.device_type() == cuda
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3
        yield e.name(), on_device, start, start + e.duration_ns() / 1e3, e.start_thread_id()


def _gap_names(gaps, host) -> dict:
    """Seconds of idle gaps by the innermost host operation in progress at
    each gap's middle (``host``: (start, end, name) on one thread)."""
    out: dict = {}
    stack: list = []
    events = sorted(host)
    i = 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(events) and events[i][0] <= mid:
            start, end, name = events[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((end, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        name = stack[-1][1] if stack else "(no host operation)"
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return out


def from_profiler(prof, window_s: float) -> Trace:
    """The trace of a ``torch.profiler`` window.  Where the host marked the
    window with a ``WINDOW_SPAN`` span, the gaps are those inside it, named
    by the operations of the span's thread."""
    device, cpu = [], []
    for name, is_device, start, end, thread in _events(prof):
        (device if is_device else cpu).append((start, end, name, thread))
    window = [e for e in cpu if e[2] == WINDOW_SPAN]
    gaps: dict = {}
    if window:
        w0, w1, _, thread = window[0]
        busy = [(max(s, w0), min(e, w1)) for s, e in merged(device) if e > w0 and s < w1]
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = [(s, e, n) for s, e, n, t in cpu if t == thread and n != WINDOW_SPAN]
        gaps = _gap_names(idle, host)
    return Trace([(s, e, n) for s, e, n, _ in device], window_s, gaps)
