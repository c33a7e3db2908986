"""The stage-span metrics (``benchmark/stages.py`` and the seven metric
files that read it) on a synthetic device trace and span log: the five idle
buckets partition the window's idle time, each idle instant goes to the
innermost span, the warm-up root stays out, and every file is silent where
it has nothing to read."""

import collections
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

from aswstereomatch_torch.utils import profiling
from benchmark import harness, stages, tracing

S = profiling.SpanRecord
T0 = 1_792_300_000_123_456_789  # ns: the magnitude of time.time_ns()
US = 1_000
CYCLE = 10_000 * US
IDLE = ["pipeline.input.idle_ms", "pipeline.preprocess.idle_ms", "pipeline.aggregate.idle_ms",
        "pipeline.postprocess.idle_ms", "caller.idle_ms"]
HOST = ["pipeline.call.host_ms_p50", "pipeline.postprocess.host_ms_p50"]
BUCKET = dict(zip(IDLE, stages.BUCKETS))


def request(k: int, t: int, thread: int = 7) -> list:
    """One request's spans, as the pipeline logs them on the kernel route
    (children before their parent, in order of their ends)."""
    at = lambda us: t + us * US  # noqa: E731
    return [S(k, "pipeline.input", "pipeline.call", thread, at(3), at(400)),
            S(k, "pipeline.preprocess", "pipeline.aggregate", thread, at(520), at(1900)),
            S(k, "pipeline.aggregate", "pipeline.call", thread, at(500), at(5000)),
            S(k, "pipeline.postprocess", "pipeline.call", thread, at(5007), at(7600)),
            S(k, "pipeline.postprocess", "pipeline.call", thread, at(7610), at(8000 + k)),
            S(k, "pipeline.call", None, thread, t, at(8005 + k))]


def log(n: int, warmup: bool = True, thread: int = 7) -> list:
    records = request(0, T0 - 50 * CYCLE, thread) if warmup else []
    for k in range(1, n + 1):
        records += request(k, T0 + (k - 1) * CYCLE + 137 * k, thread)
    return records


def device(seed: int, n: int) -> list:
    """Random device intervals (start_us, end_us, name) over the window and
    beyond it, at the trace's microsecond floats."""
    rng = np.random.default_rng(seed)
    starts = T0 / 1e3 - 2_000 + rng.uniform(0, n * CYCLE / 1e3 + 4_000, 60 * n)
    return [(s, s + d, "k") for s, d in zip(starts, rng.uniform(1, 400, len(starts)))]


def obs(n_requests: int, dev=None, traced: bool = True):
    trace = tracing.Trace(dev or [], 1.0) if traced else None
    return SimpleNamespace(requests=[object()] * n_requests, trace=trace)


@pytest.fixture
def with_log(monkeypatch):
    def put(records):
        monkeypatch.setattr(profiling, "_LOG", collections.deque(records))
    return put


def read(name, o):
    return harness.metric_reader(name).read(o)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_five_buckets_partition_the_idle_time(with_log, seed):
    n = 6
    records = log(n)
    with_log(records)
    dev = device(seed, n)
    o = obs(n, dev)
    roots = sorted((r for r in records if r.name == "pipeline.call"), key=lambda r: r.start_ns)
    w0, w1 = roots[1].start_ns, roots[-1].start_ns
    ns = [(Fraction(s) * 1000, Fraction(e) * 1000) for s, e in tracing.merged(dev)]  # exact
    idle_ns = (w1 - w0) - sum(min(e, w1) - max(s, w0) for s, e in ns if e > w0 and s < w1)
    got = sum(read(m, o) for m in IDLE) * 1e6 * (n - 1)
    assert got == pytest.approx(float(idle_ns), abs=1.0)  # to the nanosecond
    assert all(read(m, o) > 0 for m in IDLE)


def test_each_idle_instant_goes_to_the_innermost_span(with_log):
    """Against a brute force on a 1 us grid: the innermost open span is the
    latest-started span that holds the instant."""
    n = 4
    records = log(n, warmup=False)
    records += [S(None, "pipeline.aggregate", None, 9, T0, T0 + 3 * CYCLE)]  # another thread
    with_log(records)
    rng = np.random.default_rng(5)
    starts = rng.integers(0, n * CYCLE // US, 150)
    dev = [(T0 // US + int(s), T0 // US + int(s) + int(d), "k")
           for s, d in zip(starts, rng.integers(1, 300, len(starts)))]
    w1 = max(r.start_ns for r in records if r.name == "pipeline.call")
    cells = (w1 - T0) // US
    grid = np.arange(cells) * US + T0 + US // 2  # each microsecond's middle
    busy = np.zeros(cells, bool)
    for s, e, _ in dev:
        busy |= (grid >= s * US) & (grid < e * US)
    owner = np.full(cells, "caller", dtype=object)
    latest = np.full(cells, -1, dtype=np.int64)
    for r in records:
        if r.thread != 7:
            continue
        held = (grid >= r.start_ns) & (grid < r.end_ns) & (r.start_ns > latest)
        name = "pipeline.input" if r.name == "pipeline.call" else r.name
        owner[held], latest[held] = name, r.start_ns
    # the synthetic spans start and end off the grid's middles by less than 1 us
    o = obs(n, dev)
    for metric in IDLE:
        want = int(np.sum(~busy & (owner == BUCKET[metric]))) * US / 1e6 / (n - 1)
        assert read(metric, o) == pytest.approx(want, abs=0.02)
    assert read("pipeline.preprocess.idle_ms", o) > 0.3
    assert read("pipeline.aggregate.idle_ms", o) > 0.3


def test_innermost_segments_of_nested_spans():
    spans = [(0, 100, "call"), (10, 40, "agg"), (15, 25, "pre"), (40, 90, "post")]
    assert stages.innermost(spans) == [
        (0, 10, "call"), (10, 15, "agg"), (15, 25, "pre"), (25, 40, "agg"),
        (40, 90, "post"), (90, 100, "call")]


def test_the_warmup_root_is_left_out(with_log):
    n = 5
    dev = device(4, n) + [(T0 / 1e3 - 50 * CYCLE / 1e3, T0 / 1e3 - 49 * CYCLE / 1e3, "w")]
    with_log(log(n, warmup=True))
    a = {m: read(m, obs(n, dev)) for m in IDLE + HOST}
    with_log(log(n, warmup=False))
    b = {m: read(m, obs(n, dev)) for m in IDLE + HOST}
    assert a == b
    # taken in, the warm-up's 50 idle cycles would swamp the caller's bucket
    with_log(log(n, warmup=True))
    assert read("caller.idle_ms", obs(n + 1, dev)) > 10 * a["caller.idle_ms"]


def test_a_span_outside_the_buckets(with_log):
    """A span name outside ``BUCKETS`` reads the idle time in which it is the
    innermost span: 0.0 where the window holds it but the device never
    idled in it, None where the window holds no such span; what it reads
    leaves its parent's bucket."""
    n = 4
    base = log(n)
    inner = []
    for r in base:
        if r.name == "pipeline.aggregate":  # 500..5000 us, after preprocess's 520..1900
            inner += [S(r.request, "pipeline.cost", r.name, r.thread,
                        r.start_ns + 2000 * US, r.start_ns + 2500 * US),
                      S(r.request, "pipeline.sgm", r.name, r.thread,
                        r.start_ns + 2600 * US, r.start_ns + 3000 * US)]
    dev = [(r.start_ns / 1e3 - 1, r.end_ns / 1e3 + 1, "k") for r in inner
           if r.name == "pipeline.sgm"]
    with_log(base)
    before = {b: stages.idle_ms(obs(n, dev), b) for b in stages.BUCKETS}
    assert stages.idle_ms(obs(n, dev), "pipeline.cost") is None
    with_log(base + inner)
    assert stages.idle_ms(obs(n, dev), "pipeline.sgm") == 0.0
    assert stages.idle_ms(obs(n, dev), "pipeline.cost") == pytest.approx(0.5, abs=1e-6)
    assert stages.idle_ms(obs(n, dev), "pipeline.scan") is None
    after = {b: stages.idle_ms(obs(n, dev), b) for b in stages.BUCKETS}
    agg = before.pop("pipeline.aggregate") - after.pop("pipeline.aggregate")
    assert agg == pytest.approx(0.5, abs=1e-6) and before == after


def test_host_metrics(with_log):
    n = 5
    with_log(log(n))
    o = obs(n, device(6, n))
    # roots last 8005 + k us, k = 1..5; post-process 2593 + 390 + k us
    assert read("pipeline.call.host_ms_p50", o) == pytest.approx(8.008)
    assert read("pipeline.postprocess.host_ms_p50", o) == pytest.approx(2.986)


@pytest.mark.parametrize("metric", IDLE + HOST)
def test_silent_with_nothing_to_read(with_log, monkeypatch, metric):
    n = 4
    with_log(log(n))
    assert read(metric, obs(n, device(7, n))) is not None
    assert read(metric, obs(n, device(7, n), traced=False)) is None   # no trace
    assert read(metric, obs(n + 2, device(7, n))) is None             # too few roots
    assert read(metric, obs(1, device(7, n))) is None                 # no whole cycle
    with_log([])                                                      # spans in another process
    assert read(metric, obs(n, device(7, n))) is None
    with_log(log(n))
    monkeypatch.delattr(profiling, "spans")                           # a program without spans
    assert read(metric, obs(n, device(7, n))) is None
