"""The pipeline's stage spans (``utils/profiling.py::span``) on the CPU.

Without a profiler a span is one flag check: nothing recorded, no
``record_function`` entered, the same map.  Under a profiler every
``StereoMatcher`` request is one ``pipeline.call`` root whose stages carry
its request id and nest as the pipeline does (SGM's cost build and scan
inside the aggregation, one raw volume a pair, and the volume's WTA after
them), and every span's times lie
within the profiler's own event of the same name: the spans share the
profiler's clock, which is the device trace's.
"""

import collections
import json
import os
from types import SimpleNamespace

import pytest
import torch

import aswstereomatch_torch as ast
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops import aggregate, cost
from aswstereomatch_torch.ops.cuda import common, cost_kernel, sgm_kernel, stacks_kernel
from aswstereomatch_torch.utils import profiling, synthetic

ROOT = profiling.ROOT_SPAN
FIVE = {ROOT, "pipeline.input", "pipeline.preprocess", "pipeline.aggregate",
        "pipeline.postprocess"}
CLOCK_NS = 50_000  # 50 us


@pytest.fixture(scope="module")
def pair():
    return synthetic.make_pair(height=24, width=40, max_disparity=8, seed=3)


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _matcher(median=True):
    return ast.StereoMatcher.from_preset("tsukuba_ad_box", device="cpu",
                                         median_filter=median, max_disparity=8)


def _sgm_matcher(paths):
    """``kitti_sgm``'s fields at the pair's size: the eager raw cost volume,
    then the SGM scan's plain version."""
    return ast.StereoMatcher.from_preset("kitti_sgm", device="cpu", max_disparity=8,
                                         sgm_paths=paths)


# The matchers the span tests run, by route; SGM adds its two stages inside
# ``pipeline.aggregate``, and every route that builds a volume (all but the
# kernel route) ends that span with the volume's WTA.
MATCHERS = {"eager": _matcher, "kernel": _matcher,
            "sgm_4_paths": lambda: _sgm_matcher(4), "sgm_8_paths": lambda: _sgm_matcher(8)}
SGM_STAGES = ["pipeline.cost", "pipeline.sgm"]
WTA = "pipeline.wta"


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _kernel_route(monkeypatch):
    """The kernel route on CPU tensors: the wrappers run their plain versions
    through the same ``stacks()``."""
    monkeypatch.setattr(pipeline, "_resolve_backend", lambda cfg, device: "cuda")


def _by_request(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.request].append(r)
    return out


@pytest.mark.parametrize("route", ["eager", "sgm_4_paths", "sgm_8_paths"])
def test_without_a_profiler_a_span_records_nothing(monkeypatch, pair, route):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    m = MATCHERS[route]()
    plain = m(pair["left"], pair["right"])
    assert profiling.spans() == [] and entered == []
    assert profiling.span(ROOT) is profiling.span("pipeline.input")  # one shared no-op
    with _profiler():
        traced = m(pair["left"], pair["right"])
    want = {ROOT, "pipeline.input", "pipeline.aggregate", WTA, "pipeline.postprocess"}
    if route.startswith("sgm"):
        want.update(SGM_STAGES)
    assert set(entered) == want
    assert len(profiling.spans()) == len(entered)
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("route", list(MATCHERS))
def test_each_call_is_one_root_with_its_stages(monkeypatch, pair, route):
    if route == "kernel":
        _kernel_route(monkeypatch)
    m = MATCHERS[route]()
    with _profiler():
        for _ in range(3):
            m(pair["left"], pair["right"])
    records = profiling.spans()
    roots = [r for r in records if r.name == ROOT]
    assert len(roots) == 3 and len({r.request for r in roots}) == 3
    assert all(r.parent is None and r.request is not None for r in roots)
    parents = {"pipeline.input": ROOT, "pipeline.aggregate": ROOT,
               "pipeline.postprocess": ROOT, "pipeline.preprocess": "pipeline.aggregate",
               "pipeline.cost": "pipeline.aggregate", "pipeline.sgm": "pipeline.aggregate",
               WTA: "pipeline.aggregate"}
    for root in roots:
        mine = [r for r in records if r.request == root.request and r.name != ROOT]
        want = ["pipeline.input", "pipeline.aggregate", "pipeline.postprocess"]
        if route == "kernel":
            want.insert(2, "pipeline.preprocess")
        else:
            want.insert(2, WTA)
        if route.startswith("sgm"):
            want[2:2] = SGM_STAGES
        assert sorted(r.name for r in mine) == sorted(want)
        assert [r.name for r in sorted(mine, key=lambda r: r.start_ns)] == want
        for r in mine:
            assert r.parent == parents[r.name] and r.thread == root.thread
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    # the stages follow one another inside the root, and inside the aggregation
    for root in roots:
        for parent in (ROOT, "pipeline.aggregate"):
            level = sorted((r for r in records
                            if r.request == root.request and r.parent == parent),
                           key=lambda r: r.start_ns)
            assert all(a.end_ns <= b.start_ns for a, b in zip(level, level[1:]))
        agg = next(r for r in records
                   if r.request == root.request and r.name == "pipeline.aggregate")
        assert all(agg.start_ns <= r.start_ns <= r.end_ns <= agg.end_ns for r in records
                   if r.request == root.request and r.parent == "pipeline.aggregate")


@pytest.mark.parametrize("paths", [4, 8])
def test_one_raw_volume_per_sgm_pair(monkeypatch, pair, paths):
    """``cost.volumes`` counts the materialized raw volumes: one per SGM pair,
    with the profiler on or off, single or batched."""
    monkeypatch.setattr(cost, "volumes", 0)
    m = _sgm_matcher(paths)
    m(pair["left"], pair["right"])
    assert cost.volumes == 1
    with _profiler():
        m(pair["left"], pair["right"])
    assert cost.volumes == 2
    both = torch.stack([torch.from_numpy(pair["left"])] * 2)
    m.batch(both, torch.stack([torch.from_numpy(pair["right"])] * 2))
    assert cost.volumes == 4
    _kernel_route(monkeypatch)  # the fused kernels' route builds no volume
    _matcher()(pair["left"], pair["right"])
    assert cost.volumes == 4


def _open_span_when_called(monkeypatch, module, name):
    """Replace ``module.name`` by a pass-through that records the innermost
    span open on the thread at each call."""
    seen, real = [], getattr(module, name)

    def recording(*args, **kw):
        stack = getattr(profiling._OPEN, "stack", None)
        seen.append(stack[-1][0] if stack else None)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, recording)
    return seen


def test_preprocess_nests_in_aggregate_outside_a_request(monkeypatch, pair):
    """``_kernel_wta`` alone: the kernel module's plain version goes through
    ``stacks()``; with no ``pipeline.call`` around them the spans carry no
    request.  The CPU stack build runs inside ``pipeline.preprocess``."""
    seen = _open_span_when_called(monkeypatch, stacks_kernel, "reference")
    m = _matcher()
    left = torch.from_numpy(pair["left"]).to(torch.float32)
    right = torch.from_numpy(pair["right"]).to(torch.float32)
    with _profiler():
        pipeline._kernel_wta(left, right, m.cfg)
    got = {r.name: r for r in profiling.spans()}
    assert set(got) == {"pipeline.aggregate", "pipeline.preprocess"}
    assert got["pipeline.aggregate"].parent is None
    assert got["pipeline.preprocess"].parent == "pipeline.aggregate"
    assert all(r.request is None for r in got.values())
    assert seen == ["pipeline.preprocess"]


def test_preprocess_wraps_the_stack_kernel_launch(monkeypatch):
    """Off the CPU ``stacks()`` hands both views to the stack kernel's
    wrapper, once, inside the ``pipeline.preprocess`` span (meta tensors and
    a stand-in launch: no card here)."""
    def launch(left, right, r, D):
        h, w = left.shape[:2]
        return (torch.empty((7, h, w + 2 * r), device=left.device),
                torch.empty((7, h, w + 2 * r + D - 1), device=left.device))

    monkeypatch.setattr(stacks_kernel, "channel_stacks", launch)
    seen = _open_span_when_called(monkeypatch, stacks_kernel, "channel_stacks")
    monkeypatch.setattr(stacks_kernel, "reference", None)  # the CPU path must not run
    cfg = _matcher().cfg
    left = torch.empty((6, 9, 3), device="meta")
    with _profiler():
        ls, rs = common.stacks(left, left, cfg)
    r, D = cfg.window_radius, cfg.max_disparity
    assert ls.shape == (7, 6, 9 + 2 * r) and rs.shape == (7, 6, 9 + 2 * r + D - 1)
    assert seen == ["pipeline.preprocess"]
    assert [rec.name for rec in profiling.spans()] == ["pipeline.preprocess"]


def test_batch_and_bands_are_one_request_each(pair):
    m = _matcher()
    lefts = torch.stack([torch.from_numpy(pair["left"])] * 2)
    rights = torch.stack([torch.from_numpy(pair["right"])] * 2)
    banded = ast.StereoMatcher(m.cfg.replace(y_chunks=2), device="cpu")
    with _profiler():
        m.batch(lefts, rights)
        banded(pair["left"], pair["right"])
    requests = _by_request(profiling.spans())
    assert None not in requests and len(requests) == 2
    for records in requests.values():
        names = collections.Counter(r.name for r in records)
        assert names == {ROOT: 1, "pipeline.input": 1, "pipeline.aggregate": 2, WTA: 2,
                         "pipeline.postprocess": 2}


def test_nested_calls_share_the_outer_request_and_errors_close_spans():
    with _profiler():
        with pytest.raises(ValueError):
            with profiling.span(ROOT):
                with profiling.span(ROOT):
                    raise ValueError("inside")
        with profiling.span("pipeline.postprocess"):
            pass
    inner, outer, alone = profiling.spans()
    assert inner.request == outer.request is not None
    assert (inner.parent, outer.parent) == (ROOT, None)
    assert alone.parent is None and alone.request is None


def test_spans_lie_within_the_profilers_events(monkeypatch, pair):
    _kernel_route(monkeypatch)
    m = _matcher()
    m(pair["left"], pair["right"])
    with _profiler() as prof:
        for _ in range(3):
            m(pair["left"], pair["right"])
    records = profiling.spans()
    assert {r.name for r in records} == FIVE
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in FIVE:
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in FIVE:
        mine = sorted((r.start_ns, r.end_ns) for r in records if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) > 0
        for (s, e), (s0, e0) in zip(mine, theirs):
            assert s0 - CLOCK_NS <= s <= e <= e0 + CLOCK_NS
    assert 0 <= profiling.span_clock_error_us(prof, records) <= CLOCK_NS / 1e3
    assert profiling.span_clock_error_us(prof, []) is None


def test_device_intervals_leave_out_the_spans_card_side_copies():
    """A ``record_function`` also leaves a card-side annotation over the
    work it enqueued; the profiling tool's busy time must not count it."""
    cuda = torch.autograd.DeviceType.CUDA
    ev = lambda name, a, b, dev, note: SimpleNamespace(  # noqa: E731
        name=name, time_range=SimpleNamespace(start=a, end=b), device_type=dev,
        is_user_annotation=note)
    prof = SimpleNamespace(events=lambda: [
        ev("pipeline.aggregate", 0.0, 100.0, cuda, True), ev("k", 10.0, 20.0, cuda, False),
        ev("aten::mul", 0.0, 5.0, torch.autograd.DeviceType.CPU, False)])
    assert profiling._device_intervals(prof) == [(10.0, 20.0, "k")]


def test_the_chrome_trace_holds_the_five_names(monkeypatch, tmp_path, pair):
    _kernel_route(monkeypatch)
    m = _matcher()
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        m(pair["left"], pair["right"])
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert FIVE <= names


def test_the_log_is_bounded_and_clears(monkeypatch, pair):
    assert profiling._LOG.maxlen == profiling.SPAN_LOG_RECORDS
    monkeypatch.setattr(profiling, "_LOG", collections.deque(maxlen=5))
    m = _matcher(median=False)
    with _profiler():
        for _ in range(3):
            m(pair["left"], pair["right"])
    records = profiling.spans()
    assert len(records) == 5 and records[-1].name == ROOT
    assert profiling.spans() is not profiling.spans()  # a copy
    profiling.clear_spans()
    assert profiling.spans() == []


def test_cost_wraps_the_cost_kernel_launch(monkeypatch):
    """Off the CPU SGM's raw volume goes to the cost kernel's wrapper, once,
    inside the ``pipeline.cost`` span, and the plain loop does not run (meta
    tensors and stand-in launches: no card here)."""
    def launch(planes, cfg):
        h, wo = planes.gl.shape
        return torch.empty((h, wo, cfg.max_disparity), device=planes.gl.device)

    monkeypatch.setattr(cost_kernel, "cost_volume", launch)
    seen = _open_span_when_called(monkeypatch, cost_kernel, "cost_volume")
    monkeypatch.setattr(cost_kernel, "reference", None)  # the CPU path must not run
    monkeypatch.setattr(sgm_kernel, "aggregate", lambda vol, cfg: vol)
    cfg = _sgm_matcher(8).cfg
    left = torch.empty((6, 9, 3), device="meta")
    with _profiler():
        vol = aggregate.aggregated_volume(left, left, cfg)
    assert vol.shape == (6, 9, cfg.max_disparity)
    assert seen == ["pipeline.cost"]
    assert sorted(rec.name for rec in profiling.spans()) == SGM_STAGES
