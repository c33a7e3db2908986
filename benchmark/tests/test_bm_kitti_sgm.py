"""The ``kitti_sgm`` configuration and its three metrics on the CPU: the
configuration file's own fields against the plain SGM reference, the
``sgm_roofline`` reader over a synthetic trace, the ``pipeline.cost.*``
readers over a synthetic span log, and a whole run of ``kitti_sgm.stream``
at a small size."""

import collections
from types import SimpleNamespace

import numpy as np
import pytest

from aswstereomatch_torch.utils import profiling
from benchmark import correctness, harness, roofline, stages, tracing
from benchmark.inputs import synthetic
from benchmark.reference import plain
from benchmark.tests import tiny
from benchmark.tests.test_bm_spans import CYCLE, T0, US, S, device, obs, request

CELL = "kitti_sgm.stream"
CONF = harness.load_json(harness.BENCH_DIR / "configs" / "kitti_sgm.json")
COST = ["pipeline.cost.idle_ms", "pipeline.cost.host_ms_p50"]
SCAN = "void sgm_reg_kernel<4>(Phase)"


def read(name, o):
    return harness.metric_reader(name).read(o)


def test_the_configuration_is_its_preset_with_eight_paths():
    import dataclasses

    from aswstereomatch_torch.config import get_preset

    want = get_preset(CONF["preset"]).replace(**CONF["overrides"])
    assert CONF["stereo_config"] == dataclasses.asdict(want)
    assert CONF["overrides"] == {"sgm_paths": 8} and want.aggregation == "sgm"
    assert (CONF["height"], CONF["width"], want.max_disparity) == (375, 1242, 128)
    assert CONF["reduced"] == {} and want.mesh_tile == 1


def test_the_configurations_fields_equal_the_reference():
    """The file's own fields, cut only in H, W and D, through ``StereoMatcher``
    against the plain reference its file names: float32 bit for bit, and
    the TF32 control beyond the file's limit."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models.pipeline import StereoMatcher

    fields = {**CONF["stereo_config"], "max_disparity": 12}
    p = synthetic.make_pair(height=30, width=52, max_disparity=12, seed=13)
    left, right = p["left"].astype(np.uint8), p["right"].astype(np.uint8)
    got = StereoMatcher(StereoConfig(**fields), device="cpu")(left, right).numpy()
    ref = plain.disparity(left, right, fields, CONF["reference"])
    np.testing.assert_array_equal(got, ref)
    ctl = plain.disparity(left, right, fields, CONF["reference"], precision="tf32")
    limits = CONF["limits"]["float32"]
    assert all(correctness.readings(got, ref, "float32")[k] == 0 for k in limits)
    assert all(correctness.readings(ctl, ref, "float32")[k] > limit
               for k, limit in limits.items())


# ----------------------------------------------------------------- sgm_roofline
def _traced(kernels, n=4):
    """``n`` requests of the configuration and a trace of ``kernels``,
    (name, ms) per pair."""
    dev, t = [], 1e9
    for _ in range(n):
        for name, ms in kernels:
            dev.append((t, t + 1e3 * ms, name))
            t += 1e3 * ms + 50.0
    return SimpleNamespace(requests=[object()] * n, trace=tracing.Trace(dev, 1.0), config=CONF)


def test_sgm_roofline_reads_the_bound_over_the_scans_time():
    """Only the configuration's SGM kernels count: 8 paths at KITTI, 0.142
    ms by bytes over 2.0 ms a pair in four phases is 7.1%."""
    bound, kind = roofline.sgm_bound(CONF["height"], CONF["width"],
                                     SimpleNamespace(**CONF["stereo_config"]))
    assert kind == "bytes" and bound == pytest.approx(0.142, rel=1e-2)
    phases = [(SCAN, 0.55), ("void sgm_long_kernel<2>(Phase)", 0.45), (SCAN, 0.6), (SCAN, 0.4),
              ("void at::native::elementwise_kernel<128, 2>(int, sgm_like)", 9.0),
              ("my_sgm_reg_kernel_copy", 3.0)]
    assert read("sgm_roofline", _traced(phases)) == pytest.approx(100.0 * bound / 2.0)


def test_sgm_roofline_is_silent_without_a_scan():
    assert read("sgm_roofline", _traced([("void asw_sep_wta_kernel<true>(float)", 6.0)])) is None
    assert read("sgm_roofline", _traced([])) is None
    assert read("sgm_roofline", _traced([(SCAN, 1.0)], n=0)) is None
    untraced = _traced([(SCAN, 1.0)])
    untraced.trace = None
    assert read("sgm_roofline", untraced) is None


# ------------------------------------------------------------ pipeline.cost.*
def sgm_request(k: int, t: int, thread: int = 7) -> list:
    """One request's spans on SGM's eager route: no stack build; the raw
    cost volume (2400 + k us), then the scan, inside the aggregation."""
    at = lambda us: t + us * US  # noqa: E731
    out = [r for r in request(k, t, thread) if r.name != "pipeline.preprocess"]
    out[1:1] = [S(k, "pipeline.cost", "pipeline.aggregate", thread, at(510), at(2910 + k)),
                S(k, "pipeline.sgm", "pipeline.aggregate", thread, at(2920 + k), at(4990))]
    return out


def sgm_log(n: int, sgm: bool = True) -> list:
    """A warm-up request long before the window, then ``n`` requests."""
    one = sgm_request if sgm else request
    records = one(0, T0 - 50 * CYCLE)
    for k in range(1, n + 1):
        records += one(k, T0 + (k - 1) * CYCLE + 137 * k)
    return records


@pytest.fixture
def with_log(monkeypatch):
    def put(records):
        monkeypatch.setattr(profiling, "_LOG", collections.deque(records))
    return put


def test_cost_metrics(with_log):
    """The cost span's host time per request, and the idle time in which it
    is the innermost span, which leaves the aggregation's bucket."""
    n = 5
    with_log(sgm_log(n))
    start = [T0 / 1e3 + (k - 1) * CYCLE / 1e3 + 137e-3 * k for k in range(1, n + 1)]
    dev = [(s + a, s + b, "k") for s in start for a, b in ((900, 2000), (3000, 4000))]
    o = obs(n, dev)
    # cost spans last 2400 + k us, k = 1..5
    assert read("pipeline.cost.host_ms_p50", o) == pytest.approx(2.403)
    # in a cycle the card idles in the cost span at 510..900 and 2000..2910 + k
    # us, k = 1..4 inside the window: 1300 + k us
    assert read("pipeline.cost.idle_ms", o) == pytest.approx(1.3025, abs=1e-6)
    # the scan's span 2920 + k..4990 us around 3000..4000; the aggregation's
    # own 500..510, 2910 + k..2920 + k and 4990..5000
    assert stages.idle_ms(o, "pipeline.sgm") == pytest.approx(1.0675, abs=1e-6)
    assert read("pipeline.aggregate.idle_ms", o) == pytest.approx(0.03, abs=1e-6)
    with_log(sgm_log(n, sgm=False))  # the kernel route, or a program without the span
    o = obs(n, dev)  # a new run: ``stages`` reads the log once per run
    assert all(read(m, o) is None for m in COST)


@pytest.mark.parametrize("metric", COST)
def test_cost_metrics_silent_with_nothing_to_read(with_log, monkeypatch, metric):
    n = 4
    with_log(sgm_log(n))
    assert read(metric, obs(n, device(7, n))) is not None
    assert read(metric, obs(n, device(7, n), traced=False)) is None   # no trace
    assert read(metric, obs(n + 2, device(7, n))) is None             # too few roots
    assert read(metric, obs(1, device(7, n))) is None                 # no whole cycle
    with_log([])                                                      # spans in another process
    assert read(metric, obs(n, device(7, n))) is None
    with_log(sgm_log(n))
    monkeypatch.delattr(profiling, "spans")                           # a program without spans
    assert read(metric, obs(n, device(7, n))) is None


# ---------------------------------------------------------------- a whole run
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    result = tiny.run(CELL, trace=trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    spec = harness.resolve(tiny.bench(), CELL)
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    if trace:
        assert want == {"sgm_roofline", *COST}  # the shared metrics list other cells
    # On the CPU nothing runs on a device: the roofline stays silent.
    assert want - {"sgm_roofline"} <= set(result["metrics"]) <= want
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
