"""The ``middeval3_h_sgm`` configuration and its three metrics on the CPU: the
configuration file against its preset, its fields at a small size past the
SGM scan's register path against the plain SGM reference, the
``sgm_wide_roofline`` reader over a synthetic trace, the ``pipeline.wta.*``
readers over a synthetic span log, and a whole run of
``middeval3_h_sgm.stream`` at a small size."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from aswstereomatch_torch.utils import profiling
from benchmark import correctness, harness, roofline, stages, tracing
from benchmark.inputs import synthetic
from benchmark.reference import plain
from benchmark.tests import tiny
from benchmark.tests.test_bm_spans import (  # noqa: F401  (with_log: a fixture)
    CYCLE, T0, US, S, device, obs, request, with_log)

CELL = "middeval3_h_sgm.stream"
CONF = harness.load_json(harness.BENCH_DIR / "configs" / "middeval3_h_sgm.json")
WTA = ["pipeline.wta.idle_ms", "pipeline.wta.host_ms_p50"]
NEW = {"sgm_wide_roofline", *WTA}
LONG = "void (anonymous namespace)::sgm_long_kernel(Phase)"


def read(name, o):
    return harness.metric_reader(name).read(o)


def test_the_configuration_is_its_preset_with_three_overrides():
    from aswstereomatch_torch.config import get_preset

    want = get_preset(CONF["preset"]).replace(**CONF["overrides"])
    assert CONF["stereo_config"] == dataclasses.asdict(want)
    assert CONF["overrides"] == {"sgm_paths": 8, "max_disparity": 256, "uniqueness_ratio": 10.0}
    assert CONF["preset"] == "kitti_sgm" and want.aggregation == "sgm" and want.lr_tol == 1.0
    assert (CONF["height"], CONF["width"], want.max_disparity) == (994, 1440, 256)
    assert CONF["reduced"] == {} and want.mesh_tile == 1
    assert CONF["reference"] == "sgm"
    assert CONF["aggregation_kernels"] == ["sgm_reg_kernel", "sgm_long_kernel"]


def test_the_cell_runs_the_long_d_path_and_lists_only_its_metrics():
    from aswstereomatch_torch.ops.cuda import sgm_kernel

    assert sgm_kernel.plan(CONF["height"], CONF["width"], 256, 8).vpl == 0
    spec = harness.resolve(harness.load_json(harness.REPO / "BENCHMARK.json"), CELL)
    assert spec["cell"]["chips"] == 1 and spec["cell"]["traffic"] == "stream"
    assert {m["name"] for m in spec["per_layer"]} == NEW
    assert all(m["workloads"] == [CELL] for m in spec["per_layer"])


def test_the_configurations_fields_equal_the_reference_past_the_register_path():
    """The file's own fields, cut only in H, W and D (136 > 128), through
    ``StereoMatcher`` against the plain reference its file names: float32
    bit for bit, and the TF32 control beyond the file's limit."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models.pipeline import StereoMatcher

    fields = {**CONF["stereo_config"], "max_disparity": 136}
    p = synthetic.make_pair(height=16, width=160, max_disparity=136, seed=17)
    left, right = p["left"].astype(np.uint8), p["right"].astype(np.uint8)
    got = StereoMatcher(StereoConfig(**fields), device="cpu")(left, right).numpy()
    ref = plain.disparity(left, right, fields, CONF["reference"])
    np.testing.assert_array_equal(got, ref)
    ctl = plain.disparity(left, right, fields, CONF["reference"], precision="tf32")
    limits = CONF["limits"]["float32"]
    assert all(correctness.readings(got, ref, "float32")[k] == 0 for k in limits)
    assert all(correctness.readings(ctl, ref, "float32")[k] > limit
               for k, limit in limits.items())


# ------------------------------------------------------------ sgm_wide_roofline
def _traced(kernels, n=4):
    """``n`` requests of the configuration and a trace of ``kernels``,
    (name, ms) per pair."""
    dev, t = [], 1e9
    for _ in range(n):
        for name, ms in kernels:
            dev.append((t, t + 1e3 * ms, name))
            t += 1e3 * ms + 50.0
    return SimpleNamespace(requests=[object()] * n, trace=tracing.Trace(dev, 1.0), config=CONF)


def test_sgm_wide_roofline_reads_the_bound_over_the_scans_time():
    """Both of the scan's kernels count, nothing else: 0.875 ms by bytes at
    1440 x 994 x 256 over 25 ms a pair in four phases is 3.5%."""
    bound, kind = roofline.sgm_bound(CONF["height"], CONF["width"],
                                     SimpleNamespace(**CONF["stereo_config"]))
    assert kind == "bytes" and bound == pytest.approx(0.875, rel=1e-3)
    phases = [(LONG, 7.0), (LONG, 5.0), ("void sgm_reg_kernel<4>(Phase)", 8.0), (LONG, 5.0),
              ("void at::native::reduce_kernel<512, 1>(argmin_like)", 9.0),
              ("my_sgm_long_kernel_copy", 3.0)]
    got = read("sgm_wide_roofline", _traced(phases))
    assert got == pytest.approx(100.0 * bound / 25.0)
    assert got == read("sgm_roofline", _traced(phases))


def test_sgm_wide_roofline_is_silent_without_a_scan():
    assert read("sgm_wide_roofline", _traced([("void cost_volume_kernel<4>(Args)", 6.0)])) is None
    assert read("sgm_wide_roofline", _traced([])) is None
    assert read("sgm_wide_roofline", _traced([(LONG, 1.0)], n=0)) is None
    untraced = _traced([(LONG, 1.0)])
    untraced.trace = None
    assert read("sgm_wide_roofline", untraced) is None


# -------------------------------------------------------------- pipeline.wta.*
def wta_request(k: int, t: int, thread: int = 7) -> list:
    """One request's spans on SGM's eager route: the raw cost volume, the
    scan, then the volume's WTA (900 + k us), inside the aggregation."""
    at = lambda us: t + us * US  # noqa: E731
    out = [r for r in request(k, t, thread) if r.name != "pipeline.preprocess"]
    out[1:1] = [S(k, "pipeline.cost", "pipeline.aggregate", thread, at(510), at(2000)),
                S(k, "pipeline.sgm", "pipeline.aggregate", thread, at(2010), at(4000)),
                S(k, "pipeline.wta", "pipeline.aggregate", thread, at(4010), at(4910 + k))]
    return out


def wta_log(n: int, wta: bool = True) -> list:
    """A warm-up request long before the window, then ``n`` requests."""
    one = wta_request if wta else request
    records = one(0, T0 - 50 * CYCLE)
    for k in range(1, n + 1):
        records += one(k, T0 + (k - 1) * CYCLE + 137 * k)
    return records


def test_wta_metrics(with_log):
    """The WTA span's host time per request, and the idle time in which it
    is the innermost span, which leaves the aggregation's bucket."""
    n = 5
    with_log(wta_log(n))
    start = [T0 / 1e3 + (k - 1) * CYCLE / 1e3 + 137e-3 * k for k in range(1, n + 1)]
    dev = [(s + a, s + b, "k") for s in start for a, b in ((600, 1900), (2100, 4500))]
    o = obs(n, dev)
    # WTA spans last 900 + k us, k = 1..5
    assert read("pipeline.wta.host_ms_p50", o) == pytest.approx(0.903)
    # in a cycle the card idles in the WTA span at 4500..4910 + k us, k = 1..4
    # inside the window: 410 + k us (the trace's microsecond floats hold
    # times of this magnitude to 0.25 us)
    assert read("pipeline.wta.idle_ms", o) == pytest.approx(0.4125, abs=2.5e-4)
    # the aggregation's own 500..510, 2000..2010 and 4910 + k..5000 (its
    # 4000..4010 is busy); the scan's 2010..2100
    assert read("pipeline.aggregate.idle_ms", o) == pytest.approx(0.1075, abs=2.5e-4)
    assert stages.idle_ms(o, "pipeline.sgm") == pytest.approx(0.09, abs=2.5e-4)
    with_log(wta_log(n, wta=False))  # the kernel route, or a program without the span
    o = obs(n, dev)  # a new run: ``stages`` reads the log once per run
    assert all(read(m, o) is None for m in WTA)


@pytest.mark.parametrize("metric", WTA)
def test_wta_metrics_silent_with_nothing_to_read(with_log, monkeypatch, metric):
    n = 4
    with_log(wta_log(n))
    assert read(metric, obs(n, device(7, n))) is not None
    assert read(metric, obs(n, device(7, n), traced=False)) is None   # no trace
    assert read(metric, obs(n + 2, device(7, n))) is None             # too few roots
    assert read(metric, obs(1, device(7, n))) is None                 # no whole cycle
    with_log([])                                                      # spans in another process
    assert read(metric, obs(n, device(7, n))) is None
    with_log(wta_log(n))
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
        assert want == NEW  # the shared metrics list other cells
    # On the CPU nothing runs on a device: the roofline stays silent.
    assert want - {"sgm_wide_roofline"} <= set(result["metrics"]) <= want
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
