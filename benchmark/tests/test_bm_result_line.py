"""A whole run at a small size on the CPU, with the look for a card
skipped: the result line's keys, the metrics each cell reports, and the
refusal without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

BENCH = tiny.bench()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _expected(workload, trace):
    spec = harness.resolve(BENCH, workload)
    return {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}


@pytest.mark.parametrize("workload,trace", [
    ("kitti_sep.stream", False), ("kitti_sep.stream", True), ("kitti_asw.stream", True),
    ("kitti_sep.serve_c1", False), ("kitti_sep.serve_c4", True),
])
def test_result_line(workload, trace):
    result = tiny.run(workload, trace=trace)
    assert list(result)[:5] == KEYS
    assert list(result)[-1] == "checks"
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    got = set(result["metrics"])
    want = _expected(workload, trace)
    # On the CPU nothing runs on a device: the device metrics stay silent.
    silent = {"plain_ops.device_ms", "k1_roofline", "k2_roofline", "device.idle_pct"}
    assert want - silent <= got <= want
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(result)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", "kitti_sep.stream",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=harness.REPO)
    if proc.returncode == 0:
        pytest.skip("this machine has a CUDA device")
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_same_seed_same_inputs():
    conf = tiny.config("kitti_sep")
    a = harness.make_pool(conf, 2**31 + 99, 2)
    b = harness.make_pool(conf, 2**31 + 99, 2)
    c = harness.make_pool(conf, 2**31 + 100, 2)
    assert all((x["left"] == y["left"]).all() for x, y in zip(a, b))
    assert not (a[0]["left"] == c[0]["left"]).all()
