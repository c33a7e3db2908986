"""A run with the timed path broken underneath comes out not correct: in
process (the stream cells) and in the serving daemon (the serve cells)."""

import sys

import pytest

from benchmark.tests import faults, tiny
from benchmark.traffic import serve


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", ["kitti_sep.stream", "kitti_asw.stream"])
def test_stream_fault_is_caught(workload, fault, monkeypatch):
    from aswstereomatch_torch.models import pipeline

    monkeypatch.setattr(pipeline.StereoMatcher, "__call__",
                        faults.broken_call(fault, pipeline.StereoMatcher.__call__))
    result = tiny.run(workload)
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_daemon_fault_is_caught(fault, monkeypatch):
    daemon = str(tiny.harness.BENCH_DIR / "tests" / "faulty_daemon.py")
    monkeypatch.setattr(serve, "daemon_command", lambda device, summary: [
        sys.executable, daemon, fault, "--port", "0", "--device", device])
    result = tiny.run("kitti_sep.serve_c1", seconds=2.0)
    assert result["correct"] is False and result["failed"] > 0


def test_sound_run_is_correct():
    assert tiny.run("kitti_sep.stream")["correct"] is True
