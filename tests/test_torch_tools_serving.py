"""The port's serving tools (``aswstereomatch_torch/tools/serve_bench.py``,
``serve_soak.py``, ``soak_runner.py``) on the CPU at 48 x 64, D = 8, r = 2,
against the reference.

Each tool spawns the port's daemon (``--device cpu``) as a child process
with a deadline and stops it on every exit.  The daemon's answers must
agree with the reference's jnp ``match_pair`` on the same numpy pair at the
pipeline bar of tests/test_oracle_parity.py:141-143 (|d - d_ref| <= 0.51 on
more than 99.5% of pixels, > 2 on fewer than 0.2%), each record must carry
every field of the reference tool's committed record in ``bench_results/``,
and the recycle soak must restart its daemon at least once with no
unstable answer.
"""

import functools
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import get_preset as ref_preset
from aswstereomatch_tpu.models import pipeline as ref_pipeline

from aswstereomatch_torch.tools import serve_bench, serve_soak, soak_runner

REPO = Path(__file__).resolve().parents[1]
SHAPE = (48, 64, 8)
R = 2
QUIET = lambda *a, **k: None  # noqa: E731
ENV_KEYS = {"device", "power_limit", "torch", "cuda"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread here and in the daemons (six pytest workers share
    the cores; the daemon and this process then reduce in the same way)."""
    threads = torch.get_num_threads()
    old = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


@functools.lru_cache(maxsize=None)
def _ref_fn(preset: str):
    cfg = ref_preset(preset).replace(max_disparity=SHAPE[2], window_radius=R, mesh_data=1,
                                     mesh_tile=1, backend="jnp")
    return jax.jit(functools.partial(ref_pipeline.match_pair, cfg=cfg))


def ref_map(preset: str, left, right) -> np.ndarray:
    return np.asarray(_ref_fn(preset)(jnp.asarray(left, jnp.float32),
                                      jnp.asarray(right, jnp.float32)))


def hold(ours: np.ndarray, want: np.ndarray) -> None:
    assert np.mean(np.abs(ours - want) <= 0.51) > 0.995
    assert np.mean(np.abs(ours - want) > 2.0) < 0.002


def committed(name: str):
    with open(REPO / "bench_results" / name) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    maps = {}
    log = tmp_path_factory.mktemp("serve_bench") / "daemon.log"
    rec = serve_bench.run("cpu", "kitti_sep", clients=2, requests=4, shape=SHAPE, radius=R,
                          log_path=str(log), timeout_s=90, maps=maps, progress=QUIET)
    return rec, maps


def test_serve_bench_record_fields(bench):
    rec, _ = bench
    ref = committed("serve_bench.json")
    assert set(ref) <= set(rec) and ENV_KEYS <= set(rec)
    assert set(rec["wire"]) == set(ref["wire"])
    for key, row in rec["wire"].items():
        assert set(ref["wire"][key]) <= set(row)
        assert row["requests"] == 4 and row["first_answer_bit_exact"], (key, row)
    assert rec["ok"] and not rec["errors"]


def test_serve_bench_percentiles_ordered(bench):
    rec, _ = bench
    for row in rec["wire"].values():
        assert 0 < row["p50_ms"] <= row["p90_ms"] <= row["p99_ms"] <= row["max_ms"]
        assert 0 < row["server_side_p50_ms"] and row["throughput_pairs_per_s"] > 0
        assert row["client_past_server_p50_ms"] > 0


@pytest.mark.parametrize("wire", [f"{a}->{b}" for a, b in serve_bench.WIRES])
def test_serve_bench_answers_match_reference(bench, wire):
    """The daemon's first answer per wire against the reference on the
    images the wire carries (uint8 truncates)."""
    _, maps = bench
    from aswstereomatch_torch.utils import synthetic

    h, w, d = SHAPE
    pair = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=0)
    left, right = serve_bench.wire_images(pair, wire.split("->")[0])
    hold(maps[wire], ref_map("kitti_sep", left, right))


def test_serve_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench.main(["--requests", "1"])


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    pins = {}
    recs = serve_soak.run("cpu", requests=4, clients=2, recycle_requests=48,
                          recycle_clients=2, shape=SHAPE, radius=R,
                          log_dir=str(tmp_path_factory.mktemp("serve_soak")), deadline_s=180,
                          pins=pins, progress=QUIET)
    return recs, pins


def test_recycle_soak_restarts_and_stays_stable(soak):
    rec = soak[0]["recycle"]
    assert rec["supervisor_restarts_on_42"] >= 1, rec["generations"]
    assert rec["unstable"] == 0 and rec["server_errors"] == 0 and not rec["client_errors"]
    assert rec["requests_completed"] == rec["requests_asked"] == 48
    assert rec["pins_equal_in_process"] and rec["ok"], rec["checks"]
    probe = rec["probe"]
    assert probe["rss_mb_listening"] < rec["max_rss_mb_limit"] < probe[
        "rss_mb_after_first_answer"]
    assert [g["rc"] for g in rec["generations"][:-1]] == [42] * rec["supervisor_restarts_on_42"]
    for g in rec["generations"]:
        assert g["up_s"] is not None and g["up_s"] > 0 and g["rss_curve_mb"]


def test_steady_soak_stable(soak):
    rec = soak[0]["steady"]
    assert rec["unstable"] == 0 and rec["server_errors"] == 0 and not rec["client_errors"]
    assert rec["requests_completed"] == 4 and rec["supervisor_restarts_on_42"] == 0
    assert rec["max_rss_mb_limit"] == 8192 and rec["ok"]


@pytest.mark.parametrize("kind,record", [("recycle", "serve_soak_2k.json"),
                                         ("steady", "serve_soak_2k_steady.json")])
def test_soak_record_fields(soak, kind, record):
    rec = soak[0][kind]
    ref = committed(record)
    assert set(ref) <= set(rec) and ENV_KEYS <= set(rec)
    for g in rec["generations"]:
        assert set(ref["generations"][0]) <= set(g)
    for row in rec["latency_by_class"].values():
        assert set(next(iter(ref["latency_by_class"].values()))) <= set(row)
        assert row["p50_ms"] <= row["p99_ms"]


@pytest.mark.parametrize("preset", [p for p, _, _ in serve_soak.PRESETS])
def test_soak_pins_match_reference(soak, preset):
    """Every pinned answer of a preset (any wire) against the reference."""
    _, pins = soak
    spec = next(s for s in serve_soak.specs(SHAPE, R) if s[0] == preset)
    keys = [k for k in pins if k[0] == preset]
    assert keys
    for _, dtype, _ in keys:
        left, right = serve_bench.wire_images({"left": spec[1], "right": spec[2]}, dtype)
        hold(pins[(preset, dtype, _)], ref_map(preset, left, right))


def _child(rc: int) -> list:
    return [sys.executable, "-c",
            f"import sys, time; b = bytearray(64 << 20); b[::4096] = b'x' * len(b[::4096]); "
            f"time.sleep(0.8); sys.exit({rc})"]


@pytest.mark.parametrize("rc", [0, 3])
def test_soak_runner_passes_child_returncode(tmp_path, rc):
    out = tmp_path / "soak.json"
    assert soak_runner.main(["--out", str(out), "--interval", "0.1", "--", *_child(rc)]) == rc
    rec = json.loads(out.read_text())
    assert rec["returncode"] == rc and not rec["timed_out"]
    assert rec["samples"] == len(rec["rss_curve"]) >= 2
    assert rec["rss_mb_peak"] >= 64 and rec["rss_mb_first"] <= rec["rss_mb_peak"]
    # the fields the reference's soak_runner writes (sweep_1k_soak.json holds
    # them and the notes added by hand)
    written = {"cmd", "returncode", "wall_s", "rss_mb_first", "rss_mb_peak", "rss_mb_last",
               "samples", "interval_s", "rss_curve"}
    assert written <= set(committed("sweep_1k_soak.json")) and written <= set(rec)


def test_soak_runner_kills_a_child_past_its_deadline(tmp_path):
    cmd = [sys.executable, "-c", "import time; time.sleep(60)"]
    rec = soak_runner.run(cmd, str(tmp_path / "soak.json"), interval=0.1, timeout_s=1.0)
    assert rec["timed_out"] and rec["returncode"] != 0 and rec["wall_s"] < 30
