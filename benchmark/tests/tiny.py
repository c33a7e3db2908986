"""A cell cut to a size the CPU runs in a second, for the tests: the
configuration's file with a small geometry, run on the CPU with the look
for a card skipped.

``bench()`` is ``BENCHMARK.json`` with the two serve cells added: their
runner, mixes and metrics are in ``benchmark/``, but their runs on the
card spread too widely for a bound (PERF.md §6), so ``BENCHMARK.json``
does not name them yet.
"""

from __future__ import annotations

import copy

from benchmark import harness

SHAPE = {"height": 24, "width": 40, "max_disparity": 8, "window_radius": 3}

SERVE_CELLS = [
    {"name": f"kitti_sep.serve_c{n}", "config": "kitti_sep", "traffic": f"serve_c{n}",
     "chips": 1, "why": f"{n} closed-loop rigs over the daemon's socket"} for n in (4, 1)]
SERVE_METRICS = [
    {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "serving daemon (tools/serve)", "moves": "latency_p50_ms",
     "workloads": [c["name"] for c in SERVE_CELLS]}
    for name in ("serve.elapsed_ms_p50", "serve.wire_ms_p50")]


def bench() -> dict:
    doc = copy.deepcopy(harness.load_json(harness.REPO / "BENCHMARK.json"))
    doc["workloads"] += SERVE_CELLS
    doc["per_layer"] += SERVE_METRICS
    return doc


def config(name: str) -> dict:
    """Configuration ``name`` at ``SHAPE``."""
    doc = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json"))
    doc["height"], doc["width"] = SHAPE["height"], SHAPE["width"]
    small = {k: SHAPE[k] for k in ("max_disparity", "window_radius")}
    doc["stereo_config"].update(small)
    doc["overrides"].update(small)
    return doc


def run(workload: str, trace: bool = False, seconds: float = 1.0, seed: int = 2**31 + 7) -> dict:
    """One run of ``workload`` at the small size on the CPU; its result."""
    doc = bench()
    cell = next(w for w in doc["workloads"] if w["name"] == workload)
    result, status = harness.run_cell(workload, seed, seconds, trace, bench=doc,
                                      config=config(cell["config"]), device="cpu",
                                      check_devices=lambda n: None)
    assert status == 0
    return result
