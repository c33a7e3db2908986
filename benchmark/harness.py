"""One run of one benchmark cell: set-up, the measured window, the check of
every answer against the plain reference, and the result line.

Everything particular to a cell is found by name from ``BENCHMARK.json``:

  - the configuration: ``benchmark/configs/<config>.json`` (the engine's
    fields as run, the geometry, the reference's aggregation module, the
    aggregation kernels' names and the limits of the numbers compared);
  - the traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind``
    names its runner, ``benchmark/traffic/<kind>.py``;
  - every metric but ``setup_s``: ``benchmark/metrics/<name>.py``, whose
    ``read(obs)`` returns the metric from the window's observations, or None
    where it finds nothing to read (the metric is then left out).

A runner's ``run(ctx)`` does the set-up the mix needs, measures for
``ctx.seconds`` and returns an ``Observed``.  The set-up time runs from the
start of the process to the start of the window.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import correctness
from .inputs import evaluate, synthetic
from .reference import plain

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aswstereomatch_tpu")


@dataclass
class Request:
    """One request of the window: which input pair, when it was sent and
    when its answer was in host memory (harness clock, seconds), and what
    the layers reported of it."""

    key: int
    t0: float
    t1: float
    variant: int | None = None        # its answer's variant, where the sample kept it
    call_s: float | None = None       # the in-process call until it returned
    elapsed_ms: float | None = None   # the daemon's own time
    error: str | None = None

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


@dataclass
class Observed:
    """What a runner saw in its window."""

    requests: list
    window_start: float
    window_s: float
    sample: correctness.Sample
    answer_form: str
    memory_peak_bytes: int
    trace: object = None              # tracing.Trace of a traced run
    config: dict = field(default_factory=dict)
    good: list = field(default_factory=list)  # requests with a correct answer


@dataclass
class Context:
    """What a runner is given."""

    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict
    traffic: dict
    pool: list
    device: str = "cuda"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _module(BENCH_DIR / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def runner(kind: str):
    return importlib.import_module(f"{__package__}.traffic.{kind}")


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic and metrics by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    e2e = mine(bench["end_to_end"])
    names = {m["name"] for m in e2e}
    layer = [m for m in mine(bench["per_layer"]) if m["moves"] in names]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": layer}


def require_devices(n: int) -> None:
    """Exit with an error, printing no result, without ``n`` CUDA devices:
    a measurement never falls back to the CPU."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: this cell needs {n} CUDA device(s); found {have}", file=sys.stderr)
        raise SystemExit(2)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip() or "(no nvidia-smi output)"
    except (OSError, subprocess.SubprocessError) as e:
        return f"(nvidia-smi: {e})"


def pair_seeds(seed: int, n: int) -> list:
    """``n`` input seeds drawn from the run's seed (any whole number)."""
    ss = np.random.SeedSequence(seed & (2**64 - 1))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64)]


def make_pool(config: dict, seed: int, n: int) -> list:
    """``n`` synthetic pairs at the configuration's geometry, uint8, made in
    threads; the same seed gives the same pairs."""
    h, w, d = config["height"], config["width"], config["stereo_config"]["max_disparity"]

    def one(s):
        p = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=s)
        return {"left": p["left"].astype(np.uint8), "right": p["right"].astype(np.uint8),
                "gt": p["gt"], "occluded": p["occluded"]}

    with concurrent.futures.ThreadPoolExecutor(max_workers=min(n, 4)) as ex:
        return list(ex.map(one, pair_seeds(seed, n)))


def verify(obs: Observed, ctx: Context, device: str) -> dict:
    """The sampled answers against the reference's map of their pairs; keeps
    the requests not found wrong in ``obs.good``."""
    t0 = time.perf_counter()
    reads, bad2 = {}, []
    for key, variants in sorted(obs.sample.variants.items()):
        pair = ctx.pool[key]
        ref = plain.disparity(pair["left"], pair["right"], ctx.config["stereo_config"],
                              ctx.config["reference"], device=device)
        bad2.append(evaluate.bad_delta(ref, pair["gt"], 2.0, ~pair["occluded"]))
        for i, answer in enumerate(variants):
            reads[(key, i)] = correctness.readings(answer, ref, obs.answer_form)
    checks, bad = correctness.judge(reads, ctx.config["limits"][obs.answer_form])
    obs.good = [r for r in obs.requests if r.error is None and (r.key, r.variant) not in bad]
    worst = {n: max((r[n] for r in reads.values()), default=0.0) for n in correctness.READINGS}
    print(f"readings over {obs.sample.drawn} drawn answers, {len(reads)} distinct: "
          + ", ".join(f"{n} {v!r}" for n, v in worst.items())
          + f"; reference {time.perf_counter() - t0:.1f} s, its bad-2.0 against the ground "
          + "truth " + ", ".join(f"{b:.4f}" for b in bad2), file=sys.stderr)
    return checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, bench=None,
             config=None, device: str = "cuda", t_start: float | None = None,
             check_devices=require_devices) -> tuple:
    """One run: ``(result, status)``; ``result`` is the result line's object
    or None, ``status`` the exit code."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench if bench is not None else load_json(REPO / "BENCHMARK.json")
    spec = resolve(bench, workload)
    if config is not None:
        spec["config"] = config
    check_devices(spec["cell"]["chips"])
    print(f"card: {card_line()}", flush=True)
    traffic = spec["traffic"]
    t_pool = time.perf_counter()
    ctx = Context(seed, seconds, trace, spec["cell"]["chips"], spec["config"],
                  traffic, make_pool(spec["config"], seed, traffic["pool"]), device)
    t_runner = time.perf_counter()
    obs = runner(traffic["kind"]).run(ctx)
    print(f"set-up: {t_pool - t_start:.2f} s to the pool, {t_runner - t_pool:.2f} s the pool, "
          f"{obs.window_start - t_runner:.2f} s the runner's set-up", file=sys.stderr)
    obs.config = spec["config"]
    setup_s = obs.window_start - t_start
    gc.collect()
    checks = verify(obs, ctx, device)
    errors = [r.error for r in obs.requests if r.error is not None]
    for e in sorted(set(errors))[:5]:
        print(f"request error: {e}", file=sys.stderr)
    correct = (obs.sample.drawn > 0 and len(obs.good) == len(obs.requests)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = setup_s if m["name"] == "setup_s" else metric_reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": ctx.chips, "memory_peak_bytes": obs.memory_peak_bytes}
    result = {"correct": correct, "attempted": len(obs.requests),
              "failed": len(obs.requests) - len(obs.good), "metrics": metrics, "device": dev}
    if trace and obs.trace is not None:
        dev["busy_s"] = obs.trace.busy_s
        dev["window_s"] = obs.trace.window_s
        result["breakdown"] = obs.trace.breakdown()
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return None, 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result, 0


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, status = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=t_start)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return status
