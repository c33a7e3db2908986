"""Shared pieces of the port's accuracy and validation tools.

Every tool in this package has a ``run(...)`` that takes a ``device`` and
returns its record, and a ``main()`` with ``--device cuda|cpu`` (default
``cuda``, which raises without a card: nothing carries on on the CPU unless
``--device cpu`` asks for it) and ``--out`` (default
``results_torch/<name>.json``).  On the card ``main()`` holds the device
lock (``utils/devlock.py``).  A record carries the reference tool's fields
plus ``environment()``: the card's name, its power limit as ``nvidia-smi``
reports it, and the torch and CUDA versions.

The accuracy tools hold their rows to the reference's committed records in
``bench_results/`` (``reference_rows``, ``hold``): only accuracy columns,
never times (those were taken on a TPU).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..models import pipeline
from ..ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel, asw_sym_dlanes_kernel,
                        sgm_kernel)
from ..utils import devlock, profiling, synthetic

REPO = Path(__file__).resolve().parents[2]
RESULTS_DIR = "results_torch"
# The kernels by the names chip_smoke.py prints; each module counts its
# launches on the card in ``launches``.
KERNELS = {"K1": asw_kernel, "K2": asw_sep_kernel, "K3": asw_dlanes_kernel,
           "K4": asw_sym_dlanes_kernel, "SGM": sgm_kernel}


def launch_counts() -> dict:
    """Each kernel's launches since its last reset."""
    return {name: m.launches for name, m in KERNELS.items()}


def routed_kernels(cfg, device) -> list:
    """The kernels one ``pipeline.match_pair(l, r, cfg)`` launches, once each,
    for tensors on ``device``: ``kernel_for``'s choice where the pair takes
    the kernel route, the SGM scan kernel for SGM on the card, none off the
    card (a wrapper given CPU tensors computes its plain version)."""
    device = torch.device(device)
    if device.type != "cuda":
        return []
    if pipeline._resolve_backend(cfg, device) == "cuda":
        kernel = pipeline.kernel_for(cfg)
        return [name for name, m in KERNELS.items() if m is kernel]
    return ["SGM"] if cfg.aggregation == "sgm" else []


def predicted_launches(cfg, device, calls: int = 1) -> dict:
    """Every kernel's launches for ``calls`` ``match_pair`` calls of ``cfg``."""
    routed = routed_kernels(cfg, device)
    return {name: calls if name in routed else 0 for name in KERNELS}


@contextlib.contextmanager
def kernel_route(device):
    """Within the context, a config that a kernel serves takes the kernel
    route on ``device`` whatever device that is: on the card it does so
    anyway; on the CPU ``pipeline._resolve_backend`` answers "cuda" for it
    (not for ``backend="eager"``), so each kernel wrapper, given CPU
    tensors, computes its plain version, as the reference's tools run its
    Pallas kernels in interpret mode on the CPU."""
    if torch.device(device).type == "cuda":
        yield
        return
    original = pipeline._resolve_backend

    def resolve(cfg, dev):
        if cfg.backend != "eager" and pipeline.kernel_for(cfg) is not None:
            return "cuda"
        return original(cfg, dev)

    pipeline._resolve_backend = resolve
    try:
        yield
    finally:
        pipeline._resolve_backend = original


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on: the card for "cuda", which must exist."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda needs a CUDA device; pass --device cpu to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if name != "cpu":
        raise ValueError(f"unknown device {name!r} (cuda or cpu)")
    return torch.device("cpu")


def child_env() -> dict:
    """The environment of a child ``python -m aswstereomatch_torch...``: this
    checkout first on its module path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def log_tail(path, nbytes: int = 4000) -> str:
    """The last ``nbytes`` of a child's log, for a failure message."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


def stop(proc, timeout_s: float = 30.0) -> None:
    """Terminate a child process and wait for it, killing it if it lingers."""
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def card_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    None where nvidia-smi is not there."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def environment(device) -> dict:
    """The record fields that say where a run ran."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    line = card_line() if on_card else None
    return {
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "power_limit": line.rsplit(",", 1)[-1].strip() if line else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def parser(name: str, doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the CPU's "
                         "plain PyTorch path")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, f"{name}.json"),
                    help="where the record goes")
    return ap


def add_shape_args(ap: argparse.ArgumentParser) -> None:
    """``--shape H W D`` and ``--radius R``: a cut-down run (for the CPU)."""
    ap.add_argument("--shape", type=int, nargs=3, metavar=("H", "W", "D"),
                    help="run every scene at this (height, width, max "
                         "disparity) instead of its dataset geometry; a cut-down "
                         "run is not held to the committed records")
    ap.add_argument("--radius", type=int,
                    help="window radius in place of the configs' 16")


def write_record(path: str, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def run_main(label: str, device: torch.device, fn: Callable):
    """``fn()``, holding the device lock on the card."""
    lock = (devlock.device_lock(label, timeout_s=300) if device.type == "cuda"
            else contextlib.nullcontext())
    with lock:
        return fn()


def geometry(name: str, shape=None) -> tuple:
    """(H, W, D) of a dataset geometry, or the cut-down ``shape``."""
    return tuple(shape) if shape is not None else synthetic.GEOMETRIES[name]


def dataset_pair(name: str, seed: int, shape=None) -> dict:
    """``synthetic.make_dataset_pair(name, seed)``, or the same scene seed
    at the cut-down ``shape``."""
    if shape is None:
        return synthetic.make_dataset_pair(name, seed=seed)
    h, w, d = shape
    seed += synthetic._SCENE_SEED_OFFSET.get(name.lower(), 0)
    return synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)


def to_device(pair: dict, device) -> tuple:
    return (torch.from_numpy(np.ascontiguousarray(pair["left"], np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(pair["right"], np.float32)).to(device))


def rates(fn: Callable, left, right, iters: int = 3, queue: int = 8):
    """``(disp, fields)``: the first call's time with its build or load
    (``compile_s``), pairs/s of the best of ``iters`` synchronised calls,
    and pairs/s with ``queue`` calls queued back to back and one wait at
    the end (``pairs_per_s_queued``), as the reference measures them."""
    t0 = time.perf_counter()
    profiling.force_sync(fn(left, right))
    compile_s = time.perf_counter() - t0
    best_s, _, out = profiling.time_fn(fn, left, right, iters=iters, warmup=0)
    t0 = time.perf_counter()
    outs = [fn(left, right) for _ in range(queue)]
    profiling.force_sync(outs[-1])
    queued_s = (time.perf_counter() - t0) / queue
    return out.cpu().numpy(), {
        "pairs_per_s": round(1.0 / best_s, 4),
        "pairs_per_s_queued": round(1.0 / queued_s, 4),
        "compile_s": round(compile_s, 3),
    }


def reference_rows(filename: str) -> list:
    """The rows of a committed record of the reference in ``bench_results/``."""
    with open(REPO / "bench_results" / filename) as f:
        rec = json.load(f)
    return rec["rows"] if isinstance(rec, dict) else rec


def hold(rows: Iterable[dict], ref_rows: Iterable[dict], key: Callable,
         bars: dict, source: str) -> list:
    """Each of ``rows`` against every row of ``ref_rows`` with the same
    ``key(row)``: one check per (row, reference row, field), ``ok`` where
    |ours - reference| <= ``bars[field]``.  Rows without a reference row
    are not checked."""
    ref = {}
    for r in ref_rows:
        ref.setdefault(key(r), []).append(r)
    checks = []
    for row in rows:
        for r in ref.get(key(row), []):
            for field, bar in bars.items():
                diff = abs(float(row[field]) - float(r[field]))
                checks.append({"key": list(key(row)), "field": field, "ours": row[field],
                               "reference": r[field], "bar": bar, "source": source,
                               "ok": bool(diff <= bar)})
    return checks


def summary(checks: list) -> str:
    bad = [c for c in checks if not c["ok"]]
    return (f"{len(checks) - len(bad)}/{len(checks)} accuracy checks within their bars"
            + "".join(f"; MISSED {c['key']} {c['field']} {c['ours']} vs {c['reference']} "
                      f"({c['source']}, bar {c['bar']})" for c in bad))
