"""Randomized fuzz of the whole pipeline across configs, routes and layouts.

The counterpart of the repository's ``tools/fuzz_pipeline.py``.  Each
trial draws a geometry and a ``StereoConfig`` in the reference's rng order
(``tools/fuzz_pipeline.py:52-80``; ``backend="cuda"`` where the reference
forces "pallas") and checks, on one device:

  1. the kernel route against ``backend="eager"``: |d_kernel - d_eager| <=
     0.51 on more than 99% of pixels;
  2. y-tiled over a mesh of the device repeated n = 2 or 4 times equal to
     untiled, bit for bit (where each band holds r + 1 rows);
  3. on every third trial, a batch of two equal to single calls;
  4. for D divisible by 4, d-sharded over 4 shards equal to the unsharded
     run on ``kernel_layout="xlanes"`` (K1, whose disparity window the
     d-shards use), and for separable ASW the eager d-sharded run equal to
     the eager one.

On the CPU the kernel route runs the kernels' plain versions
(``common.kernel_route``).

    python -m aswstereomatch_torch.tools.fuzz_pipeline --trials 12 [--seed0 1000]

Exit code 0 = no counterexample found.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from ..config import StereoConfig
from ..models import pipeline
from ..parallel import dshard, mesh as mesh_lib, tiling
from ..utils import synthetic
from . import common


def draw_trial(seed: int):
    """(cfg, (h, w), rng): the trial's config and geometry, and its rng at
    the point where the reference draws the tile count."""
    rng = np.random.default_rng(seed)
    D = int(rng.choice([4, 8, 12, 16]))
    agg = str(rng.choice(["asw", "asw", "box"]))
    cfg = StereoConfig(
        max_disparity=D,
        window_radius=int(rng.choice([1, 2, 3, 4])),
        cost=str(rng.choice(["ad", "tad_grad"])),
        asw_symmetric=bool(rng.choice([True, False])),
        aggregation=agg,
        asw_separable=(agg == "asw" and bool(rng.choice([True, False, False]))),
        gamma_color=float(rng.uniform(5, 30)),
        gamma_spatial=float(rng.uniform(5, 40)),
        alpha=float(rng.uniform(0.5, 1.0)),
        lr_check=bool(rng.choice([True, False])),
        fill_holes=True,
        subpixel=bool(rng.choice([True, False])),
        median_filter=bool(rng.choice([True, False])),
        median_mode=str(rng.choice(["plain", "weighted"])),
        backend="cuda",
    )
    h = int(rng.integers(12, 40))
    w = int(rng.integers(max(24, D + 8), 90))
    return cfg, (h, w), rng


def _equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if not np.array_equal(g, w):
        raise AssertionError(f"{name} differs from the untiled map at "
                             f"{int((g != w).sum())} of {g.size} pixels")


def run_trial(t: int, seed: int, device) -> dict:
    """Trial ``t`` (the batch check runs where t % 3 == 0) from ``seed``."""
    device = torch.device(device)
    cfg, (h, w), rng = draw_trial(seed)
    D = cfg.max_disparity
    label = (f"seed={seed} {h}x{w} D={D} r={cfg.window_radius} "
             f"{cfg.aggregation}{'' if cfg.asw_symmetric else '/lo'}"
             f"{'/sep' if cfg.asw_separable else ''} {cfg.cost} lr={cfg.lr_check} "
             f"sub={cfg.subpixel} med={cfg.median_filter}/{cfg.median_mode}")
    pair = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=seed)
    l, r = common.to_device(pair, device)
    checks = []
    routed = common.routed_kernels(cfg, device)
    t0 = time.perf_counter()
    try:
        d_k = pipeline.match_pair(l, r, cfg)
        d_e = pipeline.match_pair(l, r, cfg.replace(backend="eager"))
        agree = float(np.mean(np.abs(d_k.cpu().numpy() - d_e.cpu().numpy()) <= 0.51))
        if not agree > 0.99:
            raise AssertionError(f"kernel vs eager agree {agree:.4%}")
        checks.append("kernel~eager")

        n = int(rng.choice([2, 4]))
        if h // n >= cfg.window_radius + 1:
            m = mesh_lib.build_mesh(1, n, [device] * n)
            _equal(f"y-tiled on {n}", tiling.match_pair_tiled(l, r, cfg, m), d_k)
            checks.append(f"y{n}")

        if t % 3 == 0:
            d_b = pipeline.match_batch(torch.stack([l, l]), torch.stack([r, r]), cfg)
            _equal("batch[0]", d_b[0], d_k)
            _equal("batch[1]", d_b[1], d_k)
            checks.append("batch")

        if D % 4 == 0 and cfg.aggregation in ("asw", "box"):
            m = mesh_lib.build_mesh(1, 4, [device] * 4)
            if cfg.asw_separable:
                # no separable kernel takes a disparity window: the eager
                # d-sharded run against the eager one
                e_cfg = cfg.replace(backend="eager")
                _equal("d-sharded (eager)", dshard.match_pair_dsharded(l, r, e_cfg, m), d_e)
            else:
                x_cfg = cfg.replace(kernel_layout="xlanes")
                routed += common.routed_kernels(x_cfg, device)
                ref_x = pipeline.match_pair(l, r, x_cfg)
                _equal("d-sharded", dshard.match_pair_dsharded(l, r, cfg, m), ref_x)
            checks.append("d4")
    except Exception as e:  # noqa: BLE001 - any failure is a finding
        return {"seed": seed, "label": label, "status": "FAIL", "checks": checks,
                "error": traceback.format_exc(),
                "line": f"[FAIL] {label}\n  {type(e).__name__}: {e}"}
    return {"seed": seed, "label": label, "status": "ok", "checks": checks, "agree": agree,
            "kernels_routed": sorted(set(routed)),
            "line": f"[ok] {label} {'+'.join(checks)} ({time.perf_counter() - t0:.1f}s)"}


def run(device, trials: int = 12, seed0: int = 1000, progress=print) -> dict:
    device = torch.device(device)
    t_start = time.perf_counter()
    rows = []
    with common.kernel_route(device):
        for t in range(trials):
            rows.append(run_trial(t, seed0 + t, device))
            progress(rows[-1]["line"])
    return {
        "what": "kernel route vs eager, y-tiled, batch and d-sharded against unsharded, "
                "over random configs (the reference's tools/fuzz_pipeline.py draws)",
        "trials": trials, "seed0": seed0,
        "failures": sum(r["status"] == "FAIL" for r in rows),
        "wall_s": round(time.perf_counter() - t_start, 1),
        "kernels_routed": sorted({k for r in rows for k in r.get("kernels_routed", [])}),
        "route": "kernels" if device.type == "cuda" else "the kernels' plain versions (CPU)",
        "rows": rows,
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("fuzz_pipeline", __doc__)
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--seed0", type=int, default=1000)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("fuzz_pipeline", device, lambda: run(device, args.trials, args.seed0))
    common.write_record(args.out, rec)
    print(f"done: {args.trials} trials, {rec['failures']} failures; record {args.out}")
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
