"""Randomized fuzz of the kernel route against the eager path on the card.

The counterpart of the repository's ``tools/tpu_fuzz.py``.  The fixed
geometries of ``chip_smoke.py`` leave most of K1-K4's tile plans (a
(TY, TX, DC, KX) block plan picked in Python per shape) unrun; this draws
random configs and geometries, each trial's in the reference's rng order
(weight mode, separable, bfloat16 storage, box, cost, r in 1..32, D in
4..64, LR, subpixel, median mode, uniqueness 0/5/15), and holds
``match_pair`` on the routed kernel against ``backend="eager"`` on the same
device at the reference's bars: |d_kernel - d_eager| <= 0.51 on more than
99% of pixels and > 2 on fewer than 0.5%.  A trial ``kernel_for`` routes to
the eager path is printed as skipped.  Around every kernel-route call the
kernels' launch counts must equal ``common.predicted_launches``.

The d-window trials run one d-shard's windowed K1 call
(``parallel/dshard.py::shard_wta_outputs``) against the windowed argmin of
the eager aggregated volume and of its right view: agreement > 0.995 in
both views, the winner's cost within 1e-2.

    python -m aswstereomatch_torch.tools.card_fuzz --trials 24 [--seed0 5000]

Exit code 0 = no counterexample; a failure prints its config for replay.
A build or launch error is a failure.
"""

from __future__ import annotations

import sys
import time
import traceback
import warnings

import numpy as np
import torch

from ..config import StereoConfig
from ..models import pipeline
from ..ops import aggregate, postprocess
from ..parallel import dshard
from ..utils import synthetic
from . import common


def draw_trial(seed: int):
    """(cfg, (h, w), pair seed) of one general trial, drawn in the
    reference's order (``tools/tpu_fuzz.py:134-164``)."""
    rng = np.random.default_rng(seed)
    r = int(rng.choice([1, 2, 3, 4, 8, 12, 16, 24, 32]))
    D = int(rng.choice([4, 8, 16, 32, 64]))
    agg = str(rng.choice(["asw", "asw", "asw", "box"]))
    sep = bool(rng.integers(2)) if agg == "asw" else False
    cfg = StereoConfig(
        max_disparity=D,
        cost=str(rng.choice(["tad_grad", "ad"])),
        aggregation=agg,
        window_radius=r,
        asw_symmetric=bool(rng.integers(2)) if agg == "asw" else True,
        asw_separable=sep,
        volume_dtype=str(rng.choice(["float32", "bfloat16"])) if sep else "float32",
        lr_check=bool(rng.integers(2)),
        fill_holes=True,
        subpixel=bool(rng.integers(2)),
        median_filter=bool(rng.integers(2)),
        median_mode=str(rng.choice(["plain", "weighted"])),
        uniqueness_ratio=float(rng.choice([0.0, 0.0, 5.0, 15.0])),
    )
    h = int(rng.integers(3 * r + 9, 3 * r + 41))
    w = max(int(rng.integers(D + 4 * r + 16, D + 4 * r + 160)), 2 * D)
    return cfg, (h, w), int(rng.integers(1 << 16))


def draw_dwindow_trial(seed: int):
    """(cfg, (h, w), pair seed, k, n) of one d-window trial, in the
    reference's order (``tools/tpu_fuzz.py:52-67``)."""
    rng = np.random.default_rng(seed)
    r = int(rng.choice([2, 4, 8, 16]))
    D = int(rng.choice([16, 32, 64]))
    n = int(rng.choice([2, 4]))
    k = int(rng.integers(n))
    cfg = StereoConfig(
        max_disparity=D,
        cost=str(rng.choice(["tad_grad", "ad"])),
        aggregation="asw",
        window_radius=r,
        asw_symmetric=bool(rng.integers(2)),
    )
    h = int(rng.integers(3 * r + 9, 3 * r + 33))
    w = max(int(rng.integers(D + 4 * r + 16, D + 4 * r + 128)), 2 * D)
    return cfg, (h, w), int(rng.integers(1 << 16)), k, n


def _label(cfg: StereoConfig, h: int, w: int) -> str:
    return (f"r={cfg.window_radius} D={cfg.max_disparity} {cfg.aggregation}"
            f"{' sep' if cfg.asw_separable else ''}"
            f"{' bf16' if cfg.volume_dtype == 'bfloat16' else ''}"
            f"{' lo' if not cfg.asw_symmetric else ''} {h}x{w}")


def _quiet(fn, *args):
    """``fn(*args)`` without the eager path's bfloat16 warning: the eager
    comparison stores the volume in float32, as the reference's jnp one."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args)


def _launches_since(before: dict) -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: v - before[k] for k, v in common.launch_counts().items()}


def run_trial(seed: int, device) -> dict:
    """One general trial on ``device``: its row (``status`` ok / FAIL /
    skip, agreement, gross share, launches against the prediction)."""
    device = torch.device(device)
    cfg, (h, w), pseed = draw_trial(seed)
    row = {"seed": seed, "config": _label(cfg, h, w), "cfg": repr(cfg)}
    if _quiet(pipeline._resolve_backend, cfg, device) != "cuda":
        return {**row, "status": "skip", "line": f"skip  eager-routed {_label(cfg, h, w)}"}
    pair = synthetic.make_pair(height=h, width=w, max_disparity=cfg.max_disparity, seed=pseed)
    l, r = common.to_device(pair, device)
    kernel = next(n for n, m in common.KERNELS.items() if m is pipeline.kernel_for(cfg))
    want = common.predicted_launches(cfg, device)
    before = common.launch_counts()
    try:
        d_k = pipeline.match_pair(l, r, cfg).cpu().numpy()
    except Exception as e:  # noqa: BLE001 - a build or launch error is a finding
        return {**row, "status": "FAIL", "error": traceback.format_exc(),
                "line": f"CRASH {kernel} {_label(cfg, h, w)}: {type(e).__name__}: {e}"}
    got = _launches_since(before)
    d_e = _quiet(pipeline.match_pair, l, r, cfg.replace(backend="eager")).cpu().numpy()
    agree = float(np.mean(np.abs(d_k - d_e) <= 0.51))
    gross = float(np.mean(np.abs(d_k - d_e) > 2.0))
    ok = agree > 0.99 and gross < 0.005 and got == want
    line = (f"{'ok ' if ok else 'FAIL'} {kernel:3s} {_label(cfg, h, w)} agree={agree:.4f} "
            f"gross={gross:.4f} launches={ {k: v for k, v in got.items() if v} }")
    if got != want:
        line += f" (predicted { {k: v for k, v in want.items() if v} })"
    return {**row, "status": "ok" if ok else "FAIL", "kernel": kernel, "agree": agree,
            "gross": gross, "launches": got, "predicted_launches": want, "line": line}


def run_dwindow_trial(seed: int, device) -> dict:
    """One d-window trial: shard ``k`` of ``n``'s windowed K1 outputs
    against the eager volume's windowed argmin, both views."""
    device = torch.device(device)
    cfg, (h, w), pseed, k, n = draw_dwindow_trial(seed)
    D = cfg.max_disparity
    ds = D // n
    row = {"seed": seed, "config": f"dwindow k={k}/{n} {_label(cfg, h, w)}", "cfg": repr(cfg)}
    pair = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=pseed)
    l, r = common.to_device(pair, device)
    want = common.predicted_launches(cfg.replace(kernel_layout="xlanes"), device)
    before = common.launch_counts()
    try:
        outs = dshard.shard_wta_outputs(l, r, cfg, k, n)
        bestc, bestd, _, _, rbestc, rbestd = (t.cpu().numpy() for t in outs)
    except Exception as e:  # noqa: BLE001
        return {**row, "status": "FAIL", "error": traceback.format_exc(),
                "line": f"CRASH {row['config']}: {type(e).__name__}: {e}"}
    got = _launches_since(before)
    vol_t = aggregate.aggregated_volume(l, r, cfg)
    vol = vol_t.cpu().numpy()
    volr = postprocess.right_volume(vol_t).cpu().numpy()
    d0 = k * ds
    exp_d = d0 + np.argmin(vol[..., d0:d0 + ds], axis=-1)
    exp_rd = d0 + np.argmin(volr[..., d0:d0 + ds], axis=-1)
    exp_rc = np.min(volr[..., d0:d0 + ds], axis=-1)
    agree = float(np.mean(bestd == exp_d))
    # The right view's d means something only where the window holds a
    # candidate (x' + d < W for some d of the shard); elsewhere both sides
    # carry an inf cost with any d, which the combine resolves by cost.
    has_cand = np.isfinite(exp_rc)
    inf_match = float(np.mean(np.isfinite(rbestc) == has_cand))
    ragree = float(np.mean(rbestd[has_cand] == exp_rd[has_cand])) if has_cand.any() else 1.0
    ragree = min(ragree, inf_match)
    cerr = float(np.max(np.abs(bestc - np.take_along_axis(vol, bestd[..., None], -1)[..., 0])))
    ok = agree > 0.995 and ragree > 0.995 and cerr < 1e-2 and got == want
    line = (f"{'ok ' if ok else 'FAIL'} {row['config']} agree={agree:.4f} ragree={ragree:.4f} "
            f"cerr={cerr:.2e} launches={ {k_: v for k_, v in got.items() if v} }")
    return {**row, "status": "ok" if ok else "FAIL", "agree": agree, "ragree": ragree,
            "cerr": cerr, "launches": got, "predicted_launches": want, "line": line}


def run(device, trials: int = 24, dwindow_trials: int = 6, seed0: int = 5000,
        progress=print) -> dict:
    """``trials`` general trials from ``seed0`` and ``dwindow_trials``
    d-window trials from ``seed0 + 100000``, as the reference's defaults
    (on the CPU the kernel route runs the kernels' plain versions,
    ``common.kernel_route``)."""
    device = torch.device(device)
    t_start = time.perf_counter()
    rows = []
    with common.kernel_route(device):
        for t in range(trials):
            rows.append(run_trial(seed0 + t, device))
            progress(f"[{t}] {rows[-1]['line']}")
        for t in range(dwindow_trials):
            rows.append(run_dwindow_trial(seed0 + 100_000 + t, device))
            progress(f"[dw{t}] {rows[-1]['line']}")
    failures = [r for r in rows if r["status"] == "FAIL"]
    routed = sorted({k for r in rows for k, v in r.get("predicted_launches", {}).items() if v})
    return {
        "what": "kernel route vs the eager path on the same device over random configs "
                "and geometries (the reference's tools/tpu_fuzz.py draws), and d-window "
                "K1 shards vs the eager volume's windowed argmin",
        "trials_requested": trials, "dwindow_trials": dwindow_trials, "seed0": seed0,
        "ok": sum(r["status"] == "ok" for r in rows),
        "skipped_eager_routed": sum(r["status"] == "skip" for r in rows),
        "failures": len(failures),
        "wall_s": round(time.perf_counter() - t_start, 1),
        "kernels_routed": routed,
        "route": "kernels" if device.type == "cuda" else "the kernels' plain versions (CPU)",
        "lines": [r["line"] for r in rows],
        "rows": rows,
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("card_fuzz", __doc__)
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--dwindow-trials", type=int, default=6)
    ap.add_argument("--seed0", type=int, default=5000)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("card_fuzz", device, lambda: run(
        device, args.trials, args.dwindow_trials, args.seed0))
    common.write_record(args.out, rec)
    print(f"{args.trials} + {args.dwindow_trials} trials in {rec['wall_s']} s, "
          f"{rec['failures']} failures, {rec['skipped_eager_routed']} skipped; record {args.out}")
    for r in rec["rows"]:
        if r["status"] == "FAIL":
            print("FAILURE:", r["line"], "\n  ", r["cfg"])
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
