"""The separable mode's accuracy contract against exact ASW at KITTI.

The counterpart of the repository's ``tools/pin_sep_accuracy.py``.  The
separable O(K) mode approximates exact symmetric ASW; its contract
(``config.SEP_CONTRACT``) is three bounds over seeds 0 1 2 at KITTI
geometry:

  1. smooth scenes (``synthetic.make_pair``): the separable map differs
     from the exact one by at most 1% bad-2.0;
  2. hard scenes (``make_hard_pair``: sensor noise, textureless patches,
     brightness mismatch): at most 1% bad-2.0 on the pixels exact itself
     gets right (|exact - GT| <= 2);
  3. hard scenes: separable costs at most 0.3 pp of bad-2.0 against GT.

``--left-only`` measures the separable left-only mode (``kitti_seplo``)
against the same exact symmetric run.  Both run on the kernels (K1 and K2
on the card).  At KITTI each row's bad-2.0 against GT, exact and
separable, must be within 0.005 of the same (regime, seed) row of the
reference's record (``RECORDS``).

    python -m aswstereomatch_torch.tools.pin_sep_accuracy [--seeds 0 1 2] [--left-only]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import SEP_CONTRACT, StereoConfig
from ..models import pipeline
from ..utils import evaluate, synthetic
from . import common

CONTRACT = (
    "at KITTI geometry, >= 3 seeds each: (1) smooth scenes raw "
    "separable-vs-exact delta <= 1% bad-2.0 (north-star form); "
    "(2) hard adversarial scenes delta-on-exact-correct <= 1%; "
    "(3) hard-scene GT-accuracy cost <= 0.3pp bad-2.0"
)

# The reference's records of each mode at KITTI (its left-only mode misses
# the contract on the hard regime there); the rows' bad-2.0 against GT are
# held to them within BARS.
RECORDS = {False: "sep_vs_exact_kitti.json", True: "seplo_vs_exact_kitti.json"}
BARS = {"exact_bad2_vs_gt": 0.005, "sep_bad2_vs_gt": 0.005}


def configs(d: int, left_only: bool = False, radius: int = 16):
    base = dict(max_disparity=d, cost="tad_grad", aggregation="asw", window_radius=radius,
                lr_check=True, fill_holes=True, subpixel=True, median_filter=True)
    return (StereoConfig(**base),
            StereoConfig(**base, asw_separable=True, asw_symmetric=not left_only))


def verdict(rows: list) -> dict:
    """The three worst cases against ``SEP_CONTRACT``'s bounds."""
    b_delta = SEP_CONTRACT["delta_bad2_max"]
    b_cost = SEP_CONTRACT["gt_bad2_cost_max"]
    w1 = max(r["delta_bad2_vs_exact"] for r in rows if r["regime"] == "smooth")
    w2 = max(r["delta_bad2_on_exact_correct"] for r in rows if r["regime"] == "hard")
    w3 = max(r["gt_bad2_cost"] for r in rows if r["regime"] == "hard")
    ok = w1 <= b_delta and w2 <= b_delta and w3 <= b_cost
    line = (f"smooth raw delta {w1:.4%} (<={b_delta:.0%}) | hard on-exact-correct "
            f"{w2:.4%} (<={b_delta:.0%}) | hard GT cost {w3 * 100:.3f}pp "
            f"(<={b_cost * 100:.1f}pp) => {'PASS' if ok else 'FAIL'}")
    return {"smooth_delta_max": w1, "hard_delta_on_exact_correct_max": w2,
            "hard_gt_cost_max": w3, "pass": ok, "line": line}


def run(device, seeds=(0, 1, 2), geom: str = "kitti", left_only: bool = False,
        shape=None, radius=None, maps=None, progress=print) -> dict:
    """The contract's rows; ``maps``, where given, receives the (exact,
    separable) maps by (regime, seed)."""
    device = torch.device(device)
    h, w, d = common.geometry(geom, shape)
    cfg_exact, cfg_sep = configs(d, left_only, 16 if radius is None else radius)
    regimes = [
        ("smooth", lambda s: synthetic.make_pair(height=h, width=w, max_disparity=d, seed=s)),
        ("hard", lambda s: synthetic.make_hard_pair(h, w, d, seed=s)),
    ]
    routes = [common.routed_kernels(c, device) for c in (cfg_exact, cfg_sep)]
    rows = []
    for regime, mk in regimes:
        for seed in seeds:
            pair = mk(seed)
            l, r = common.to_device(pair, device)
            nonocc = ~pair["occluded"]
            t0 = time.perf_counter()
            de = pipeline.match_pair(l, r, cfg_exact).cpu().numpy()
            ds = pipeline.match_pair(l, r, cfg_sep).cpu().numpy()
            if maps is not None:
                maps[(regime, seed)] = (de, ds)
            rep_e = evaluate.bad_report(de, pair["gt"], valid=nonocc)
            rep_s = evaluate.bad_report(ds, pair["gt"], valid=nonocc)
            exact_correct = nonocc & (np.abs(de - pair["gt"]) <= 2.0)
            row = {
                "geometry": geom,
                "shape": [h, w, d],
                "regime": regime,
                "seed": seed,
                # the north star's form: the separable map against the exact one
                "delta_bad2_vs_exact": round(evaluate.bad_delta_between(ds, de, 2.0, nonocc), 6),
                # the same on the pixels exact gets right
                "delta_bad2_on_exact_correct": round(
                    evaluate.bad_delta_between(ds, de, 2.0, exact_correct), 6),
                # GT-accuracy cost of the approximation (negative: separable better)
                "gt_bad2_cost": round(rep_s["bad_2"] - rep_e["bad_2"], 6),
                "exact_bad2_vs_gt": round(rep_e["bad_2"], 6),
                "sep_bad2_vs_gt": round(rep_s["bad_2"], 6),
                "exact_epe": round(rep_e["epe"], 5),
                "sep_epe": round(rep_s["epe"], 5),
                "wall_s": round(time.perf_counter() - t0, 2),
                # the reference's compile source; here the kernels each config ran on
                "compile_source": ["+".join(k) or "eager" for k in routes],
            }
            rows.append(row)
            progress(row)
    full = shape is None and radius is None and geom == "kitti"
    record = RECORDS[left_only]
    checks = common.hold(rows, common.reference_rows(record), lambda r: (r["regime"], r["seed"]),
                         BARS, f"bench_results/{record}") if full else []
    return {
        "contract": CONTRACT,
        "left_only": left_only,
        "config_hash_exact": cfg_exact.config_hash(),
        "config_hash_sep": cfg_sep.config_hash(),
        "rows": rows,
        "bounds": dict(SEP_CONTRACT),
        "verdict": verdict(rows),
        "checks": checks,
        "held_to_records": full,
        "ok": all(c["ok"] for c in checks),
        "kernels_routed": sorted({k for ks in routes for k in ks}),
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("sep_vs_exact_kitti", __doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--geom", default="kitti")
    ap.add_argument("--left-only", action="store_true",
                    help="measure the separable left-only mode (kitti_seplo) against the "
                         "same exact symmetric run (pass a distinct --out, e.g. "
                         "results_torch/seplo_vs_exact_kitti.json)")
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("pin_sep_accuracy", device, lambda: run(
        device, args.seeds, args.geom, args.left_only, args.shape, args.radius))
    common.write_record(args.out, rec)
    print("wrote", args.out)
    print(rec["verdict"]["line"])
    print(common.summary(rec["checks"]))
    return 0 if rec["verdict"]["pass"] and rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
