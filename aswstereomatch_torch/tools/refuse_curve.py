"""Coverage against bad-2.0: refuse mode as an operating curve (hard regime).

The counterpart of the repository's ``tools/refuse_curve.py``.  The
per-pixel confidence is the WTA-uniqueness margin together with the LR
check (``pipeline.match_pair_with_confidence``): one run per (geometry,
seed, mode) gives the map and its confidence, and each operating point
``uniq >= r`` for r in ``OUR_RATIOS`` is a threshold on the host.  Modes:
exact ASW, separable ASW and SGM (r = 16, LR on, fill and median off), on
``make_hard_pair`` (sensor noise, textureless patches, brightness
mismatch), each with its dense row (fill and median on).

Where ``import cv2`` succeeds, cv2 BM and SGBM swept over their
uniquenessRatio, our dense exact map scored on each cv2 point's kept
pixels, and the pairing of every cv2 point with our curve point of nearest
coverage.  Without cv2 the tool exits non-zero unless ``--no-cv2`` is
given; the record then says ``"cv2": "not run"`` and has no cv2 rows and
no pairing.  At the full geometries our rows' coverage and bad-2.0 must be
within 0.005 of the same (geometry, seed, method, point) rows of
``bench_results/refuse_curve.json``.

    python -m aswstereomatch_torch.tools.refuse_curve [--geom kitti venus] [--seeds 7 8] [--no-cv2]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import StereoConfig
from ..models import pipeline
from ..utils import evaluate, synthetic
from . import common
from .compare_opencv import cv2_refused, import_cv2

OUR_RATIOS = (0.0, 2.0, 5.0, 8.0, 12.0, 18.0, 25.0, 40.0)
CV2_RATIOS = (5, 10, 15)
BARS = {"coverage": 0.005, "bad_2": 0.005}
MODES = (("exact", "asw", False), ("sep", "asw", True), ("sgm", "sgm", False))


def mode_config(D: int, agg: str, sep: bool, radius: int = 16) -> StereoConfig:
    return StereoConfig(max_disparity=D, cost="tad_grad", aggregation=agg, window_radius=radius,
                        asw_separable=sep, lr_check=True, fill_holes=False, subpixel=True,
                        median_filter=False)


def run(geoms, seeds, device, use_cv2: bool = True, shape=None, radius=None, maps=None,
        progress=print) -> dict:
    """The curves; ``maps``, where given, receives each mode's (disp,
    uniq_pct, lr_valid, dense) by (geometry, seed, mode)."""
    device = torch.device(device)
    cv2 = import_cv2() if use_cv2 else None
    rows = []
    routed = set()

    def add(geometry, seed, method, point, disp, keep, gt, nonocc):
        scored = nonocc & keep
        rep = evaluate.bad_report(disp, gt, valid=scored)
        rows.append(dict(geometry=geometry, seed=seed, method=method, point=point,
                         coverage=round(float(scored.sum() / nonocc.sum()), 4),
                         bad_2=round(rep["bad_2"], 5), epe=round(rep["epe"], 4)))
        return rows[-1]

    for name in geoms:
        h, w, D = common.geometry(name, shape)
        for seed in seeds:
            pair = synthetic.make_hard_pair(h, w, D, seed=seed)
            left, right, gt = pair["left"], pair["right"], pair["gt"]
            nonocc = ~pair["occluded"]
            l, r = common.to_device(pair, device)
            for mode, agg, sep in MODES:
                cfg = mode_config(D, agg, sep, 16 if radius is None else radius)
                cfg_dense = cfg.replace(fill_holes=True, median_filter=True)
                routed.update(common.routed_kernels(cfg, device))
                disp, uniq, lrv = (t.cpu().numpy() for t in
                                   pipeline.match_pair_with_confidence(l, r, cfg))
                # the tunable curve: LR gate and uniqueness threshold
                for rr in OUR_RATIOS:
                    add(name, seed, f"ours_{mode}_refuse", f"uniq>={rr:g}",
                        disp, (disp >= 0) & (uniq >= rr), gt, nonocc)
                dense = pipeline.match_pair(l, r, cfg_dense).cpu().numpy()
                if mode == "exact":
                    dense_exact = dense
                add(name, seed, f"ours_{mode}_dense", "fill_all",
                    dense, np.ones_like(nonocc), gt, nonocc)
                if maps is not None:
                    maps[(name, seed, mode)] = (disp, uniq, lrv, dense)

            if cv2 is not None:
                gl = cv2.cvtColor(left.astype(np.uint8), cv2.COLOR_RGB2GRAY)
                gr = cv2.cvtColor(right.astype(np.uint8), cv2.COLOR_RGB2GRAY)
                for ur in CV2_RATIOS:
                    bm = cv2.StereoBM_create(numDisparities=D, blockSize=9)
                    bm.setUniquenessRatio(ur)
                    d_bm = bm.compute(gl, gr).astype(np.float32) / 16.0
                    add(name, seed, "cv2_BM", f"uniq={ur}", d_bm, d_bm >= 0, gt, nonocc)
                    add(name, seed, "ours_exact_dense@BM_mask", f"uniq={ur}",
                        dense_exact, d_bm >= 0, gt, nonocc)
                    sgbm = cv2.StereoSGBM_create(
                        minDisparity=0, numDisparities=D, blockSize=5,
                        P1=8 * 3 * 25, P2=32 * 3 * 25,
                        uniquenessRatio=ur, mode=cv2.STEREO_SGBM_MODE_SGBM)
                    d_sg = sgbm.compute(left.astype(np.uint8),
                                        right.astype(np.uint8)).astype(np.float32) / 16.0
                    add(name, seed, "cv2_SGBM", f"uniq={ur}", d_sg, d_sg >= 0, gt, nonocc)
                    add(name, seed, "ours_exact_dense@SGBM_mask", f"uniq={ur}",
                        dense_exact, d_sg >= 0, gt, nonocc)
            progress(f"{name} seed {seed}: " + " | ".join(
                f"{r_['method']} {r_['point']} {r_['coverage']:.4f}/{r_['bad_2']:.5f}"
                for r_ in rows if (r_["geometry"], r_["seed"]) == (name, seed)
                and r_["point"] in ("uniq>=0", "uniq>=12", "fill_all")))

    # for every cv2 point, our exact curve point of nearest coverage
    matched = []
    ours = [r_ for r_ in rows if r_["method"] == "ours_exact_refuse"]
    for r_ in rows:
        if r_["method"] not in ("cv2_BM", "cv2_SGBM"):
            continue
        cands = [o for o in ours if (o["geometry"], o["seed"]) == (r_["geometry"], r_["seed"])]
        near = min(cands, key=lambda o: abs(o["coverage"] - r_["coverage"]))
        matched.append(dict(
            geometry=r_["geometry"], seed=r_["seed"], cv2=f"{r_['method']}@{r_['point']}",
            cv2_coverage=r_["coverage"], cv2_bad_2=r_["bad_2"],
            ours=near["point"], ours_coverage=near["coverage"], ours_bad_2=near["bad_2"],
            ours_wins=near["bad_2"] <= r_["bad_2"]))

    full = shape is None and radius is None
    ours_rows = [r_ for r_ in rows if r_["method"].startswith("ours_") and "@" not in r_["method"]]
    checks = common.hold(
        ours_rows, common.reference_rows("refuse_curve.json"),
        lambda r_: (r_["geometry"], r_["seed"], r_["method"], r_["point"]), BARS,
        "bench_results/refuse_curve.json") if full else []
    return {
        "what": "coverage-vs-bad-2.0 operating curves on the hard regime: our LR + "
                "uniqueness confidence (thresholded on the host from one run) against cv2 "
                "BM / SGBM swept over uniquenessRatio",
        "cv2": cv2.__version__ if cv2 is not None else "not run",
        "rows": rows,
        "matched_coverage": matched,
        "checks": checks,
        "held_to_records": full,
        "ok": all(c["ok"] for c in checks),
        "kernels_routed": sorted(routed),
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("refuse_curve", __doc__)
    ap.add_argument("--geom", nargs="+", default=["kitti", "venus"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[7, 8])
    ap.add_argument("--no-cv2", action="store_true",
                    help="run our curves only; the record says \"cv2\": \"not run\"")
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    if cv2_refused("refuse_curve", args.no_cv2):
        return 2
    rec = common.run_main("refuse_curve", device, lambda: run(
        args.geom, args.seeds, device, not args.no_cv2, args.shape, args.radius))
    common.write_record(args.out, rec)
    print("| geometry | seed | method | point | coverage | bad_2 | epe |")
    print("|---|---|---|---|---|---|---|")
    for r in rec["rows"]:
        print(f"| {r['geometry']} | {r['seed']} | {r['method']} | {r['point']} | "
              f"{r['coverage']:.3f} | {r['bad_2']:.4f} | {r['epe']:.3f} |")
    wins = sum(m["ours_wins"] for m in rec["matched_coverage"])
    print(f"cv2: {rec['cv2']}; matched points {len(rec['matched_coverage'])}, ours wins or "
          f"ties {wins}; " + common.summary(rec["checks"]), f"; record {args.out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
