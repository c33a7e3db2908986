"""Side-by-side accuracy against OpenCV's StereoBM and StereoSGBM.

The counterpart of the repository's ``tools/compare_opencv.py``: our five
configurations (box, exact ASW with LR / fill / subpixel / median,
separable ASW, refuse mode, SGM) and ``cv2.StereoBM`` / ``StereoSGBM`` on
synthetic scenes with exact ground truth, bad-delta over the non-occluded
pixels a method keeps, plus our exact map scored on each cv2 method's kept
pixels.  ``--regime hard`` uses ``make_hard_pair`` (sensor noise,
textureless patches, brightness mismatch).

The cv2 rows are computed only where ``import cv2`` succeeds; without cv2
the tool exits non-zero unless ``--no-cv2`` is given, and the record then
says ``"cv2": "not run"`` and has no cv2 rows (nothing stands in for
them).  At the full geometries our rows (``ours_*``; not the ``@mask``
rows, which follow cv2's masks) must be within 0.005 bad-2.0 of the same
(geometry, method, regime) rows of ``bench_results/opencv_compare*.json``
(a record without a regime is the smooth one).

    python -m aswstereomatch_torch.tools.compare_opencv --geom tsukuba venus [--regime hard] [--no-cv2]
    python -m aswstereomatch_torch.tools.compare_opencv --device cpu --geom tsukuba \\
        --shape 48 96 16 --radius 4
"""

from __future__ import annotations

import glob
import importlib
import os
import sys

import numpy as np
import torch

from ..config import StereoConfig
from ..models import pipeline
from ..utils import evaluate, synthetic
from . import common

BARS = {"bad_2": 0.005}
KEYS = ["coverage", "bad_0.5", "bad_1", "bad_2", "bad_4", "epe"]


def our_configs(D: int, radius: int = 16) -> list:
    """(method, config) of our five rows (``tools/compare_opencv.py:73-100``)."""
    full = dict(max_disparity=D, cost="tad_grad", aggregation="asw", window_radius=radius,
                lr_check=True, fill_holes=True, subpixel=True, median_filter=True)
    return [
        ("ours_ad_box", StereoConfig(
            max_disparity=D, cost="ad", aggregation="box", window_radius=4,
            lr_check=False, fill_holes=False, subpixel=False, median_filter=False)),
        ("ours_asw_full", StereoConfig(**full)),
        ("ours_asw_separable", StereoConfig(**full, asw_separable=True)),
        # refuse mode: LR-invalidated pixels stay holes (-1), scored only on
        # the kept pixels, like the cv2 rows
        ("ours_asw_refuse", StereoConfig(**dict(full, fill_holes=False, median_filter=False))),
        ("ours_sgm", StereoConfig(
            max_disparity=D, cost="tad_grad", aggregation="sgm",
            lr_check=True, fill_holes=True, subpixel=True, median_filter=True)),
    ]


def import_cv2():
    """``cv2``, imported only here (never at module import)."""
    return importlib.import_module("cv2")


def cv2_refused(tool: str, no_cv2: bool) -> bool:
    """True (after saying why) where cv2 does not import and ``--no-cv2``
    was not given: the tool then stops instead of dropping its cv2 rows."""
    if no_cv2:
        return False
    try:
        import_cv2()
    except ImportError as e:
        print(f"{tool}: cv2 does not import ({e}); pass --no-cv2 to run without the cv2 "
              "rows", file=sys.stderr)
        return True
    return False


def scene(name: str, regime: str, shape=None) -> dict:
    if regime == "hard":
        h, w, D = common.geometry(name, shape)
        return synthetic.make_hard_pair(h, w, D, seed=7)
    # make_dataset_pair's per-scene seed offset gives same-shape scenes
    # (teddy, cones) different content
    return common.dataset_pair(name, 7, shape)


def reference_rows() -> list:
    rows = []
    for path in sorted(glob.glob(str(common.REPO / "bench_results" / "opencv_compare*.json"))):
        rows += [dict(r, regime=r.get("regime", "smooth"), source=os.path.basename(path))
                 for r in common.reference_rows(os.path.basename(path))]
    return rows


def run(geoms, device, regime: str = "smooth", use_cv2: bool = True, shape=None,
        radius=None, maps=None, progress=print) -> dict:
    """Our rows (and cv2's with ``use_cv2``) at each geometry; ``maps``,
    where given, receives our maps by (geometry, method)."""
    device = torch.device(device)
    cv2 = import_cv2() if use_cv2 else None
    rows = []
    routed = set()
    for name in geoms:
        h, w, D = common.geometry(name, shape)
        pair = scene(name, regime, shape)
        left, right, gt = pair["left"], pair["right"], pair["gt"]
        nonocc = ~pair["occluded"]

        def score(tag, disp, valid_extra=None):
            valid = nonocc if valid_extra is None else (nonocc & valid_extra)
            rep = evaluate.bad_report(disp, gt, valid=valid)
            # coverage: the share of non-occluded pixels a method is scored
            # on (cv2 methods and refuse mode drop their least sure pixels)
            rows.append(dict(geometry=name, method=tag, regime=regime,
                             coverage=round(float(valid.sum() / nonocc.sum()), 4),
                             **{k: round(v, 5) for k, v in rep.items()}, shape=[h, w, D]))

        l, r = common.to_device(pair, device)
        for tag, cfg in our_configs(D, 16 if radius is None else radius):
            routed.update(common.routed_kernels(cfg, device))
            disp = pipeline.match_pair(l, r, cfg).cpu().numpy()
            score(tag, disp, (disp >= 0) if tag == "ours_asw_refuse" else None)
            if maps is not None:
                maps[(name, tag)] = disp
            if tag == "ours_asw_full":
                disp_full = disp

        if cv2 is not None:
            gl = cv2.cvtColor(left.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            gr = cv2.cvtColor(right.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            bm = cv2.StereoBM_create(numDisparities=D, blockSize=9)
            d_bm = bm.compute(gl, gr).astype(np.float32) / 16.0
            score("cv2_StereoBM", d_bm, d_bm >= 0)
            sgbm = cv2.StereoSGBM_create(
                minDisparity=0, numDisparities=D, blockSize=5,
                P1=8 * 3 * 25, P2=32 * 3 * 25, mode=cv2.STEREO_SGBM_MODE_SGBM)
            d_sg = sgbm.compute(left.astype(np.uint8),
                                right.astype(np.uint8)).astype(np.float32) / 16.0
            score("cv2_StereoSGBM", d_sg, d_sg >= 0)
            # our dense map on exactly the pixels each cv2 method kept
            score("ours_asw_full@BM_mask", disp_full, d_bm >= 0)
            score("ours_asw_full@SGBM_mask", disp_full, d_sg >= 0)
        progress(" | ".join(f"{r_['method']} {r_['bad_2']:.5f}" for r_ in rows
                            if r_["geometry"] == name))

    full = shape is None and radius is None
    ours = [r_ for r_ in rows if r_["method"].startswith("ours_") and "@" not in r_["method"]]
    checks = []
    if full:
        for ref in reference_rows():
            checks += common.hold(ours, [ref], lambda r_: (r_["geometry"], r_["method"],
                                                           r_["regime"]), BARS, ref["source"])
    return {
        "what": "our configurations against cv2 StereoBM / StereoSGBM on synthetic "
                f"exact-GT scenes ({regime} regime), bad-delta over kept non-occluded pixels",
        "regime": regime,
        "cv2": cv2.__version__ if cv2 is not None else "not run",
        "rows": rows,
        "checks": checks,
        "held_to_records": full,
        "ok": all(c["ok"] for c in checks),
        "kernels_routed": sorted(routed),
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("opencv_compare", __doc__)
    ap.add_argument("--geom", nargs="+", default=["tsukuba", "venus"])
    ap.add_argument("--regime", choices=["smooth", "hard"], default="smooth")
    ap.add_argument("--no-cv2", action="store_true",
                    help="run our rows only; the record says \"cv2\": \"not run\"")
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    if cv2_refused("compare_opencv", args.no_cv2):
        return 2
    rec = common.run_main("compare_opencv", device, lambda: run(
        args.geom, device, args.regime, not args.no_cv2, args.shape, args.radius))
    common.write_record(args.out, rec)
    print("| geometry | method | " + " | ".join(KEYS) + " |")
    print("|" + "---|" * (2 + len(KEYS)))
    for r in rec["rows"]:
        print(f"| {r['geometry']} | {r['method']} | "
              + " | ".join(f"{r[k]:.4f}" for k in KEYS) + " |")
    print(f"cv2: {rec['cv2']}; " + common.summary(rec["checks"]), f"; record {args.out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
