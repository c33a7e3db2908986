"""Symmetric against left-only ASW weights: speed and accuracy.

The counterpart of the repository's ``tools/sym_vs_leftonly.py``: both
weight modes at the venus and kitti geometries on synthetic exact-GT
scenes (``make_dataset_pair(geometry, seed=3)``), r = 16 with LR, fill,
subpixel and median; pairs/s per synchronised call and with 8 queued, and
the bad-delta table.  On the card symmetric runs on K1 and left-only on K3
(``kernel_for``).  At the full geometries each
row's bad-2.0 must be within 0.005 of the same (geometry, symmetric) row of
``bench_results/symmetric_vs_leftonly.json``.

    python -m aswstereomatch_torch.tools.sym_vs_leftonly
    python -m aswstereomatch_torch.tools.sym_vs_leftonly --device cpu --shape 48 96 16 --radius 4
"""

from __future__ import annotations

import sys

import torch

from ..config import StereoConfig
from ..models import pipeline
from ..utils import evaluate
from . import common

GEOMS = ("venus", "kitti")
BARS = {"bad_2": 0.005}


def config(d: int, symmetric: bool, radius: int = 16) -> StereoConfig:
    return StereoConfig(max_disparity=d, cost="tad_grad", aggregation="asw",
                        window_radius=radius, lr_check=True, fill_holes=True, subpixel=True,
                        median_filter=True, asw_symmetric=symmetric)


def run(device, shape=None, radius=None, maps=None, progress=print) -> dict:
    """Both modes at both geometries; ``maps``, where given, receives each
    row's map by (geometry, symmetric)."""
    device = torch.device(device)
    rows = []
    routed = set()
    for geom in GEOMS:
        h, w, d = common.geometry(geom, shape)
        pair = common.dataset_pair(geom, 3, shape)
        l, r = common.to_device(pair, device)
        for sym in (True, False):
            cfg = config(d, sym, 16 if radius is None else radius)
            routed.update(common.routed_kernels(cfg, device))
            disp, times = common.rates(lambda a, b: pipeline.match_pair(a, b, cfg), l, r, iters=4)
            rep = evaluate.bad_report(disp, pair["gt"], valid=~pair["occluded"])
            times.pop("compile_s")
            rows.append({"geometry": geom, "symmetric": sym, **times,
                         **{k: round(float(v), 5) for k, v in rep.items()},
                         "shape": [h, w, d], "kernels": common.routed_kernels(cfg, device)})
            if maps is not None:
                maps[(geom, sym)] = disp
            progress(rows[-1])
    full = shape is None and radius is None
    checks = common.hold(rows, common.reference_rows("symmetric_vs_leftonly.json"),
                         lambda r: (r["geometry"], r["symmetric"]), BARS,
                         "bench_results/symmetric_vs_leftonly.json") if full else []
    return {"rows": rows, "checks": checks, "held_to_records": full,
            "ok": all(c["ok"] for c in checks), "kernels_routed": sorted(routed),
            **common.environment(device)}


def main(argv=None) -> int:
    ap = common.parser("symmetric_vs_leftonly", __doc__)
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("sym_vs_leftonly", device, lambda: run(device, args.shape, args.radius))
    common.write_record(args.out, rec)
    print(common.summary(rec["checks"]), f"; record {args.out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
