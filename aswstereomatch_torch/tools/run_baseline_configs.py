"""The BASELINE presets at their scene geometries: bad-delta and pairs/s.

The counterpart of the repository's ``tools/run_baseline_configs.py``: one
row per (preset, geometry) of ``RUNS`` on ``synthetic.make_dataset_pair(
geometry, seed=3)`` (synthetic layered scenes with exact ground truth at
the Tsukuba / Venus / Teddy / Cones / KITTI geometries), the preset's mesh
set to 1 x 1 as the reference runs it on one chip.  Each row has pairs/s
per synchronised call and with 8 calls queued, the first call's time, and
``evaluate.bad_report``.  At the full geometries each row's bad-2.0 must be
within 0.005, and its EPE within 0.05 px, of the same (preset, geometry)
row of ``bench_results/baseline_configs.json`` (the reference's answers;
its times were taken on a TPU and are not compared).

    python -m aswstereomatch_torch.tools.run_baseline_configs
    python -m aswstereomatch_torch.tools.run_baseline_configs --device cpu --shape 48 96 16 --radius 4
"""

from __future__ import annotations

import sys

import torch

from ..config import get_preset
from ..models import pipeline
from ..utils import evaluate
from . import common

RUNS = [
    # (preset, geometry, note)
    ("tsukuba_ad_box", "tsukuba", "config 1: AD + fixed window"),
    ("middlebury_asw", "venus", "config 2: TAD+grad, ASW 33x33"),
    ("middlebury_asw_full", "venus", "config 3: + LR/fill/subpixel/median"),
    ("middlebury_asw_full", "teddy", "config 3 on the teddy-class scene"),
    ("middlebury_asw_full", "cones", "config 3 on the cones-class scene"),
    ("kitti_tiled", "kitti",
     "config 4: tiled path validated by the sharded-layout checks; timed unsharded here"),
    ("kitti_batch", "kitti",
     "config 5: batch path validated by the sharded-layout checks; timed single-pair here"),
]
BARS = {"bad_2": 0.005, "epe": 0.05}


def config_for(preset: str, shape=None, radius=None):
    """The preset as one device runs it (mesh 1 x 1), cut to ``shape``'s D
    and ``radius`` where given."""
    cfg = get_preset(preset).replace(mesh_data=1, mesh_tile=1)
    if shape is not None:
        cfg = cfg.replace(max_disparity=shape[2])
    if radius is not None:
        cfg = cfg.replace(window_radius=radius)
    return cfg


def run(device, shape=None, radius=None, maps=None, progress=print) -> dict:
    """Every row of ``RUNS``; ``maps``, where given, receives each row's
    disparity map by (preset, geometry)."""
    device = torch.device(device)
    rows = []
    routed = set()
    for preset, geom, note in RUNS:
        cfg = config_for(preset, shape, radius)
        pair = common.dataset_pair(geom, 3, shape)
        l, r = common.to_device(pair, device)
        routed.update(common.routed_kernels(cfg, device))
        disp, times = common.rates(lambda a, b: pipeline.match_pair(a, b, cfg), l, r)
        rep = evaluate.bad_report(disp, pair["gt"], valid=~pair["occluded"])
        rows.append(dict(
            preset=preset, geometry=geom, note=note, config_hash=cfg.config_hash(),
            **times, **{k: round(v, 5) for k, v in rep.items()},
            shape=list(common.geometry(geom, shape)), window_radius=cfg.window_radius,
            kernels=common.routed_kernels(cfg, device),
        ))
        if maps is not None:
            maps[(preset, geom)] = disp
        progress(f"{preset} {geom}: {rows[-1]['pairs_per_s']} pairs/s "
                 f"({rows[-1]['pairs_per_s_queued']} queued), bad2={rows[-1]['bad_2']}, "
                 f"epe={rows[-1]['epe']}")
    full = shape is None and radius is None
    checks = common.hold(rows, common.reference_rows("baseline_configs.json"),
                         lambda r: (r["preset"], r["geometry"]), BARS,
                         "bench_results/baseline_configs.json") if full else []
    return {
        "what": "the BASELINE presets at their scene geometries (synthetic, seed 3): "
                "bad-delta, pairs/s per call and with 8 queued",
        "rows": rows,
        "checks": checks,
        "held_to_records": full,
        "ok": all(c["ok"] for c in checks),
        "kernels_routed": sorted(routed),
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("baseline_configs", __doc__)
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("run_baseline_configs", device,
                          lambda: run(device, args.shape, args.radius))
    common.write_record(args.out, rec)
    print("\n| preset | geometry | pairs/s | queued | bad-0.5 | bad-2.0 | EPE |")
    print("|---|---|---|---|---|---|---|")
    for r in rec["rows"]:
        print(f"| {r['preset']} | {r['geometry']} | {r['pairs_per_s']} | "
              f"{r['pairs_per_s_queued']} | {r['bad_0.5']:.4f} | {r['bad_2']:.4f} | "
              f"{r['epe']:.3f} |")
    print(common.summary(rec["checks"]), f"; record {args.out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
