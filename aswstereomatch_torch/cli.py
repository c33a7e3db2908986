"""Command-line entry point of the port: one pair through a configured matcher.

The counterpart of the repository's ``cli.py`` (the JAX package's CLI):
load (or synthesize) a rectified pair, run it through ``StereoMatcher`` on
the card, write the disparity map and error-map artifacts and a JSON run
record (config, config hash, device, shape, build-and-first-call time,
best / mean time per pair, pairs/s, density, bad-delta table).

Examples:
  python -m aswstereomatch_torch.cli --synthetic kitti --preset kitti_tiled \\
      --json out.json --out disp.png
  python -m aswstereomatch_torch.cli --left l.png --right r.png --gt gt.png \\
      --dataset kitti --preset middlebury_asw_full --out disp.png
  python -m aswstereomatch_torch.cli --synthetic venus --preset middlebury_asw \\
      --profile trace_dir
  python -m aswstereomatch_torch.cli --synthetic tsukuba --device cpu
  python -m aswstereomatch_torch.cli --synthetic kitti --preset kitti_tiled \\
      --mesh 1x4 --shard-axis x            # four cards: columns over 4 shards

It runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain PyTorch path on the CPU.  A ``--mesh``
(or a preset's mesh) that fits the visible cards runs the sharded layout
(``parallel.api.sharded_match_fn``); one that needs more warns and runs
unsharded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .config import StereoConfig, get_preset
from .models.pipeline import StereoMatcher
from .parallel import api as parallel_api, mesh
from .utils import evaluate, io, profiling, synthetic


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_argument_group("input")
    src.add_argument("--left", help="left image path")
    src.add_argument("--right", help="right image path")
    src.add_argument("--gt", help="ground-truth disparity path")
    src.add_argument("--dataset", default="kitti",
                     help="GT scale convention (tsukuba/venus/teddy/cones/kitti)")
    src.add_argument("--synthetic",
                     help="use a synthetic pair with this dataset geometry "
                          "(tsukuba/venus/teddy/cones/kitti)")
    src.add_argument("--seed", type=int, default=0)
    cfg = ap.add_argument_group("config")
    cfg.add_argument("--preset", help="named preset (see config.PRESETS)")
    cfg.add_argument("--max-disparity", type=int)
    cfg.add_argument("--cost", choices=["ad", "tad_grad"])
    cfg.add_argument("--aggregation", choices=["none", "box", "asw", "sgm"])
    cfg.add_argument("--window-radius", type=int)
    cfg.add_argument("--backend", choices=["auto", "eager", "cuda"])
    cfg.add_argument("--y-chunks", type=int)
    cfg.add_argument("--left-only-weights", action="store_true",
                     help="left-only ASW weights (the speed mode served by the "
                          "d-lanes kernel at D > 64)")
    cfg.add_argument("--separable", action="store_true",
                     help="two-pass separable ASW approximation (O(K) taps "
                          "per pixel instead of O(K^2))")
    cfg.add_argument("--uniqueness-ratio", type=float,
                     help="cv2-style WTA-uniqueness confidence gate: reject "
                     "a pixel unless its best cost wins the second-best over "
                     "d outside [best-1, best+1] by this percent (0 = off)")
    cfg.add_argument("--no-fill", action="store_true",
                     help="refuse mode: gated pixels stay -1 instead of "
                     "being filled (partial-coverage operating point)")
    cfg.add_argument("--kernel-layout", choices=["auto", "xlanes", "dlanes"],
                     help="kernel data layout (auto picks per config)")
    cfg.add_argument("--no-postprocess", action="store_true",
                     help="disable LR check / fill / subpixel / median")
    run = ap.add_argument_group("execution")
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="where the pair runs: the card (default; raises "
                          "without one) or the CPU's plain PyTorch path")
    run.add_argument("--mesh", default=None,
                     help="DATAxTILE device mesh, e.g. 1x4 (a mesh that needs "
                          "more devices than are visible runs unsharded)")
    run.add_argument("--shard-axis", default="y", choices=["y", "x", "d"],
                     help="what the mesh 'tile' axis shards: image rows (y), "
                          "image columns (x), or the disparity axis (d)")
    run.add_argument("--iters", type=int, default=1, help="timing iterations")
    run.add_argument("--profile", help="write a torch.profiler Chrome trace to this dir")
    out = ap.add_argument_group("output")
    out.add_argument("--out", help="disparity visualization PNG/PGM path")
    out.add_argument("--err-out", help="error-map visualization path (needs --gt)")
    out.add_argument("--json", dest="json_out", help="structured run record path")
    return ap


def visible_devices(device: str) -> list:
    """Devices a mesh could span: the visible cards, or the CPU."""
    return mesh.visible_cards() if device == "cuda" else [torch.device("cpu")]


def _device_input(a: np.ndarray) -> np.ndarray:
    """8-bit sources (integral values in [0, 255]) ship to the device as
    uint8, 4x fewer bytes, widened to float32 there (lossless); 16-bit and
    float sources stay float32 (a uint8 cast would wrap them)."""
    if (float(np.min(a)) >= 0 and float(np.max(a)) <= 255
            and np.array_equal(a, np.floor(a))):
        return a.astype(np.uint8)
    return np.ascontiguousarray(a, np.float32)


def main(argv=None):
    args = build_parser().parse_args(argv)

    # ---- inputs -------------------------------------------------------------
    gt = valid = None
    if args.synthetic:
        pair = synthetic.make_dataset_pair(args.synthetic, seed=args.seed)
        left, right, gt = pair["left"], pair["right"], pair["gt"]
        valid = ~pair["occluded"]
        geom_d = synthetic.GEOMETRIES[args.synthetic.lower()][2]
    elif args.left and args.right:
        left = io.read_image(args.left)
        right = io.read_image(args.right)
        geom_d = 64
        if args.gt:
            gt, valid = io.read_gt_disparity(args.gt, args.dataset)
    else:
        print("need --left/--right or --synthetic", file=sys.stderr)
        return 2

    # ---- config -------------------------------------------------------------
    cfg = get_preset(args.preset) if args.preset else StereoConfig(
        max_disparity=geom_d
    )
    overrides = {}
    for field in ("max_disparity", "cost", "aggregation", "window_radius",
                  "backend", "y_chunks", "kernel_layout", "uniqueness_ratio"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    if args.no_fill:
        overrides["fill_holes"] = False
    if args.left_only_weights:
        overrides["asw_symmetric"] = False
    if args.separable:
        overrides["asw_separable"] = True
    if args.no_postprocess:
        overrides.update(
            lr_check=False, fill_holes=False, subpixel=False, median_filter=False
        )
    if overrides:
        cfg = cfg.replace(**overrides)
    if args.mesh:
        nd, nt = (int(v) for v in args.mesh.lower().split("x"))
        cfg = cfg.replace(mesh_data=nd, mesh_tile=nt, tile_axis=args.shard_axis)

    # ---- run ----------------------------------------------------------------
    matcher = StereoMatcher(cfg, device=args.device)
    devices = visible_devices(args.device)
    fn = matcher
    if parallel_api.layout_fits(cfg, devices):
        # The declared layout over the visible devices; its functions take
        # float32 images (the matcher widens uint8 itself).
        sharded = parallel_api.sharded_match_fn(cfg, devices)
        fn = lambda l, r: sharded(l.to(torch.float32), r.to(torch.float32))  # noqa: E731
    dev = matcher.device
    t0 = time.perf_counter()
    l_dev = torch.from_numpy(_device_input(left)).to(dev)
    r_dev = torch.from_numpy(_device_input(right)).to(dev)
    disp = fn(l_dev, r_dev)  # the first call builds or loads the kernels
    profiling.force_sync(disp)
    compile_s = time.perf_counter() - t0

    with profiling.trace(args.profile):
        best_s, mean_s, disp = profiling.time_fn(
            fn, l_dev, r_dev, iters=max(args.iters, 1), warmup=1
        )
    disp = disp.cpu().numpy()

    # ---- record -------------------------------------------------------------
    record = {
        "config": dataclasses.asdict(cfg),
        "config_hash": cfg.config_hash(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "shape": list(disp.shape),
        "compile_s": round(compile_s, 3),
        "best_s": round(best_s, 5),
        "mean_s": round(mean_s, 5),
        "pairs_per_s": round(1.0 / best_s, 3),
        "density": float(np.isfinite(disp).mean()),
    }
    if gt is not None:
        record["metrics"] = {
            k: round(v, 5)
            for k, v in evaluate.bad_report(disp, gt, valid=valid).items()
        }
    print(json.dumps(record, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2)
    if args.out:
        io.save_disparity_png(args.out, disp, cfg.max_disparity)
    if args.err_out and gt is not None:
        err = np.clip(np.abs(disp - gt) / 4.0 * 255.0, 0, 255)
        io.save_disparity_png(args.err_out, err, 256)
    return 0


if __name__ == "__main__":
    sys.exit(main())
