"""Sharded layouts at flagship geometry, bit for bit against unsharded.

The counterpart of the repository's ``tools/flagship_sharded_check.py``:
every sharded layout of ``parallel/`` at width 1242, D = 128, r = 16, where
its bounds sit at or next to their limits:

  - x-tiling's right halo r + D - 1 = 143 columns against shards 311 / 310
    wide (1242 / 4 does not divide);
  - y-tiling at tile 2 puts H / 2 rows on a shard against the halo r + 1;
  - d-sharding over 8 shards combines 16-disparity slabs by (cost, lower d).

Rows: ``exact_asw/{y_tile,x_tile,d_shard}`` on the eager path;
``separable_asw/y_tile`` on the route ``backend="auto"`` takes (K2 on the
card), ``separable_asw/{x_tile,d_shard}`` on the eager path (no separable
kernel takes a column strip or a disparity window); and
``kernel/x_tile{2,4}``, exact ASW through K1's wrapper, whose right-view
strip is exported at D - 1 = 127 columns (the kernel on the card, its plain
version on the CPU: ``common.kernel_route``).  Each layout runs over a
mesh of the one device repeated, against the unsharded run on the same
route; every row must be ``exact``.  On the card the pair is 375 rows high
(the reference cut heights to 36 / 8 rows only to save CPU time).

    python -m aswstereomatch_torch.tools.flagship_sharded_check
    python -m aswstereomatch_torch.tools.flagship_sharded_check --device cpu \\
        --height 24 --width 160 --max-disparity 32 --radius 4
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import StereoConfig
from ..models import pipeline
from ..parallel import dshard, mesh as mesh_lib, tiling
from ..utils import synthetic
from . import common

WIDTH = 1242
D_MAX = 128
RADIUS = 16
HEIGHT = 375


def _base_cfg(d_max: int, radius: int) -> StereoConfig:
    return StereoConfig(
        max_disparity=d_max, cost="tad_grad", aggregation="asw",
        window_radius=radius, lr_check=True, fill_holes=True,
        subpixel=True, median_filter=True,
    )


def run_checks(device, height=None, width: int = WIDTH, d_max: int = D_MAX,
               radius: int = RADIUS, progress=print) -> dict:
    """Every row's layout, mesh, shape, the boundary it pins and ``exact``."""
    device = torch.device(device)
    h = HEIGHT if height is None else height
    pair = synthetic.make_pair(height=h, width=width, max_disparity=d_max, seed=9)
    left, right = common.to_device(pair, device)
    rows = []
    routed = set()

    def mesh(n):
        return mesh_lib.build_mesh(1, n, [device] * n)

    def check(name, fn, cfg, ref, boundary, mesh_desc):
        t0 = time.perf_counter()
        out = fn(left, right, cfg).cpu().numpy()
        ok = bool(np.array_equal(out, ref))
        rows.append({
            "layout": name, "mesh": mesh_desc, "shape": [h, width],
            "max_disparity": d_max, "window_radius": radius, "boundary": boundary,
            "route": "kernel" if pipeline._resolve_backend(cfg, device) == "cuda" else "eager",
            "exact": ok,
            "differing_pixels": int((out != ref).sum()),
            "wall_s": round(time.perf_counter() - t0, 3),
        })
        progress(f"  {name:28s} {mesh_desc:12s} {rows[-1]['route']:6s} exact={ok}")

    def unsharded(cfg):
        routed.update(common.routed_kernels(cfg, device))
        t0 = time.perf_counter()
        ref = pipeline.match_pair(left, right, cfg).cpu().numpy()
        progress(f"{cfg.asw_separable and 'separable' or 'exact'} {cfg.backend}: unsharded "
                 f"({h}x{width}) in {time.perf_counter() - t0:.1f} s")
        return ref

    n_y, n_x, n_d = 2, 4, 8
    ws = -(-width // n_x)
    y_boundary = f"{-(-h // n_y)} rows/shard vs halo r+1={radius + 1}"
    x_boundary = (f"shard width {ws}/{width - (n_x - 1) * ws}, right halo "
                  f"r+D-1={radius + d_max - 1}; production kitti mesh_tile=4 layout")
    d_boundary = (f"{d_max // n_d} disparities/shard over {n_d} shards, lexicographic "
                  f"(cost, lower-d) combine at D={d_max}")
    with common.kernel_route(device):
        for mode in ("exact_asw", "separable_asw"):
            cfg = _base_cfg(d_max, radius).replace(asw_separable=mode == "separable_asw")
            eager = cfg.replace(backend="eager")
            ref_e = unsharded(eager)
            # the y layout on the route "auto" takes: K2 for separable on the card
            y_cfg = cfg if mode == "separable_asw" else eager
            ref_y = ref_e if y_cfg is eager else unsharded(y_cfg)
            check(f"{mode}/y_tile", lambda l, r, c: tiling.match_pair_tiled(l, r, c, mesh(n_y)),
                  y_cfg, ref_y, y_boundary, f"tile={n_y} (y)")
            check(f"{mode}/x_tile", lambda l, r, c: tiling.match_pair_tiled_x(l, r, c, mesh(n_x)),
                  eager, ref_e, x_boundary, f"tile={n_x} (x)")
            check(f"{mode}/d_shard",
                  lambda l, r, c: dshard.match_pair_dsharded(l, r, c, mesh(n_d)),
                  eager, ref_e, d_boundary, f"tile={n_d} (d)")

        # K1 x-tiled: the right-view strip at D - 1 columns, exported at
        # each shard's edge
        cfg_k = _base_cfg(d_max, radius).replace(backend="cuda")
        ref_k = unsharded(cfg_k)
        for n in (2, 4):
            check(f"kernel/x_tile{n}",
                  lambda l, r, c, n=n: tiling.match_pair_tiled_x(l, r, c, mesh(n)), cfg_k, ref_k,
                  f"strip export D-1={d_max - 1} at shard width {-(-width // n)}",
                  f"tile={n} (x)")

    return {
        "what": f"sharded layouts vs the unsharded pipeline, bit for bit, at {h}x{width} "
                f"D={d_max} r={radius}, each over a mesh of one device repeated",
        "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "platform": device.type,
        "all_exact": all(r["exact"] for r in rows),
        "kernels_routed": sorted(routed),
        "rows": rows,
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("sharded_flagship", __doc__)
    ap.add_argument("--height", type=int, help=f"rows (default {HEIGHT})")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--max-disparity", type=int, default=D_MAX)
    ap.add_argument("--radius", type=int, default=RADIUS)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("flagship_sharded_check", device, lambda: run_checks(
        device, args.height, args.width, args.max_disparity, args.radius))
    common.write_record(args.out, rec)
    print({"all_exact": rec["all_exact"], "rows": len(rec["rows"]), "record": args.out})
    return 0 if rec["all_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
