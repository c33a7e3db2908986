"""Post-process stage costs on the card: a cumulative config ladder.

The counterpart of the repository's ``tools/profile_stages.py``.  A kernel
(K1 symmetric, K3 left-only or box, K2 separable) writes the WTA planes and
the post-process (subpixel, LR check and fill, median) runs after it as
plain PyTorch.  The tool puts a time on each stage with the ladder

    wta_only -> +subpixel -> +lr_fill -> +median (the preset default) -> +wmedian

one ``StereoMatcher`` per rung: two synchronised warm calls, then
``--queue`` calls queued back to back and one wait; the deltas between
rungs are the stage costs.  On the card each rung's routed kernel must
launch exactly once per queued call and no other kernel may launch, or
the tool fails: a rung on the eager path would have its whole pipeline
mislabelled as stage cost (the reason ``--box`` with ``--separable`` is
refused).  Prints one JSON line per rung and a summary
(``epilogue_share_pct``, ``pairs_per_s_full``); the record goes to
``results_torch/profile_stages_<geometry>_<mode>.json``.

    python -m aswstereomatch_torch.tools.profile_stages [--geometry kitti]
        [--left-only] [--box] [--separable] [--queue 8]
    python -m aswstereomatch_torch.tools.profile_stages --device cpu --geometry tiny
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..config import StereoConfig
from ..models import pipeline
from ..utils import profiling, synthetic
from . import common

GEOMS = {
    "kitti": dict(height=375, width=1242, max_disparity=128),
    "middlebury": dict(height=375, width=450, max_disparity=64),
    "tsukuba": dict(height=288, width=384, max_disparity=16),
    "tiny": dict(height=48, width=64, max_disparity=8, window_radius=4),  # CPU smoke
}
_POST = ("lr_check", "fill_holes", "subpixel", "median_filter")
LADDER = [
    ("wta_only", dict(zip(_POST, (False, False, False, False)))),
    ("+subpixel", dict(zip(_POST, (False, False, True, False)))),
    ("+lr_fill", dict(zip(_POST, (True, True, True, False)))),
    ("+median", dict(zip(_POST, (True, True, True, True)))),
    ("+wmedian", dict(zip(_POST, (True, True, True, True)), median_mode="weighted")),
]


def mode_name(left_only: bool, box: bool, separable: bool) -> str:
    return (("box" if box else "left_only" if left_only else "symmetric")
            + ("+separable" if separable else ""))


def base_config(geometry: str, left_only=False, box=False, separable=False) -> dict:
    if box and separable:
        raise ValueError("--separable applies to ASW only; with --box the pipeline would "
                         "take the eager path and the stage attribution would be mislabelled")
    g = dict(GEOMS[geometry])
    return dict(max_disparity=g["max_disparity"], cost="tad_grad",
                aggregation="box" if box else "asw",
                window_radius=g.get("window_radius", 16), asw_symmetric=not left_only,
                asw_separable=separable)


def launch_problem(rung: str, routed: list, got: dict, calls: int) -> str:
    """Why a rung's launches do not show its kernel route ('' if they do):
    on the card every rung has one routed kernel, launched once per call,
    and no other kernel launches."""
    if not routed:
        return f"{rung}: no kernel serves it on the card (the eager path would be timed)"
    bad = [f"{k} {n} (want {calls if k in routed else 0})" for k, n in got.items()
           if n != (calls if k in routed else 0)]
    return f"{rung}: launches " + ", ".join(bad) if bad else ""


def run(device, geometry: str = "kitti", left_only=False, box=False, separable=False,
        queue: int = 8, maps=None, progress=print) -> dict:
    """The ladder; ``maps``, where given, receives each rung's map."""
    device = torch.device(device)
    base = base_config(geometry, left_only, box, separable)
    g = GEOMS[geometry]
    pair = synthetic.make_pair(height=g["height"], width=g["width"],
                               max_disparity=g["max_disparity"], seed=0)
    l, r = common.to_device(pair, device)
    on_card = device.type == "cuda"
    rows, problems = [], []
    with common.kernel_route(device):
        for name, over in LADDER:
            cfg = StereoConfig(**base, **over)
            fn = pipeline.StereoMatcher(cfg, device=device)
            t0 = time.perf_counter()
            out = fn(l, r)
            profiling.force_sync(out)
            compile_s = time.perf_counter() - t0
            profiling.force_sync(fn(l, r))
            for m in common.KERNELS.values():
                m.launches = 0
            t0 = time.perf_counter()
            outs = [fn(l, r) for _ in range(queue)]
            profiling.force_sync(outs[-1])
            queued_s = (time.perf_counter() - t0) / queue
            got = common.launch_counts()
            routed = common.routed_kernels(cfg, device)
            problem = launch_problem(name, routed, got, queue) if on_card or routed else ""
            if problem:
                problems.append(problem)
            if maps is not None:
                maps[name] = outs[-1].cpu().numpy()
            row = {
                "rung": name,
                "s_per_pair": round(queued_s, 6),
                "delta_ms": round(1e3 * (queued_s - rows[-1]["s_per_pair"]), 3) if rows else 0.0,
                # the reference's compile source; here the kernels this rung ran on
                "compile_source": "+".join(routed) or "eager",
                "compile_s": round(compile_s, 3),
                "launches": {k: n for k, n in got.items() if n},
                "config_hash": cfg.config_hash(),
            }
            rows.append(row)
            progress(json.dumps(row))
    full = rows[-2]  # "+median" (the plain median) is the preset default
    summary = {
        "geometry": geometry,
        "mode": mode_name(left_only, box, separable),
        "epilogue_share_pct": round(
            100 * (full["s_per_pair"] - rows[0]["s_per_pair"]) / full["s_per_pair"], 2),
        "pairs_per_s_full": round(1 / full["s_per_pair"], 3),
    }
    progress(json.dumps(summary))
    return {**summary, "rows": rows, "queue": queue, "launch_problems": problems,
            "ok": not problems, **common.environment(device)}


def main(argv=None) -> int:
    ap = common.parser("profile_stages", __doc__)
    ap.set_defaults(out=None)
    ap.add_argument("--geometry", default="kitti", choices=sorted(GEOMS))
    ap.add_argument("--left-only", action="store_true")
    ap.add_argument("--box", action="store_true")
    ap.add_argument("--separable", action="store_true")
    ap.add_argument("--queue", type=int, default=8)
    args = ap.parse_args(argv)
    if args.box and args.separable:
        ap.error("--separable applies to ASW only; with --box the pipeline would take the "
                 "eager path and the stage attribution would be mislabelled")
    device = common.resolve_device(args.device)
    rec = common.run_main("profile_stages", device, lambda: run(
        device, args.geometry, args.left_only, args.box, args.separable, args.queue))
    mode = rec["mode"].replace("+", "_")
    out = args.out or os.path.join(common.RESULTS_DIR,
                                   f"profile_stages_{args.geometry}_{mode}.json")
    common.write_record(out, rec)
    for p in rec["launch_problems"]:
        print(f"profile_stages: FAILED: {p}", file=sys.stderr)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
