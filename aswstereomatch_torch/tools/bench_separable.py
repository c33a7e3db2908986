"""The separable ASW kernel against the exact kernels and the eager path.

The counterpart of the repository's ``tools/bench_separable.py``.  At the
KITTI geometry (``--geom``; venus and tsukuba too) on the synthetic
exact-GT scene ``make_dataset_pair(geom, seed=3)``, r = 16 with LR, fill,
subpixel and median, six variants:

  - ``exact_sym_auto``: exact symmetric ASW, the default route (K1);
  - ``sep_sym_kernel``: separable symmetric on ``kernel_layout="dlanes"`` (K2);
  - ``sep_sym_eager``: the same config on ``backend="eager"`` (the
    reference's ``sep_sym_jnp``);
  - ``exact_lo_auto``: exact left-only (K3 at D > 64);
  - ``sep_lo_kernel`` (K2) and ``sep_lo_eager`` (``sep_lo_jnp``): the same
    for separable left-only;

each with pairs/s per synchronised call and with ``--queue`` calls queued,
its peak allocation on the card, and the bad-delta table against GT; then
the kernel against the eager path per mode, the share of pixels within
1/16 px and the largest |difference|: on the card this is the hardware
exactness the reference's interpret mode could not give.  At the full
geometries each row's bad-2.0 and EPE are held to the reference's
``bench_results/separable_ab.json`` (within 0.005 and 0.05).  An eager
variant that does not fit on the card is recorded as such.

    python -m aswstereomatch_torch.tools.bench_separable [--geom kitti] [--queue 8]
    python -m aswstereomatch_torch.tools.bench_separable --device cpu --shape 48 96 16 --radius 4
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import StereoConfig
from ..models import pipeline
from ..utils import evaluate
from . import common

VARIANTS = [
    ("exact_sym_auto", dict(asw_symmetric=True)),
    ("sep_sym_kernel", dict(asw_symmetric=True, asw_separable=True, kernel_layout="dlanes")),
    ("sep_sym_eager", dict(asw_symmetric=True, asw_separable=True, backend="eager")),
    ("exact_lo_auto", dict(asw_symmetric=False)),
    ("sep_lo_kernel", dict(asw_symmetric=False, asw_separable=True, kernel_layout="dlanes")),
    ("sep_lo_eager", dict(asw_symmetric=False, asw_separable=True, backend="eager")),
]
# each variant's name in the reference's record
REFERENCE_NAMES = {"sep_sym_eager": "sep_sym_jnp", "sep_lo_eager": "sep_lo_jnp"}
BARS = {"bad_2": 0.005, "epe": 0.05}


def config(d: int, overrides: dict, radius: int = 16) -> StereoConfig:
    return StereoConfig(max_disparity=d, cost="tad_grad", aggregation="asw",
                        window_radius=radius, lr_check=True, fill_holes=True, subpixel=True,
                        median_filter=True, **overrides)


def _peak_mib(fn, l, r, device):
    """The card's peak allocation over one call, above what was held before."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn(l, r)
    torch.cuda.synchronize(device)
    return round((torch.cuda.max_memory_allocated(device) - base) / 2**20, 3)


def run(device, geoms=("kitti",), queue: int = 8, shape=None, radius=None, maps=None,
        progress=print) -> dict:
    """The six variants at each geometry; ``maps``, where given, receives
    each variant's map by (geometry, variant)."""
    device = torch.device(device)
    rows, routed = [], set()
    with common.kernel_route(device):
        for geom in geoms:
            h, w, d = common.geometry(geom, shape)
            pair = common.dataset_pair(geom, 3, shape)
            l, r = common.to_device(pair, device)
            disps = {}
            for tag, overrides in VARIANTS:
                cfg = config(d, overrides, 16 if radius is None else radius)
                kernels = common.routed_kernels(cfg, device)
                routed.update(kernels)
                fn = lambda a, b, cfg=cfg: pipeline.match_pair(a, b, cfg)  # noqa: E731
                row = {"geometry": geom, "variant": tag,
                       "reference_variant": REFERENCE_NAMES.get(tag, tag), "shape": [h, w, d],
                       "kernels": kernels}
                t0 = time.perf_counter()
                try:
                    peak = _peak_mib(fn, l, r, device)
                    disp, times = common.rates(fn, l, r, iters=4, queue=queue)
                except torch.OutOfMemoryError as e:
                    row.update(error=f"out of memory on the card: {e}".splitlines()[0])
                    rows.append(row)
                    progress(row)
                    torch.cuda.empty_cache()
                    continue
                times.pop("compile_s")
                rep = evaluate.bad_report(disp, pair["gt"], valid=~pair["occluded"])
                disps[tag] = disp
                if maps is not None:
                    maps[(geom, tag)] = disp
                row.update(**times, wall_s=round(time.perf_counter() - t0, 2),
                           peak_alloc_mib=peak,
                           **{k: round(float(v), 5) for k, v in rep.items()})
                rows.append(row)
                progress(row)
            for mode in ("sym", "lo"):
                a, b = disps.get(f"sep_{mode}_kernel"), disps.get(f"sep_{mode}_eager")
                row = {"geometry": geom, "variant": f"sep_{mode}_kernel_vs_eager",
                       "reference_variant": f"sep_{mode}_kernel_vs_jnp"}
                if a is None or b is None:
                    row["error"] = "a variant did not run"
                else:
                    diff = np.abs(a - b)
                    row.update(agree_sixteenth_px=round(float(np.mean(diff < 1.0 / 16.0)), 6),
                               max_abs_delta=round(float(diff.max()), 6))
                rows.append(row)
                progress(row)
    full = shape is None and radius is None
    timed = [x for x in rows if "bad_2" in x]
    checks = common.hold(timed, common.reference_rows("separable_ab.json"),
                         lambda x: (x["geometry"], x.get("reference_variant", x["variant"])),
                         BARS, "bench_results/separable_ab.json") if full else []
    return {"rows": rows, "checks": checks, "held_to_records": full,
            "errors": [x for x in rows if "error" in x],
            "ok": all(c["ok"] for c in checks), "kernels_routed": sorted(routed),
            **common.environment(device)}


def main(argv=None) -> int:
    ap = common.parser("separable_ab", __doc__)
    ap.add_argument("--geom", nargs="+", default=["kitti"])
    ap.add_argument("--queue", type=int, default=8)
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("bench_separable", device, lambda: run(
        device, args.geom, args.queue, args.shape, args.radius))
    common.write_record(args.out, rec)
    print(common.summary(rec["checks"]), f"; record {args.out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
