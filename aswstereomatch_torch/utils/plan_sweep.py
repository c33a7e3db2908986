"""Time K1 (``ops/cuda/asw_kernel.cu``), K2 (``ops/cuda/asw_sep_kernel.cu``),
K3 (``ops/cuda/asw_dlanes_kernel.cu``), K4
(``ops/cuda/asw_sym_dlanes_kernel.cu``) or the SGM kernel
(``ops/cuda/sgm_kernel.cu``) under several plans on the card.

    python -m aswstereomatch_torch.utils.plan_sweep [--kernel k1|k2|k3|k4|sgm] [--reps 5]
        [--geometry NAME ...] [--count 8] [--plan TY,TX,DC,KX ...] [--against DIR ...]
        [--time-only]

For each geometry (synthetic pairs at full width) it runs the kernel over
pre-built channel stacks with its ``tile_plan``'s plan and with other plans
that fit (K1: 1, 2, 4, ... rows up to the default's, and at least 4; K2:
48, 64, 96 and 128 columns x d-chunks of 16, 32 and 64 at the most rows
512 threads allow and half of them; K3: 1, 2, 4, ... rows at 32, 64 and
128 columns; K4: the plans of least estimated work whose register tiles
fill two or three consumer warpgroups, and the default plan with half its
window-column run and with two d-chunks), checks that each plan gives the
default plan's six planes bit for bit, and prints the median ms per call
(CUDA events, after one warm-up call).  Over the same stacks it also times
K4 where K1 runs symmetric ASW at D <= 128, and K1 where K3 or K4 runs
(for K4 also whether K1's planes equal K4's bit for bit).  SGM: over
kitti_sgm's raw cost volume of a 1242x375 D=128 pair: the rate of a
plain copy and add of such a volume, one row's step alone (16 rows of l2r
in one launch), then for 4 and 8 paths the default plan (held bit for bit
to the plain version) and the long-D path (held to the default plan's S
bit for bit), with the median ms of the whole call and of each phase
alone.  ``--against DIR`` (a checkout of another commit, e.g. the
parent's ``git archive`` in a gitignored directory) times that tree's SGM
kernel and this one's on the same volume, each in a process of its own
started with ``--time-only`` in its tree, in the order DIR, this, this,
DIR per DIR (the two libraries register the same operators, so one
process cannot load both); DIR's plan_sweep must have ``--time-only``, so
an older tree takes this file copied in.  It prints the card's name and
power limit and ptxas' register and spill lines first.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import get_preset
from ..ops import cost
from ..ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel, asw_sym_dlanes_kernel,
                        build, common, sgm_kernel)
from . import synthetic

GEOMETRIES = {
    "middlebury 450x375 D=64": ("middlebury_asw_full", {}, 375, 450),
    "kitti 1242x375 D=128": ("kitti_tiled", {}, 375, 1242),
    "kitti left-only": ("kitti_tiled", dict(asw_symmetric=False, kernel_layout="xlanes"), 375, 1242),
    "kitti box": ("kitti_tiled", dict(aggregation="box", kernel_layout="xlanes"), 375, 1242),
    "tsukuba box 384x288 D=16": ("tsukuba_ad_box", {}, 288, 384),
}
K3_GEOMETRIES = {
    "kitti left-only": ("kitti_tiled", dict(asw_symmetric=False), 375, 1242),
    "kitti box": ("kitti_tiled", dict(aggregation="box"), 375, 1242),
}

K4_GEOMETRIES = {
    "kitti 1242x375 D=128": ("kitti_tiled", dict(kernel_layout="dlanes"), 375, 1242),
    "middlebury 450x375 D=64": ("middlebury_asw_full", dict(kernel_layout="dlanes"), 375, 450),
}

K2_GEOMETRIES = {
    "kitti_sep": ("kitti_sep", {}, 375, 1242),
    "kitti_seplo": ("kitti_seplo", {}, 375, 1242),
}


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def k3_plans(H: int, W: int, D: int, r: int, box: bool) -> list:
    """K3's default plan, then the others of ty in 1, 2, 4, ... at 32, 64
    and 128 columns that fit."""
    best = asw_dlanes_kernel.tile_plan(H, W, D, r, box)
    out = [best]
    for tx in (32, 64, 128):
        for ty in (1, 2, 4, 8, 16):
            p = best._replace(ty=ty, tx=tx)
            if p.fits(r, box) and p not in out:
                out.append(p)
    return out


def k2_plans(H: int, W: int, D: int, r: int, sym: bool) -> list:
    """K2's default plan, then at 48, 64, 96 and 128 columns and d-chunks
    of 16, 32 and 64 (at most D rounded up to 8) the plans of the most rows
    512 threads allow and of half of them, each with the longest run of
    horizontal taps that fits."""
    best = asw_sep_kernel.tile_plan(H, W, D, r, sym)
    out = [best]
    for tx in (48, 64, 96, 128):
        for dc in sorted({min(c, -(-D // 8) * 8) for c in (16, 32, 64)}):
            full = asw_sep_kernel.TilePlan(1, tx, dc, 2 * r + 1)
            most = asw_sep_kernel.MAX_THREADS // full.threads(r)
            for ty in sorted({most, most // 2}):
                p = full._replace(ty=min(ty, H))
                while p.ty >= 1 and p.kx > 1 and not p.fits(r, sym):
                    p = p._replace(kx=p.kx - 1)
                if p.ty >= 1 and p.fits(r, sym) and p not in out:
                    out.append(p)
    return out


def k4_plans(H: int, W: int, D: int, r: int, count: int = 8) -> list:
    """K4's default plan; the ``count`` others of least estimated work whose
    tiles fill two or three consumer warpgroups exactly, each with the
    longest window-column run that fits; and the default plan with half its
    run and with two d-chunks."""
    k4 = asw_sym_dlanes_kernel
    best = k4.tile_plan(H, W, D, r)
    dc = best.dc
    cands = []
    for tx in range(8, 129, 8):
        per_row = (tx // 8) * (dc // 4)
        for tiles in (256, 384):
            if tiles % per_row == 0 and tiles // per_row <= H:
                p = k4.with_longest_run(k4.TilePlan(tiles // per_row, tx, dc, 2 * r + 1), D, r)
                if p is not None and p != best:
                    cands.append(p)
    cands.sort(key=lambda p: p.cost(H, W, D, r))
    out = [best] + cands[:count]
    for p in (best._replace(kx=-(-best.kx // 2)),
              k4.with_longest_run(best._replace(dc=-(-dc // 16) * 8, kx=2 * r + 1), D, r)):
        if p is not None and p.fits(D, r) and p not in out:
            out.append(p)
    return out


def plans(H: int, W: int, D: int, r: int, mode: int) -> list:
    """The default plan, then the others of ty in 1, 2, 4, ..."""
    best = asw_kernel.tile_plan(H, W, D, r, mode)
    out = [best]
    ty = 1
    while ty <= max(best.ty, 4):
        p = best._replace(ty=ty, kx=2 * r + 1)
        if p.fits(mode) and p not in out:
            out.append(p)
        ty *= 2
    return out


SGM_H, SGM_W, SGM_SEED = 375, 1242, 31


def sgm_volume(dev):
    """kitti_sgm's config and its raw cost volume of the SGM_H x SGM_W pair."""
    cfg = get_preset("kitti_sgm")
    p = synthetic.make_pair(height=SGM_H, width=SGM_W, max_disparity=cfg.max_disparity,
                            seed=SGM_SEED)
    vol = cost.cost_volume(torch.from_numpy(p["left"]).to(dev),
                           torch.from_numpy(p["right"]).to(dev), cfg)
    return cfg, vol


def sgm_time(dev, reps: int) -> dict:
    """The SGM kernel of the tree this file was imported from, over
    sgm_volume at 4 and 8 paths: the median ms of a call and a hash of S.
    It calls nothing of the kernel's wrapper but ``aggregate(vol, cfg)``, so
    that this file, copied into an older tree of the port that has the
    kernel, times that tree's kernel too (``--against``)."""
    cfg, vol = sgm_volume(dev)
    out = {"root": str(Path(sgm_kernel.__file__).resolve().parents[3]),
           "label": f"SGM kitti_sgm {SGM_W}x{SGM_H} D={cfg.max_disparity}"}
    for paths in (4, 8):
        c = cfg.replace(sgm_paths=paths)
        s = sgm_kernel.aggregate(vol, c)
        out[f"sha256_{paths}"] = hashlib.sha256(s.cpu().numpy().tobytes()).hexdigest()[:16]
        out[f"ms_{paths}"] = median_ms(lambda: sgm_kernel.aggregate(vol, c), reps)
    return out


def sgm_phase_ms(vol: torch.Tensor, cfg, plan, reps: int) -> list:
    """Median ms of each phase of ``plan`` launched alone (its sums read
    what the buffers hold; the bytes and the work are the phase's)."""
    return [median_ms(lambda: sgm_kernel._run(vol, cfg, plan._replace(phases=(ph,))), reps)
            for ph in plan.phases]


def sgm_sweep(card: str, dev, reps: int, against: list) -> bool:
    cfg, vol = sgm_volume(dev)
    D = cfg.max_disparity
    label = f"SGM kitti_sgm {SGM_W}x{SGM_H} D={D}"
    # the card's rate for plain streams of such volumes, beside the kernel's
    gb = vol.numel() * 4 / 1e9
    o, b = torch.empty_like(vol), vol.clone()
    for name, n, fn in (("copy_ (1 read + 1 write)", 2, lambda: o.copy_(vol)),
                        ("add (2 reads + 1 write)", 3, lambda: torch.add(vol, b, out=o))):
        ms = median_ms(fn, reps)
        print(f"{label} on {card}: torch {name} of the volume {ms:.3f} ms, "
              f"{n * gb / ms:.3f} TB/s", flush=True)
    del o, b
    # one row's step alone: 16 rows of l2r, each on a warp of its own
    rows = vol[:16].contiguous()
    full = sgm_kernel.plan(16, SGM_W, D, 4)
    one = full._replace(phases=(full.phases[0]._replace(slots=full.phases[0].slots[:1]),))
    ms = median_ms(lambda: sgm_kernel._run(rows, cfg, one), reps)
    print(f"{label} on {card}: 16 rows of l2r alone: {ms * 1e3 / SGM_W:.4f} us a step",
          flush=True)
    for paths in (4, 8):
        c = cfg.replace(sgm_paths=paths)
        ref = None
        for plan in (sgm_kernel.plan(SGM_H, SGM_W, D, paths),
                     sgm_kernel.plan(SGM_H, SGM_W, D, paths, vpl=0)):
            out = sgm_kernel.aggregate(vol, c, plan)
            if ref is None:
                ref = out
                if not torch.equal(out, sgm_kernel.aggregate_reference(vol, c)):
                    print(f"{label} {paths} paths: the default plan differs from the plain "
                          "version", flush=True)
                    return False
            same = torch.equal(out, ref)
            ms = median_ms(lambda: sgm_kernel.aggregate(vol, c, plan), reps)
            phases = sgm_phase_ms(vol, c, plan, reps)
            desc = f"vpl {plan.vpl} smem {[ph.smem_bytes for ph in plan.phases]}"
            print(f"{label} {paths} paths on {card}: {desc}: {ms:.3f} ms, phases "
                  + " / ".join(f"{t:.3f}" for t in phases)
                  + f" ms, same bits as the default plan: {same}", flush=True)
            if not same:
                return False
    if against:
        return sgm_against(card, against, reps)
    return True


def sgm_against(card: str, roots: list, reps: int) -> bool:
    """This tree's SGM kernel against each of ``roots``, in turns: each
    tree's ``sgm_time`` in a process of its own started in that tree."""
    here = str(Path(__file__).resolve().parents[2])
    ok = True
    for other in roots:
        other = str(Path(other).resolve())
        rows = []
        for root in (other, here, here, other):
            r = subprocess.run([sys.executable, "-m", "aswstereomatch_torch.utils.plan_sweep",
                                "--time-only", "--reps", str(reps)],
                               cwd=root, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                print(f"SGM against {root}: exit {r.returncode}; a tree whose plan_sweep has "
                      f"no --time-only takes this file copied in\n{r.stderr[-3000:]}",
                      flush=True)
                return False
            rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(f"{rows[-1]['label']} on {card}, tree {root} ({rows[-1]['root']}): 4 paths "
                  f"{rows[-1]['ms_4']:.3f} ms, 8 paths {rows[-1]['ms_8']:.3f} ms", flush=True)
        same = all(rows[0][k] == row[k] for row in rows for k in ("sha256_4", "sha256_8"))
        print(f"SGM against {other}: the same S bits in every run: {same}", flush=True)
        ok = ok and same
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k4", "sgm"), default="k1")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--geometry", nargs="*")
    ap.add_argument("--count", type=int, default=8,
                    help="K4: how many plans of least estimated work beside the default")
    ap.add_argument("--plan", action="append", default=[],
                    help="K4: TY,TX,DC,KX, instead of the sweep's plans (repeatable)")
    ap.add_argument("--against", nargs="*", default=[],
                    help="SGM: other trees of the repo whose SGM kernel to time beside this one")
    ap.add_argument("--time-only", action="store_true",
                    help="SGM: print this tree's sgm_time as one JSON line, nothing else")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.time_only:
        print(json.dumps(sgm_time(dev, args.reps)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    build.load()
    for ln in build.build_log().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("ptxas:", ln.strip())
    if args.kernel == "sgm":
        return 0 if sgm_sweep(card, dev, args.reps, args.against) else 1
    geometries = {"k1": GEOMETRIES, "k2": K2_GEOMETRIES, "k3": K3_GEOMETRIES,
                  "k4": K4_GEOMETRIES}[args.kernel]
    for name in args.geometry or list(geometries):
        preset, overrides, H, W = geometries[name]
        cfg = get_preset(preset).replace(**overrides)
        D, r = cfg.max_disparity, cfg.window_radius
        p = synthetic.make_pair(height=H, width=W, max_disparity=D, seed=31)
        ls, rs = common.stacks(torch.from_numpy(p["left"]).to(dev),
                               torch.from_numpy(p["right"]).to(dev), cfg)
        if args.kernel == "k2":
            sym = cfg.asw_symmetric
            if not sweep(f"{name} on {card}: K2", asw_sep_kernel, k2_plans(H, W, D, r, sym),
                         lambda plan: plan.smem_bytes(r, sym), ls, rs, cfg, args.reps,
                         lambda plan: plan.threads(r)):
                return 1
            continue
        if args.kernel == "k4":
            if not sweep(f"{name} on {card}: K4", asw_sym_dlanes_kernel,
                         ([asw_sym_dlanes_kernel.TilePlan(*map(int, p.split(",")))
                           for p in args.plan] or k4_plans(H, W, D, r, args.count)),
                         lambda plan: plan.smem_bytes(D), ls, rs, cfg, args.reps):
                return 1
            cfg1 = cfg.replace(kernel_layout="xlanes")
            k1 = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg1)
            k4 = asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg)
            same = all(torch.equal(k1[k], k4[k]) for k in k4)
            ms = median_ms(lambda: asw_kernel.wta_outputs_from_stacks(ls, rs, cfg1), args.reps)
            print(f"{name} on {card}: K1 over the same stacks {ms:.3f} ms, "
                  f"the same bits as K4: {same}", flush=True)
            continue
        if args.kernel == "k3":
            box = cfg.aggregation == "box"
            if not sweep(f"{name} on {card}: K3", asw_dlanes_kernel, k3_plans(H, W, D, r, box),
                         lambda plan: plan.smem_bytes(r, box), ls, rs, cfg, args.reps):
                return 1
            cfg1 = cfg.replace(kernel_layout="xlanes")
            ms = median_ms(lambda: asw_kernel.wta_outputs_from_stacks(ls, rs, cfg1), args.reps)
            print(f"{name} on {card}: K1 over the same stacks {ms:.3f} ms", flush=True)
            continue
        mode = asw_kernel._mode(cfg)
        if not sweep(f"{name} on {card}: K1", asw_kernel, plans(H, W, D, r, mode),
                     lambda plan: plan.smem_bytes(mode), ls, rs, cfg, args.reps):
            return 1
        if cfg.aggregation == "asw" and cfg.asw_symmetric and D <= 128:
            cfg4 = cfg.replace(kernel_layout="dlanes")
            ms = median_ms(lambda: asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg4),
                           args.reps)
            print(f"{name} on {card}: K4 over the same stacks {ms:.3f} ms", flush=True)
    return 0


def sweep(label, kernel, plan_list, smem_bytes, ls, rs, cfg, reps, threads=None) -> bool:
    """``kernel`` (a wrapper module taking ``plan=``) under each plan; prints
    each plan's median ms; False if a plan's planes differ from the first's.
    ``threads(plan)`` gives a plan's block size (default ``plan.threads()``)."""
    ref = None
    for plan in plan_list:
        out = kernel.wta_outputs_from_stacks(ls, rs, cfg, plan)
        if ref is None:
            ref = out
        same = all(torch.equal(out[k], ref[k]) for k in ref)
        ms = median_ms(lambda: kernel.wta_outputs_from_stacks(ls, rs, cfg, plan), reps)
        nthreads = threads(plan) if threads else plan.threads()
        print(f"{label} {tuple(plan)} threads {nthreads} smem {smem_bytes(plan)} B: "
              f"{ms:.3f} ms, same bits as the default plan: {same}", flush=True)
        if not same:
            return False
    return True


if __name__ == "__main__":
    raise SystemExit(main())
