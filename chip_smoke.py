"""On-card smoke run of the PyTorch/CUDA port's main path (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  1. device  — refuses to run without CUDA; prints the card's name and
               power limit (nvidia-smi) and the torch / CUDA versions;
  2. build   — builds the fused ASW kernel from ops/cuda/ with nvcc (sm_90a);
  3. small   — the kernel against its plain PyTorch version on the reference
               kernel test's geometries (tests/test_pallas_kernel.py);
  4. full    — the same comparison on a synthetic 450x375 pair, D=64, r=16;
  5. serve   — StereoMatcher.from_preset("middlebury_asw_full") answers three
               uint8 requests and a batch of two, then kitti_tiled's config
               matches one 1242x375 D=128 pair; launch counts are reset just
               before and read just after, and every kernel of the path must
               have launched;
  6. times   — median ms per pair of the kernel, of its plain version and of
               the end-to-end call, at both geometries (CUDA events).

Before the last line it prints one JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}.  Imports torch, numpy and the port
only (no jax).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# Phase-3 geometries and bars: tests/test_pallas_kernel.py's K1 fixtures.
# (name, config overrides, (H, W), make_pair kwargs, exact)
_BASE = dict(max_disparity=8, cost="tad_grad", aggregation="asw",
             window_radius=2, gamma_color=14.0, gamma_spatial=9.0)
SMALL_CASES = [
    ("symmetric", {}, (24, 40), dict(seed=3), True),
    ("left_only", dict(asw_symmetric=False), (24, 40), dict(seed=3), True),
    ("ad_cost", dict(cost="ad"), (24, 40), dict(seed=3), True),
    ("multi_xtile", {}, (16, 200), dict(seed=3), True),
    ("r0_d2", dict(max_disparity=2, window_radius=0), (13, 24),
     dict(seed=6, num_layers=1), True),
    ("r1_d4", dict(max_disparity=4, window_radius=1), (11, 40),
     dict(seed=6, num_layers=1), True),
    ("one_tile", {}, (8, 128), dict(seed=6, num_layers=1), True),
    # D > the kernel's d-chunk of 8: the WTA state carried across chunks
    ("r1_d12", dict(max_disparity=12, window_radius=1), (16, 48), dict(seed=3), True),
    ("d20", dict(max_disparity=20), (24, 48), dict(seed=3), True),
    ("box_ad", dict(aggregation="box", cost="ad", window_radius=3), (24, 40),
     dict(seed=12), False),
    ("box_tad", dict(aggregation="box", window_radius=3), (24, 40),
     dict(seed=12), False),
]


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def check_small(name, overrides, shape, pair_kw, exact, device) -> dict:
    """Kernel vs plain version on one phase-3 case; raises AssertionError."""
    import torch

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**_BASE, **overrides})
    D = cfg.max_disparity
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, **pair_kw)
    l = torch.from_numpy(p["left"]).to(device)
    r = torch.from_numpy(p["right"]).to(device)
    got = {k: v.cpu().numpy() for k, v in asw_kernel.wta_outputs(l, r, cfg).items()}
    ref = {k: v.cpu().numpy() for k, v in asw_kernel.wta_outputs_reference(l, r, cfg).items()}
    if exact:
        # bars of test_pallas_kernel.py:55-71 and :160-162
        np.testing.assert_array_equal(got["bestd"], ref["bestd"], err_msg=f"{name} bestd")
        np.testing.assert_array_equal(got["rbestd"], ref["rbestd"], err_msg=f"{name} rbestd")
        tol = dict(rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["bestc"], ref["bestc"], **tol, err_msg=f"{name} bestc")
        bd = ref["bestd"]
        mask = (bd > 0) & (bd < D - 1)
        for k in ("cm", "cp"):
            np.testing.assert_allclose(got[k][mask], ref[k][mask], **tol, err_msg=f"{name} {k}")
        np.testing.assert_allclose(got["ubest"], ref["ubest"], **tol, err_msg=f"{name} ubest")
    else:
        # box bars of test_pallas_kernel.py:173-178
        agree = float((got["bestd"] == ref["bestd"]).mean())
        ragree = float((got["rbestd"] == ref["rbestd"]).mean())
        assert agree > 0.999 and ragree > 0.999, f"{name}: agree {agree} / {ragree}"
        np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3,
                                   err_msg=f"{name} bestc")
    return {"case": name, "max_abs_err": float(np.abs(got["bestc"] - ref["bestc"]).max())}


def check_floats_where_argmin_agrees(got, ref, D, rtol=1e-4, atol=1e-3) -> dict:
    """bestc everywhere; ubest where bestd agrees; cm / cp where bestd agrees
    and both neighbours exist.  Numpy arrays; raises AssertionError, else
    returns each plane's max |got - ref| over its mask."""
    same = got["bestd"] == ref["bestd"]
    inner = same & (ref["bestd"] > 0) & (ref["bestd"] < D - 1)
    errs = {}
    for k, mask in (("bestc", np.ones_like(same)), ("cm", inner), ("cp", inner),
                    ("ubest", same)):
        np.testing.assert_allclose(got[k][mask], ref[k][mask], rtol=rtol, atol=atol,
                                   err_msg=k)
        errs[k] = float(np.abs(got[k][mask] - ref[k][mask]).max(initial=0.0))
    return errs


def _argmin_agreement(a, b):
    """(share within 0.51, share off by > 2): test_pallas_kernel.py:86-87."""
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return float(np.mean(diff <= 0.51)), float(np.mean(diff > 2.0))


def _median_ms(fn, reps: int) -> float:
    """Median of per-call CUDA-event times (after one warm-up call)."""
    import torch

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


def main() -> int:
    sys.path.insert(0, str(HERE))
    try:
        import torch

        import aswstereomatch_torch
    except ImportError as e:
        fail(f"import: {e} (run from a checkout of the repository)")
    if Path(aswstereomatch_torch.__file__).resolve().parent.parent != HERE:
        fail(f"aswstereomatch_torch loaded from {aswstereomatch_torch.__file__}, "
             f"not from the checkout at {HERE}")
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import asw_kernel, build
    from aswstereomatch_torch.utils import evaluate, synthetic

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("device: torch.cuda.is_available() is False; this script runs on a GPU only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    try:
        build.load()
    except build.BuildError as e:
        fail(f"build: {e}")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s; " + " | ".join(ptxas), flush=True)

    # ---- 3. kernel vs plain, small geometries ---------------------------
    small = []
    for case in SMALL_CASES:
        try:
            small.append(check_small(*case, device=dev))
        except AssertionError as e:
            fail(f"small {case[0]}: {e}")
    print("small: " + ", ".join(f"{s['case']} ok" for s in small), flush=True)

    # ---- 4. kernel vs plain, full Middlebury width ----------------------
    cfg_m = aswstereomatch_torch.get_preset("middlebury_asw_full")
    D_m = cfg_m.max_disparity
    pm = synthetic.make_pair(height=375, width=450, max_disparity=D_m, seed=11)
    lm = torch.from_numpy(pm["left"]).to(dev)
    rm = torch.from_numpy(pm["right"]).to(dev)
    got = {k: v.cpu().numpy() for k, v in asw_kernel.wta_outputs(lm, rm, cfg_m).items()}
    ref = {k: v.cpu().numpy()
           for k, v in asw_kernel.wta_outputs_reference(lm, rm, cfg_m).items()}
    full = {}
    for k in ("bestd", "rbestd"):
        close, gross = _argmin_agreement(got[k], ref[k])
        full[k] = (close, gross)
        if not (close > 0.99 and gross < 0.005):
            fail(f"full {k}: agreement {close:.6f}, |dd|>2 on {gross:.6f}")
    try:  # f32 sums of 1089 taps in another order: the box-kernel bar
        errs = check_floats_where_argmin_agrees(got, ref, D_m)
    except AssertionError as e:
        fail(f"full: {e}")
    max_abs_err = errs["bestc"]
    print(f"full: 450x375 D=64 r=16 bestd agree {full['bestd'][0]:.6f} "
          f"(|dd|>2 {full['bestd'][1]:.6f}), rbestd agree {full['rbestd'][0]:.6f} "
          f"(|dd|>2 {full['rbestd'][1]:.6f}), max_abs_err where bestd agrees "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)

    # ---- 5. main path: a matcher serving requests -----------------------
    matcher = aswstereomatch_torch.StereoMatcher.from_preset("middlebury_asw_full")
    if pipeline._resolve_backend(matcher.cfg, matcher.device) != "cuda":
        fail("serve: middlebury_asw_full does not resolve to the cuda backend")
    reqs = [synthetic.make_pair(height=375, width=450, max_disparity=D_m, seed=s)
            for s in (21, 22, 23)]
    kitti_cfg = aswstereomatch_torch.get_preset("kitti_tiled")
    pk = synthetic.make_pair(height=375, width=1242, max_disparity=128, seed=31)
    kitti = aswstereomatch_torch.StereoMatcher(kitti_cfg)
    u8 = lambda a: a.astype(np.uint8)  # noqa: E731  (lossless: 8-bit grid)
    torch.cuda.synchronize()

    asw_kernel.launches = 0
    disps = [matcher(u8(p["left"]), u8(p["right"])).cpu().numpy() for p in reqs]
    batch = matcher.batch(np.stack([u8(p["left"]) for p in reqs[:2]]),
                          np.stack([u8(p["right"]) for p in reqs[:2]])).cpu().numpy()
    dk = kitti(u8(pk["left"]), u8(pk["right"])).cpu().numpy()
    torch.cuda.synchronize()
    main_launches = asw_kernel.launches
    if main_launches != 6:
        fail(f"serve: the fused kernel launched {main_launches} times, expected 6")

    bads = []
    for p, d in zip(reqs, disps):
        rep = evaluate.bad_report(d, p["gt"], valid=~p["occluded"])
        if not (np.isfinite(d).all() and d.min() >= 0 and d.max() < D_m
                and rep["density"] == 1.0 and rep["bad_2"] < 0.05):
            fail(f"serve: bad map: min {d.min()}, max {d.max()}, {rep}")
        bads.append(rep["bad_2"])
    for i in range(2):
        if not np.array_equal(batch[i], disps[i]):
            fail(f"serve: batch[{i}] differs from the single call")
    rep_k = evaluate.bad_report(dk, pk["gt"], valid=~pk["occluded"])
    if not (dk.shape == (375, 1242) and np.isfinite(dk).all() and dk.min() >= 0
            and dk.max() < 128 and rep_k["density"] == 1.0):
        fail(f"serve: bad KITTI map: {rep_k}")
    print(f"serve: 3 requests 450x375 bad_2 {[round(b, 5) for b in bads]}, batch of 2 "
          f"== singles, KITTI 1242x375 D=128 bad_2 {rep_k['bad_2']:.5f} "
          f"density {rep_k['density']}; kernel launches {main_launches}", flush=True)

    # ---- 6. times -------------------------------------------------------
    times = {}
    for geo, cfg, p, m, reps in (("450x375", cfg_m, reqs[0], matcher, 5),
                                  ("1242x375", kitti_cfg, pk, kitti, 3)):
        l = torch.from_numpy(p["left"]).to(dev)
        r = torch.from_numpy(p["right"]).to(dev)
        lu, ru = u8(p["left"]), u8(p["right"])
        times[geo] = {
            "kernel_ms": _median_ms(lambda: asw_kernel.wta_outputs(l, r, cfg), reps),
            "plain_ms": _median_ms(lambda: asw_kernel.wta_outputs_reference(l, r, cfg), reps),
            "e2e_ms": _median_ms(lambda: m(lu, ru), reps),
        }
        t = times[geo]
        print(f"times {geo} D={cfg.max_disparity} on {card}: kernel {t['kernel_ms']:.3f} ms, "
              f"plain {t['plain_ms']:.3f} ms, end-to-end {t['e2e_ms']:.3f} ms/pair", flush=True)

    print(json.dumps({"kernels": [{
        "name": "asw_wta",
        "route": "cuda",
        "source": "aswstereomatch_torch/ops/cuda/asw_kernel.cu",
        "replaces": "aswstereomatch_tpu/ops/pallas/asw_kernel.py:166",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": times["450x375"]["kernel_ms"],
        "plain_ms": times["450x375"]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
