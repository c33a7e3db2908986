"""Dataset sweep of the port with checkpoint/resume: the batch entry point.

The counterpart of the repository's ``tools/sweep.py`` (the JAX package's
sweep).  Runs a configured matcher over every pair in a directory on the
card, with the sweep manifest (``utils/manifest.py``) making the job
resumable after any crash: recovery is re-dispatch of unfinished pairs.
Pairs follow the layout ``<dir>/<id>_left.ppm`` + ``<dir>/<id>_right.ppm``
with optional ``<id>_gt.pfm``; disparity maps are written as
``<id>_disp.pfm``, and each pair's metrics go into the manifest.

``--make-synthetic N`` first writes a demo dataset of N synthetic pairs
(with exact ground truth).

Usage:
  python -m aswstereomatch_torch.tools.sweep --dir data --make-synthetic 8 \\
      --preset middlebury_asw_full --max-disparity 16 --window-radius 4
  # interrupt and re-run: completed pairs are skipped via the manifest

On the card (``--device cuda``, the default; raises without one) the sweep
holds the device lock (``utils/devlock.py``), waiting up to 300 s for it;
``--device cpu`` runs the plain PyTorch path and takes no lock.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import threading

import numpy as np
import torch

from ..config import get_preset
from ..models.pipeline import StereoMatcher
from ..utils import devlock, evaluate, io, manifest, native, synthetic
from .serve import encode_u16


def make_synthetic_dataset(dir_: str, n: int, height: int, width: int, max_d: int):
    os.makedirs(dir_, exist_ok=True)
    for i in range(n):
        pid = f"pair{i:04d}"
        pair = synthetic.make_pair(
            height=height, width=width, max_disparity=max_d, seed=i
        )
        for side in ("left", "right"):
            arr = pair[side].astype(np.uint8)
            with open(os.path.join(dir_, f"{pid}_{side}.ppm"), "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
                f.write(arr.tobytes())
        io.write_pfm(os.path.join(dir_, f"{pid}_gt.pfm"), pair["gt"])


def _to_device(a: np.ndarray, device):
    """``a`` as a tensor on ``device``.  8-bit sources ship as uint8 (4x
    fewer host-to-device bytes; widened to float32 on the card, lossless);
    16-bit PNM (maxval >= 256) and float sources must not: a uint8 cast
    would wrap them modulo 256.  On the card the copy is from pinned memory
    and does not wait for the kernels already queued."""
    if float(np.min(a)) >= 0 and float(np.max(a)) <= 255 and np.all(a == np.floor(a)):
        t = torch.from_numpy(a.astype(np.uint8))
    else:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Fetch:
    """A disparity on its way to the host.  On the card the copy into
    pinned host memory is enqueued right behind the pair's kernels and an
    event recorded after it; ``wait()`` waits on that event, not on the
    stream, so it does not wait for the kernels of the pairs submitted
    after this one.  On the CPU the result is already on the host."""

    def __init__(self, out):
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--make-synthetic", type=int, default=0)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--preset", default="middlebury_asw_full")
    ap.add_argument("--max-disparity", type=int)
    ap.add_argument("--window-radius", type=int)
    ap.add_argument("--backend", choices=["auto", "eager", "cuda"])
    ap.add_argument("--uniqueness-ratio", type=float,
                    help="cv2-style WTA-uniqueness confidence gate "
                    "(percent margin; 0 = off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pairs run: the card (default; raises "
                         "without one) or the CPU's plain PyTorch path")
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--queue-depth", type=int, default=4,
                    help="submit-ahead depth (pairs in flight on the device)")
    ap.add_argument("--fetch", choices=["u16", "f32"], default="u16",
                    help="disparity device->host format: u16 = x256 fixed "
                    "point (the KITTI on-disk encoding, 1/256 px steps, "
                    "0 = invalid; half the bytes); f32 = exact pipeline output")
    args = ap.parse_args(argv)

    cfg = get_preset(args.preset)
    overrides = {
        k: getattr(args, k)
        for k in ("max_disparity", "window_radius", "backend", "uniqueness_ratio")
        if getattr(args, k) is not None
    }
    if overrides:
        cfg = cfg.replace(**overrides)
    matcher = StereoMatcher(cfg, device=args.device)

    gates_holes = cfg.lr_check or cfg.uniqueness_ratio > 0
    if args.fetch == "u16" and gates_holes and not cfg.fill_holes:
        # The u16 encoding writes invalid (-1) as 0, KITTI's on-disk invalid
        # code, but io.write_pfm / evaluate below treat 0.0 as a legal zero
        # disparity, so hole-producing configs would score differently per
        # fetch mode.  Exact f32 keeps the -1 sentinel end to end.
        print(
            "note: fill_holes=False produces holes; forcing --fetch f32 "
            "to preserve the -1 invalid sentinel",
            file=sys.stderr,
        )
        args.fetch = "f32"

    if args.make_synthetic:
        make_synthetic_dataset(
            args.dir, args.make_synthetic, args.height, args.width,
            cfg.max_disparity,
        )

    read = native.read_pnm if native.available() else io.read_pnm
    pair_ids = sorted(
        os.path.basename(p)[: -len("_left.ppm")]
        for p in glob.glob(os.path.join(args.dir, "*_left.ppm"))
    )
    if not pair_ids:
        print(f"no pairs found in {args.dir}", file=sys.stderr)
        return 2

    # Software pipelining: a SUBMITTER THREAD keeps up to --queue-depth
    # pairs of device work ahead of the consumer loop, so decode,
    # host-to-device copy and launches of the next pairs overlap the current
    # pair's fetch, write and evaluation on the main thread.  Every launch
    # stays on the worker thread; the main thread only waits for results and
    # writes and records them: a pair is recorded done only after its file
    # is written.
    pending: dict = {}
    cond = threading.Condition()
    sub_queue: list = []
    queued_ids: set = set()
    done_flag = [False]

    def _submit_impl(pid: str) -> _Fetch:
        left = read(os.path.join(args.dir, f"{pid}_left.ppm"))
        right = read(os.path.join(args.dir, f"{pid}_right.ppm"))
        out = matcher(_to_device(left, matcher.device), _to_device(right, matcher.device))
        if args.fetch == "u16":
            out = encode_u16(out)
        return _Fetch(out)

    def _worker():
        while True:
            with cond:
                while not sub_queue and not done_flag[0]:
                    cond.wait(0.2)
                if not sub_queue:
                    return
                pid = sub_queue.pop(0)
            try:
                res = _submit_impl(pid)
            except Exception as e:  # noqa: BLE001 - re-raised on pid's turn
                res = e
            with cond:
                pending[pid] = res
                cond.notify_all()

    worker = threading.Thread(target=_worker, daemon=True)
    worker.start()

    def queue_submit(pid: str):
        with cond:
            if pid in queued_ids:
                return
            queued_ids.add(pid)
            sub_queue.append(pid)
            cond.notify_all()

    def process(pid: str, next_pids=()) -> dict:
        queue_submit(pid)
        # Enqueue successors before blocking: a failed successor submit is
        # stored and re-raised on ITS OWN turn; it never discards the
        # current pair's finished computation or record.
        for nxt in next_pids:
            queue_submit(nxt)
        with cond:
            while pid not in pending:
                if not worker.is_alive():
                    raise RuntimeError(
                        "sweep submitter thread died; completed work is in "
                        "the manifest: re-run to resume"
                    )
                cond.wait(0.5)
            res = pending.pop(pid)
        if isinstance(res, Exception):
            raise res
        disp = res.wait()
        if disp.dtype == np.uint16:
            disp = disp.astype(np.float32) / 256.0
        io.write_pfm(os.path.join(args.dir, f"{pid}_disp.pfm"), disp)
        rec = {"id": pid}
        gt_path = os.path.join(args.dir, f"{pid}_gt.pfm")
        if os.path.exists(gt_path):
            gt = io.read_pfm(gt_path)
            rec.update(
                {k: round(v, 5) for k, v in evaluate.bad_report(disp, gt).items()}
            )
        return rec

    mpath = args.manifest or os.path.join(args.dir, "sweep_manifest.json")
    lock = (devlock.device_lock("sweep", timeout_s=300) if matcher.device.type == "cuda"
            else contextlib.nullcontext())
    with lock:
        try:
            results = manifest.run_sweep(
                pair_ids, process, mpath, cfg.config_hash(), flush_every=1,
                pass_next=max(1, args.queue_depth),
            )
        finally:
            with cond:
                done_flag[0] = True
                cond.notify_all()
            worker.join(timeout=30)
    done = [r for r in results.values() if r]
    bad2 = [r["bad_2"] for r in done if "bad_2" in r]
    summary = {
        "pairs": len(done),
        "mean_bad_2": round(float(np.mean(bad2)), 5) if bad2 else None,
        "config_hash": cfg.config_hash(),
        "manifest": mpath,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
