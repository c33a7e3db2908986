"""Synthetic scenes in the datasets' own file formats, through the CLI.

The counterpart of the repository's ``tools/dataset_roundtrip.py``.  Each
scene is written as its dataset ships it, with the port's native PNG codec
(``utils/native.py``, which builds ``native/stereoio.cpp``):

  tsukuba      8-bit RGB PNG pair; GT 8-bit PNG, disparity x16 (Middlebury 2001)
  venus        the same, x8, made with D = 32 so that x8 fits 8 bits
  teddy/cones  the same, x4 (Middlebury 2003)
  kitti        GT uint16 PNG, disparity x256, 0 = invalid (occlusions)

The GT must decode exactly (``utils/io.read_gt_disparity``; synthetic
disparities are integers).  Then ``python -m aswstereomatch_torch.cli
--left --right --gt --dataset <scene> --preset ... --json ...`` runs, one
child process per scene, on the decoded files with ``--device``; it must
exit 0, and its record's bad-2.0 must equal that of the matcher run in
this process on the same decoded pair.

    python -m aswstereomatch_torch.tools.dataset_roundtrip [--dir DIR]
    python -m aswstereomatch_torch.tools.dataset_roundtrip --device cpu --scenes tsukuba --radius 4
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..config import get_preset
from ..models.pipeline import StereoMatcher
from ..utils import evaluate, io, native, synthetic
from . import common

# scene -> (H, W, D, GT scale, GT bit depth, extra CLI arguments)
SCENES = {
    "tsukuba": (288, 384, 16, 16.0, 8, ["--max-disparity", "16"]),
    # real venus disparities are < 32, which is why x8 fits 8 bits
    "venus": (375, 450, 32, 8.0, 8, ["--max-disparity", "32"]),
    "teddy": (375, 450, 64, 4.0, 8, []),
    "cones": (375, 450, 64, 4.0, 8, []),
    "kitti": (375, 1242, 128, 256.0, 16, ["--max-disparity", "128"]),
}


def write_scene(dir_: str, scene: str, seed: int):
    """Write ``scene``'s pair and GT in its dataset's format under
    ``dir_/scene``; returns (paths, pair, GT decode max error)."""
    h, w, d, scale, bits, _ = SCENES[scene]
    pair = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)
    sdir = os.path.join(dir_, scene)
    os.makedirs(sdir, exist_ok=True)
    paths = {k: os.path.join(sdir, f"{k}.png") for k in ("im0", "im1", "disp0")}
    native.write_png(paths["im0"], np.round(pair["left"]))
    native.write_png(paths["im1"], np.round(pair["right"]))
    enc = np.round(pair["gt"] * scale)
    if scene == "kitti":
        enc = np.where(pair["occluded"], 0.0, enc)  # 0 = invalid
    limit = 255 if bits == 8 else 65535
    if enc.max() > limit:
        raise ValueError(f"{scene}: GT {enc.max()} does not fit {bits} bits")
    native.write_png(paths["disp0"], enc, bit_depth=bits)
    # the scale convention must round-trip exactly (integer disparities)
    dec, valid = io.read_gt_disparity(paths["disp0"], scene)
    ref = np.where(pair["occluded"], 0.0, pair["gt"]) if scene == "kitti" else pair["gt"]
    err = float(np.abs(dec[valid] - ref[valid]).max()) if valid.any() else 0.0
    return paths, pair, err


def preset_for(scene: str) -> str:
    return "kitti_sep" if scene == "kitti" else "middlebury_asw_full"


def run(device, dir_=None, scenes=tuple(SCENES), radius=None, progress=print) -> dict:
    """Each of ``scenes`` written, decoded and matched through the CLI
    (``radius``, where given, overrides the presets' window radius)."""
    device = torch.device(device)
    dir_ = dir_ or tempfile.mkdtemp(prefix="asw_datasets_")
    rows = []
    routed = set()
    for i, scene in enumerate(SCENES):  # seeds follow the reference: 40 + index
        if scene not in scenes:
            continue
        paths, _, gt_err = write_scene(dir_, scene, seed=40 + i)
        _, _, _, scale, bits, extra = SCENES[scene]
        if radius is not None:
            extra = [*extra, "--window-radius", str(radius)]
        preset = preset_for(scene)
        rec_path = os.path.join(dir_, scene, "record.json")
        cmd = [sys.executable, "-m", "aswstereomatch_torch.cli",
               "--left", paths["im0"], "--right", paths["im1"], "--gt", paths["disp0"],
               "--dataset", scene, "--preset", preset, *extra, "--device", device.type,
               "--json", rec_path,
               "--out", os.path.join(dir_, scene, "disp_ours.png"),
               "--err-out", os.path.join(dir_, scene, "err.png")]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                              cwd=str(common.REPO))
        row = {"scene": scene,
               "gt_format": f"PNG {bits}-bit x{scale:g}" + (" (0=invalid)" if scene == "kitti"
                                                             else ""),
               "preset": preset,
               "valid_note": "nonocc (invalid-coded occlusions)" if scene == "kitti" else
                             "all pixels (Middlebury 8-bit GT has no invalid code; synthetic "
                             "GT is exact everywhere)",
               "gt_decode_max_err": gt_err, "cli_returncode": proc.returncode}
        if proc.returncode != 0:
            rows.append({**row, "ok": False, "cli_stderr": proc.stderr[-2000:]})
            progress(f"{scene}: the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
            continue
        with open(rec_path) as f:
            cli = json.load(f)
        # the same decoded pair in this process
        cfg = get_preset(preset).replace(
            max_disparity=cli["config"]["max_disparity"],
            window_radius=cli["config"]["window_radius"])
        routed.update(common.routed_kernels(cfg, device))
        left = io.read_image(paths["im0"]).astype(np.uint8)
        right = io.read_image(paths["im1"]).astype(np.uint8)
        gt, valid = io.read_gt_disparity(paths["disp0"], scene)
        disp = StereoMatcher(cfg, device=device)(left, right).cpu().numpy()
        here = {k: round(v, 5) for k, v in evaluate.bad_report(disp, gt, valid=valid).items()}
        ok = gt_err == 0.0 and cli["metrics"]["bad_2"] == here["bad_2"]
        rows.append({**row, "metrics": cli["metrics"], "pairs_per_s": cli["pairs_per_s"],
                     "config_hash": cli["config_hash"], "cli_device": cli["device"],
                     "in_process_metrics": here, "ok": ok})
        progress(f"{scene}: GT decode max err {gt_err}; CLI bad_2 {cli['metrics']['bad_2']}, "
                 f"in-process {here['bad_2']}, {cli['pairs_per_s']} pairs/s on "
                 f"{cli['device']} => {'ok' if ok else 'FAIL'}")
    return {
        "note": "synthetic scenes stored in the real datasets' on-disk formats (native PNG "
                "codec), matched through the CLI end to end; GT scale conventions "
                "round-trip exactly (checked)",
        "dir": dir_,
        "rows": rows,
        "ok": bool(rows) and all(r["ok"] for r in rows),
        "kernels_routed": sorted(routed),
        **common.environment(device),
    }


def main(argv=None) -> int:
    ap = common.parser("dataset_roundtrip", __doc__)
    ap.add_argument("--dir", help="where the scenes go (default: a new temporary directory)")
    ap.add_argument("--scenes", nargs="+", default=list(SCENES), choices=list(SCENES))
    ap.add_argument("--radius", type=int, help="window radius in place of the presets' 16")
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    rec = common.run_main("dataset_roundtrip", device, lambda: run(
        device, args.dir, args.scenes, args.radius))
    common.write_record(args.out, rec)
    print("wrote", args.out, "ok" if rec["ok"] else "FAILED")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
