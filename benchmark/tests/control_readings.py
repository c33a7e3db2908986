"""Readings that the limits of the numbers compared are set from: the
program's answers and the control's against the plain reference, at a
configuration's size, on several seeds.

    python benchmark/tests/control_readings.py --config kitti_sep \\
        --seeds 1 2 3 --control-seeds 1 2 3 [--out readings.json]

or, for a preset that no configuration file names yet, ``--preset
kitti_sgm --reference sgm --height 375 --width 1242`` in place of
``--config`` (with ``--override key=value`` for a field of the preset).

For each seed it makes the cell's pool of pairs as a run does, and reads
``correctness.READINGS`` of

  - the program: ``StereoMatcher.__call__`` on the card, the timed path
    (answers as the "float32" and the "uint16_x256" form);
  - the control: the plain reference at ``precision="tf32"``, the operands
    of every weighted window sum rounded to TF32;
  - for a separable configuration also the program's own lower-precision
    path, ``volume_dtype="bfloat16"``;

each against the plain reference in float32.  Each record also carries
the reference's seconds for its pair, its peak device memory above what
was held before it, and its bad-2.0 against the pair's ground truth.  It
prints one JSON line per (seed, side) and the worst reading of each side.
``test_bm_control.py`` runs it on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from benchmark import correctness, harness  # noqa: E402
from benchmark.inputs import evaluate  # noqa: E402
from benchmark.reference import plain  # noqa: E402

FORMS = ("float32", "uint16_x256")


def as_form(disp: np.ndarray, form: str) -> np.ndarray:
    """A float32 map as the daemon answers it in ``form``, decoded: itself,
    or clip(round(d * 256), 0, 65535) / 256 (the "uint16_x256" wire)."""
    if form == "float32":
        return disp
    return (np.clip(np.round(disp * np.float32(256.0)), 0, 65535).astype(np.uint16)
            .astype(np.float32) / np.float32(256.0))


def _read(answer, ref) -> dict:
    return {form: correctness.readings(as_form(answer, form), ref, form) for form in FORMS}


def readings(config: dict, seeds, control_seeds, device: str = "cuda", pool: int = 4,
             emit=print) -> list:
    """One record per (seed, side, pair): its readings in both answer forms."""
    import torch
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models.pipeline import StereoMatcher

    cfg = StereoConfig(**config["stereo_config"])
    sides = {"program": StereoMatcher(cfg, device=device)}
    if cfg.asw_separable:
        sides["program_bf16"] = StereoMatcher(cfg.replace(volume_dtype="bfloat16"), device=device)
    records = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        for k, pair in enumerate(harness.make_pool(config, seed, pool)):
            l, r = pair["left"], pair["right"]
            if device == "cuda":
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ref = plain.disparity(l, r, config["stereo_config"], config["reference"], device=device)
            ref_s = time.perf_counter() - t0
            ref_peak = torch.cuda.max_memory_allocated() - held if device == "cuda" else None
            ref_bad2 = evaluate.bad_delta(ref, pair["gt"], 2.0, ~pair["occluded"])
            answers = {}
            if seed in seeds:
                answers.update({name: m(l, r).cpu().numpy() for name, m in sides.items()})
            if seed in control_seeds:
                t0 = time.perf_counter()
                answers["control_tf32"] = plain.disparity(
                    l, r, config["stereo_config"], config["reference"], device=device,
                    precision="tf32")
            for side, answer in answers.items():
                rec = {"config": config["name"], "seed": seed, "pair": k, "side": side,
                       "reference_s": ref_s, "reference_peak_bytes": ref_peak,
                       "reference_bad_2": ref_bad2, **_read(answer, ref)}
                records.append(rec)
                emit(json.dumps(rec))
            if device == "cuda":
                torch.cuda.empty_cache()
    for side in sorted({r["side"] for r in records}):
        for form in FORMS:
            worst = {n: max(r[form][n] for r in records if r["side"] == side)
                     for n in correctness.READINGS}
            emit(f"worst {config['name']} {side} {form}: {json.dumps(worst)}")
    return records


def preset_config(preset: str, reference: str, height: int, width: int,
                  overrides: dict) -> dict:
    """A configuration of the program's preset ``preset`` with
    ``overrides``, at ``height`` x ``width``, read against the reference
    module ``reference``."""
    import dataclasses

    from aswstereomatch_torch.config import get_preset

    cfg = get_preset(preset).replace(**overrides)
    name = preset + "".join(f".{k}-{v}" for k, v in sorted(overrides.items()))
    return {"name": name, "height": height, "width": width,
            "stereo_config": dataclasses.asdict(cfg), "reference": reference}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--config", help="a configuration file's name under benchmark/configs")
    which.add_argument("--preset", help="a preset of the program, with --reference and the size")
    ap.add_argument("--reference", help="the reference module of --preset")
    ap.add_argument("--height", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--override", action="append", default=[], metavar="KEY=JSON",
                    help="a field of --preset, its value as JSON")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.config:
        config = harness.load_json(harness.BENCH_DIR / "configs" / f"{args.config}.json")
    else:
        if not (args.reference and args.height and args.width):
            ap.error("--preset needs --reference, --height and --width")
        overrides = {k: json.loads(v) for k, v in (o.split("=", 1) for o in args.override)}
        config = preset_config(args.preset, args.reference, args.height, args.width, overrides)
    records = readings(config, args.seeds, args.control_seeds)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
