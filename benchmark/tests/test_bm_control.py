"""The control against the limits, at the cells' own size, on the card: the
plain reference in TF32 (and the program's own bfloat16 path where it has
one) must come out not correct, and the program must come out correct, on
three seeds.  Run on a card with

    python -m pytest benchmark/tests/test_bm_control.py

The readings' own records are checked on the CPU at a small size.
"""

import pytest

from benchmark import harness
from benchmark.tests import control_readings

SEEDS = [101, 102, 103]
CASES = [("kitti_sep", "float32"), ("kitti_sep", "uint16_x256"), ("kitti_asw", "float32")]


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cells' own size")


@pytest.fixture(scope="module")
def records(card):
    out = {}
    for name in sorted({c for c, _ in CASES}):
        config = harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")
        out[name] = (config, control_readings.readings(config, SEEDS, SEEDS, emit=lambda s: None))
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("config_name,form", CASES)
def test_control_fails_and_program_passes(records, config_name, form):
    config, recs = records[config_name]
    for name, limit in config["limits"][form].items():
        for seed in SEEDS:
            worst: dict = {}
            for r in recs:
                if r["seed"] == seed:
                    worst[r["side"]] = max(worst.get(r["side"], 0.0), r[form][name])
            assert worst["program"] <= limit, (seed, name)
            assert worst["control_tf32"] > limit, (seed, name)
            if "program_bf16" in worst:
                assert worst["program_bf16"] > limit, (seed, name)


def test_readings_of_a_preset_on_the_cpu():
    """A preset that no configuration file names, read as the card reads
    it: the program's eager path is the reference bit for bit on the CPU,
    the control departs from it, and each record carries the reference's
    time and its bad-2.0."""
    config = control_readings.preset_config("kitti_sgm", "sgm", 24, 40, {"max_disparity": 8})
    assert config["stereo_config"]["aggregation"] == "sgm"
    recs = control_readings.readings(config, [2**31 + 5], [2**31 + 5], device="cpu", pool=2,
                                     emit=lambda s: None)
    assert {(r["side"], r["pair"]) for r in recs} == {
        (s, k) for s in ("program", "control_tf32") for k in (0, 1)}
    for r in recs:
        assert r["reference_s"] > 0 and r["reference_peak_bytes"] is None
        assert 0 <= r["reference_bad_2"] < 0.05
        off = r["float32"]["share_off_1e-05"]
        assert off == 0 if r["side"] == "program" else off > 0.1
