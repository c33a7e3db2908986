"""The plain reference against the port's eager path on the CPU, bit for
bit at small sizes, whatever its block of rows; and its TF32 rounding.  On
the CPU the port's SGM stage computes its plain version, which its kernel
equals bit for bit on the card."""

import numpy as np
import pytest
import torch

from benchmark.inputs import synthetic
from benchmark.reference import plain

CASES = {
    "exact": dict(asw_separable=False),
    "exact_left_only": dict(asw_separable=False, asw_symmetric=False),
    "separable": dict(asw_separable=True),
    "separable_left_only": dict(asw_separable=True, asw_symmetric=False),
    "exact_ad_uniqueness": dict(asw_separable=False, cost="ad", uniqueness_ratio=5.0),
    "exact_no_lr": dict(asw_separable=False, lr_check=False, subpixel=False),
    "sgm_4_paths": dict(aggregation="sgm"),
    "sgm_8_paths": dict(aggregation="sgm", sgm_paths=8),
    "sgm_no_lr": dict(aggregation="sgm", lr_check=False, subpixel=False),
    "sgm_ad_uniqueness": dict(aggregation="sgm", cost="ad", uniqueness_ratio=5.0),
}
AGGREGATIONS = ["asw_exact", "asw_separable", "sgm"]


def _fields(**kw):
    from aswstereomatch_torch.config import StereoConfig
    import dataclasses

    return dataclasses.asdict(StereoConfig(max_disparity=12, window_radius=4, **kw))


def _module(fields) -> str:
    """The reference module of ``fields``."""
    if fields["aggregation"] == "sgm":
        return "sgm"
    return "asw_separable" if fields["asw_separable"] else "asw_exact"


def _agg_fields(agg):
    return _fields(**{"asw_exact": dict(asw_separable=False),
                      "asw_separable": dict(asw_separable=True),
                      "sgm": dict(aggregation="sgm")}[agg])


def _pair(h=30, w=52, d=12, seed=3):
    p = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)
    return p["left"].astype(np.uint8), p["right"].astype(np.uint8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_eager_path(case):
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models.pipeline import StereoMatcher

    fields = _fields(**CASES[case])
    left, right = _pair()
    want = StereoMatcher(StereoConfig(**fields), device="cpu")(left, right).numpy()
    for rows in (7, 48):
        got = plain.disparity(left, right, fields, _module(fields), block_rows=rows)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("paths", [4, 8])
def test_a_whole_image_reference_ignores_block_rows(paths):
    """SGM's vertical and diagonal paths run across every row: its module
    takes the whole image as one block, whatever ``block_rows`` says."""
    from benchmark.reference import sgm

    assert sgm.WHOLE_IMAGE
    fields = _fields(aggregation="sgm", sgm_paths=paths)
    left, right = _pair(h=37, w=44, seed=8)
    want = plain.disparity(left, right, fields, "sgm")
    for rows in (1, 5, 36, 1000):
        np.testing.assert_array_equal(
            plain.disparity(left, right, fields, "sgm", block_rows=rows), want)


@pytest.mark.parametrize("agg", AGGREGATIONS)
def test_reference_matches_the_ground_truth(agg):
    """The reference is a sound matcher: bad-2.0 under 5% of the
    non-occluded pixels of a synthetic pair (the engine's own health bar)."""
    from benchmark.inputs import evaluate

    fields = _agg_fields(agg)
    p = synthetic.make_pair(height=48, width=80, max_disparity=12, seed=11)
    disp = plain.disparity(p["left"].astype(np.uint8), p["right"].astype(np.uint8), fields, agg)
    assert evaluate.bad_delta(disp, p["gt"], 2.0, ~p["occluded"]) < 0.05


def test_reference_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError):
        plain.config(_fields(median_mode="weighted"))
    left, right = _pair(h=12, w=20)
    with pytest.raises(ValueError):
        plain.disparity(left, right, _fields(aggregation="sgm", sgm_paths=2), "sgm")


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, 3.0 + 2**-10, -(1.0 + 2**-11)])
    y = plain.tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0, 3.0 + 2**-9, -(1.0 + 2**-10)]
    bits = y.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


@pytest.mark.parametrize("agg", AGGREGATIONS)
def test_tf32_control_departs_from_the_reference(agg):
    """The control's number reads above the program's own, which is 0 here:
    on the CPU the port's eager path is the reference bit for bit."""
    from benchmark import correctness

    fields = _agg_fields(agg)
    left, right = _pair(h=40, w=64, d=12, seed=5)
    ref = plain.disparity(left, right, fields, agg)
    ctl = plain.disparity(left, right, fields, agg, precision="tf32")
    assert correctness.readings(ctl, ref, "float32")["share_off_0"] > 0
    assert correctness.readings(ref, ref, "float32")["share_off_0"] == 0
