"""The port's flagship sharded check (``aswstereomatch_torch/tools/
flagship_sharded_check.py``) on the CPU at a cut-down geometry: every
layout's row exact, the rows of the reference's record
(``bench_results/sharded_flagship.json``, written by ``tools/
flagship_sharded_check.py``) with its interpret-mode Pallas rows as the
port's K1 rows, and the unsharded eager map against the reference's jnp
pipeline at the pipeline bar of tests/test_oracle_parity.py:141-143.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.tools import common, flagship_sharded_check as flagship
from aswstereomatch_torch.utils import convert

REPO = Path(__file__).resolve().parents[1]
H, W, D, R = 24, 160, 32, 4
ROWS = ["exact_asw/y_tile", "exact_asw/x_tile", "exact_asw/d_shard",
        "separable_asw/y_tile", "separable_asw/x_tile", "separable_asw/d_shard",
        "kernel/x_tile2", "kernel/x_tile4"]


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread per pytest worker (six workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return flagship.run_checks("cpu", height=H, width=W, d_max=D, radius=R,
                                   progress=lambda *a: None)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("layout", ROWS)
def test_flagship_row_exact(record, layout):
    row = next(r for r in record["rows"] if r["layout"] == layout)
    assert row["exact"] and row["differing_pixels"] == 0, row
    assert row["shape"] == [H, W] and row["max_disparity"] == D and row["window_radius"] == R
    want = "kernel" if layout.startswith("kernel") or layout == "separable_asw/y_tile" else "eager"
    assert row["route"] == want


def test_flagship_rows_are_the_reference_records(record):
    """The reference's layouts in its order, its Pallas interpret rows
    renamed ``kernel/``; each row's keys a superset of the reference's."""
    with open(REPO / "bench_results" / "sharded_flagship.json") as f:
        ref = json.load(f)
    names = [r["layout"].replace("pallas_interpret/", "kernel/") for r in ref["rows"]]
    assert [r["layout"] for r in record["rows"]] == names == ROWS
    for ours, theirs in zip(record["rows"], ref["rows"]):
        assert set(theirs) <= set(ours)
    assert set(ref) <= set(record)
    assert record["all_exact"] and record["kernels_routed"] == []  # no launches off the card


@pytest.mark.parametrize("separable", [False, True], ids=["exact", "separable"])
def test_flagship_unsharded_matches_reference(separable):
    """The unsharded map every eager row is held to, against the
    reference's jnp ``match_pair`` on the same pair."""
    ref_cfg = RefConfig(max_disparity=D, cost="tad_grad", aggregation="asw", window_radius=R,
                        lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
                        asw_separable=separable, backend="jnp")
    cfg = flagship._base_cfg(D, R).replace(asw_separable=separable, backend="eager")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        convert.from_reference(dataclasses.asdict(ref_cfg)))
    pair = ref_synthetic.make_pair(height=H, width=W, max_disparity=D, seed=9)
    want = np.asarray(jax.jit(functools.partial(ref_pipeline.match_pair, cfg=ref_cfg))(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    got = pipeline.match_pair(*common.to_device(pair, "cpu"), cfg).numpy()
    assert np.mean(np.abs(got - want) <= 0.51) > 0.995
    assert np.mean(np.abs(got - want) > 2.0) < 0.002
