"""The port's accuracy tools (``aswstereomatch_torch/tools/
run_baseline_configs.py``, ``pin_sep_accuracy.py``, ``sym_vs_leftonly.py``)
on the CPU at 48 x 96, D = 16, r = 4, against the reference's jnp
``match_pair`` on the same numpy pairs.

Each row's map must agree with the reference's at the pipeline bar of
tests/test_oracle_parity.py:141-143 (|d - d_ref| <= 0.51 on more than
99.5% of pixels, > 2 on fewer than 0.2%), its bad-2.0 against GT within
0.002 of the reference map's, and each record's rows must carry every
field of the reference tool's committed record in ``bench_results/``.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.config import get_preset as ref_preset
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.utils import evaluate as ref_evaluate
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.tools import pin_sep_accuracy, run_baseline_configs, sym_vs_leftonly

REPO = Path(__file__).resolve().parents[1]
SHAPE = (48, 96, 16)
R = 4
QUIET = lambda *a, **k: None  # noqa: E731


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread per pytest worker (six workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _ref_fn(cfg: RefConfig):
    return jax.jit(functools.partial(ref_pipeline.match_pair, cfg=cfg.replace(backend="jnp")))


def ref_map(pair, cfg: RefConfig) -> np.ndarray:
    return np.asarray(_ref_fn(cfg)(jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))


def scene(name: str, seed: int) -> dict:
    """The reference's scene at SHAPE: make_dataset_pair's seed offset."""
    h, w, d = SHAPE
    seed += ref_synthetic._SCENE_SEED_OFFSET.get(name, 0)
    return ref_synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)


def hold(ours: np.ndarray, want: np.ndarray, pair, bad_2: float) -> None:
    assert np.mean(np.abs(ours - want) <= 0.51) > 0.995
    assert np.mean(np.abs(ours - want) > 2.0) < 0.002
    ref_bad = ref_evaluate.bad_report(want, pair["gt"], valid=~pair["occluded"])["bad_2"]
    assert abs(bad_2 - ref_bad) <= 0.002, (bad_2, ref_bad)


def committed(name: str):
    with open(REPO / "bench_results" / name) as f:
        return json.load(f)


def _run(fn, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        maps = {}
        return fn(maps=maps, **kw), maps
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def baseline():
    return _run(run_baseline_configs.run, device="cpu", shape=SHAPE, radius=R, progress=QUIET)


@pytest.mark.parametrize("preset,geom", [(p, g) for p, g, _ in run_baseline_configs.RUNS])
def test_baseline_row_matches_reference(baseline, preset, geom):
    rec, maps = baseline
    row = next(r for r in rec["rows"] if (r["preset"], r["geometry"]) == (preset, geom))
    cfg = ref_preset(preset).replace(mesh_data=1, mesh_tile=1, max_disparity=SHAPE[2],
                                     window_radius=R)
    assert row["config_hash"] == cfg.replace(backend="auto").config_hash()
    pair = scene(geom, 3)
    hold(maps[(preset, geom)], ref_map(pair, cfg), pair, row["bad_2"])


def test_baseline_record_fields(baseline):
    rec, _ = baseline
    ref_keys = set().union(*(r.keys() for r in committed("baseline_configs.json")))
    for row in rec["rows"]:
        assert ref_keys <= set(row)
    assert {"device", "power_limit", "torch", "cuda"} <= set(rec)
    assert rec["checks"] == [] and not rec["held_to_records"]  # a cut-down run


@pytest.fixture(scope="module", params=[False, True], ids=["symmetric", "left_only"])
def sep_record(request):
    return request.param, _run(pin_sep_accuracy.run, device="cpu", seeds=(0, 1),
                                left_only=request.param, shape=SHAPE, radius=R,
                                progress=QUIET)


@pytest.mark.parametrize("regime,seed", [("smooth", 0), ("smooth", 1), ("hard", 0),
                                         ("hard", 1)])
def test_sep_contract_rows_match_reference(sep_record, regime, seed):
    left_only, (rec, maps) = sep_record
    base = dict(max_disparity=SHAPE[2], cost="tad_grad", aggregation="asw", window_radius=R,
                lr_check=True, fill_holes=True, subpixel=True, median_filter=True)
    exact = RefConfig(**base)
    sep = RefConfig(**base, asw_separable=True, asw_symmetric=not left_only)
    assert (rec["config_hash_exact"], rec["config_hash_sep"]) == (
        exact.config_hash(), sep.config_hash())
    h, w, d = SHAPE
    pair = (ref_synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)
            if regime == "smooth" else ref_synthetic.make_hard_pair(h, w, d, seed=seed))
    row = next(r for r in rec["rows"] if (r["regime"], r["seed"]) == (regime, seed))
    de, ds = maps[(regime, seed)]
    want_e, want_s = ref_map(pair, exact), ref_map(pair, sep)
    hold(de, want_e, pair, row["exact_bad2_vs_gt"])
    hold(ds, want_s, pair, row["sep_bad2_vs_gt"])
    nonocc = ~pair["occluded"]
    ref_delta = ref_evaluate.bad_delta_between(want_s, want_e, 2.0, nonocc)
    assert abs(row["delta_bad2_vs_exact"] - ref_delta) <= 0.002


def test_sep_record_fields(sep_record):
    _, (rec, _) = sep_record
    ref = committed("sep_vs_exact_kitti.json")
    assert set(ref) <= set(rec)
    for row in rec["rows"]:
        assert set(ref["rows"][0]) <= set(row)
    assert set(rec["verdict"]) >= {"smooth_delta_max", "hard_delta_on_exact_correct_max",
                                   "hard_gt_cost_max", "pass", "line"}


def test_sep_verdict_of_reference_records():
    """The contract's verdict over the reference's own records: the
    symmetric mode passes, the left-only mode misses it (hard regime)."""
    ref = committed("sep_vs_exact_kitti.json")["rows"]
    lo = committed("seplo_vs_exact_kitti.json")["rows"]
    assert pin_sep_accuracy.verdict(ref)["pass"]
    assert not pin_sep_accuracy.verdict(lo)["pass"]


@pytest.fixture(scope="module")
def sym():
    return _run(sym_vs_leftonly.run, device="cpu", shape=SHAPE, radius=R, progress=QUIET)


@pytest.mark.parametrize("geom", sym_vs_leftonly.GEOMS)
@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "left_only"])
def test_sym_vs_leftonly_row_matches_reference(sym, geom, symmetric):
    rec, maps = sym
    row = next(r for r in rec["rows"] if (r["geometry"], r["symmetric"]) == (geom, symmetric))
    cfg = RefConfig(max_disparity=SHAPE[2], cost="tad_grad", aggregation="asw",
                    window_radius=R, lr_check=True, fill_holes=True, subpixel=True,
                    median_filter=True, asw_symmetric=symmetric)
    pair = scene(geom, 3)
    hold(maps[(geom, symmetric)], ref_map(pair, cfg), pair, row["bad_2"])
    assert set(committed("symmetric_vs_leftonly.json")[0]) <= set(row)
