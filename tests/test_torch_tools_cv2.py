"""The port's OpenCV comparison and refuse curve (``aswstereomatch_torch/
tools/compare_opencv.py``, ``tools/refuse_curve.py``) on the CPU at 48 x 96,
D = 16, r = 4.

With cv2 present the tools' cv2 rows equal cv2 computed here on the same
pair with the reference's scoring (``aswstereomatch_tpu.utils.evaluate``);
our maps agree with the reference's jnp pipeline at the pipeline bar of
tests/test_oracle_parity.py:141-143.  With cv2 made unimportable each
tool's ``main`` exits non-zero, unless ``--no-cv2`` is given, and then the
record says ``"cv2": "not run"`` and has no cv2 row.
"""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.utils import evaluate as ref_evaluate
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.tools import compare_opencv, refuse_curve

cv2 = pytest.importorskip("cv2")

SHAPE = (48, 96, 16)
R = 4
SMALL = ["--device", "cpu", "--shape", *map(str, SHAPE), "--radius", str(R)]
QUIET = lambda *a, **k: None  # noqa: E731


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread per pytest worker (six workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(fn, *args, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        maps = {}
        return fn(*args, maps=maps, **kw), maps
    finally:
        torch.set_num_threads(threads)


def cv2_maps(left, right, D, ratio=None):
    """cv2 StereoBM / StereoSGBM as the reference tools call them."""
    gl = cv2.cvtColor(left.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    gr = cv2.cvtColor(right.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    bm = cv2.StereoBM_create(numDisparities=D, blockSize=9)
    kw = {}
    if ratio is not None:
        bm.setUniquenessRatio(ratio)
        kw["uniquenessRatio"] = ratio
    d_bm = bm.compute(gl, gr).astype(np.float32) / 16.0
    sgbm = cv2.StereoSGBM_create(minDisparity=0, numDisparities=D, blockSize=5,
                                 P1=8 * 3 * 25, P2=32 * 3 * 25,
                                 mode=cv2.STEREO_SGBM_MODE_SGBM, **kw)
    d_sg = sgbm.compute(left.astype(np.uint8), right.astype(np.uint8)).astype(np.float32) / 16.0
    return d_bm, d_sg


@pytest.fixture(scope="module")
def opencv():
    return _run(compare_opencv.run, ["tsukuba"], "cpu", shape=SHAPE, radius=R, progress=QUIET)


def test_compare_opencv_cv2_rows_equal_cv2(opencv):
    rec, maps = opencv
    h, w, D = SHAPE
    pair = ref_synthetic.make_pair(height=h, width=w, max_disparity=D, seed=7)
    nonocc = ~pair["occluded"]
    d_bm, d_sg = cv2_maps(pair["left"], pair["right"], D)
    rows = {r["method"]: r for r in rec["rows"]}
    for method, disp, keep in (("cv2_StereoBM", d_bm, d_bm >= 0),
                               ("cv2_StereoSGBM", d_sg, d_sg >= 0),
                               ("ours_asw_full@BM_mask", maps[("tsukuba", "ours_asw_full")],
                                d_bm >= 0),
                               ("ours_asw_full@SGBM_mask", maps[("tsukuba", "ours_asw_full")],
                                d_sg >= 0)):
        want = ref_evaluate.bad_report(disp, pair["gt"], valid=nonocc & keep)
        assert {k: rows[method][k] for k in want} == {k: round(v, 5) for k, v in want.items()}
        assert rows[method]["coverage"] == round(float((nonocc & keep).sum() / nonocc.sum()), 4)
    assert rec["cv2"] == cv2.__version__
    ref_keys = set().union(*(r.keys() for r in json.load(open(
        compare_opencv.common.REPO / "bench_results" / "opencv_compare.json"))))
    assert all(ref_keys <= set(r) for r in rec["rows"])


@pytest.mark.parametrize("method", [m for m, _ in compare_opencv.our_configs(SHAPE[2], R)])
def test_compare_opencv_our_maps_match_reference(opencv, method):
    _, maps = opencv
    cfg = dict(compare_opencv.our_configs(SHAPE[2], R))[method]
    ref_cfg = RefConfig(**{**dataclasses.asdict(cfg), "backend": "jnp"})
    h, w, D = SHAPE
    pair = ref_synthetic.make_pair(height=h, width=w, max_disparity=D, seed=7)
    want = np.asarray(jax.jit(functools.partial(ref_pipeline.match_pair, cfg=ref_cfg))(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    got = maps[("tsukuba", method)]
    assert np.mean(np.abs(got - want) <= 0.51) > 0.995
    assert np.mean(np.abs(got - want) > 2.0) < 0.002


@pytest.fixture(scope="module")
def refuse():
    return _run(refuse_curve.run, ["kitti"], [7], "cpu", shape=SHAPE, radius=R, progress=QUIET)


def test_refuse_curve_cv2_rows_equal_cv2(refuse):
    rec, maps = refuse
    h, w, D = SHAPE
    pair = ref_synthetic.make_hard_pair(h, w, D, seed=7)
    nonocc = ~pair["occluded"]
    dense_exact = maps[("kitti", 7, "exact")][3]
    rows = {(r["method"], r["point"]): r for r in rec["rows"]}
    for ratio in refuse_curve.CV2_RATIOS:
        d_bm, d_sg = cv2_maps(pair["left"], pair["right"], D, ratio)
        for method, disp, keep in (("cv2_BM", d_bm, d_bm >= 0), ("cv2_SGBM", d_sg, d_sg >= 0),
                                   ("ours_exact_dense@BM_mask", dense_exact, d_bm >= 0),
                                   ("ours_exact_dense@SGBM_mask", dense_exact, d_sg >= 0)):
            rep = ref_evaluate.bad_report(disp, pair["gt"], valid=nonocc & keep)
            row = rows[(method, f"uniq={ratio}")]
            assert row["bad_2"] == round(rep["bad_2"], 5) and row["epe"] == round(rep["epe"], 4)
            assert row["coverage"] == round(float((nonocc & keep).sum() / nonocc.sum()), 4)
    assert len(rec["matched_coverage"]) == 2 * len(refuse_curve.CV2_RATIOS)
    assert len([r for r in rec["rows"] if r["method"] == "ours_exact_refuse"]) == len(
        refuse_curve.OUR_RATIOS)


@pytest.mark.parametrize("mode", ["exact", "sep", "sgm"])
def test_refuse_curve_confidence_matches_reference(refuse, mode):
    """Each mode's refuse map and confidence against the reference's jnp
    ``match_pair_with_confidence``: the LR mask and the operating points'
    coverage within 0.005."""
    _, maps = refuse
    agg, sep = {m: (a, s) for m, a, s in refuse_curve.MODES}[mode]
    cfg = refuse_curve.mode_config(SHAPE[2], agg, sep, R)
    ref_cfg = RefConfig(**{**dataclasses.asdict(cfg), "backend": "jnp"})
    h, w, D = SHAPE
    pair = ref_synthetic.make_hard_pair(h, w, D, seed=7)
    disp, uniq, lrv = (np.asarray(a) for a in jax.jit(functools.partial(
        ref_pipeline.match_pair_with_confidence, cfg=ref_cfg))(
            jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    o_disp, o_uniq, o_lrv, _ = maps[("kitti", 7, mode)]
    assert np.mean(o_lrv == lrv) > 0.995
    assert np.mean(np.abs(o_disp - disp) <= 0.51) > 0.995
    nonocc = ~pair["occluded"]
    for rr in refuse_curve.OUR_RATIOS:
        cov = lambda d, u: float((nonocc & (d >= 0) & (u >= rr)).sum() / nonocc.sum())  # noqa
        assert abs(cov(o_disp, o_uniq) - cov(disp, uniq)) <= 0.005, rr


@pytest.mark.parametrize("tool", [compare_opencv, refuse_curve],
                         ids=["compare_opencv", "refuse_curve"])
def test_without_cv2(tool, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    geom = ["--geom", "tsukuba"] if tool is compare_opencv else ["--geom", "kitti", "--seeds", "7"]
    out = tmp_path / "r.json"
    assert tool.main(SMALL + geom + ["--out", str(out)]) != 0
    assert "--no-cv2" in capsys.readouterr().err and not out.exists()
    assert tool.main(SMALL + geom + ["--out", str(out), "--no-cv2"]) == 0
    rec = json.loads(out.read_text())
    assert rec["cv2"] == "not run"
    assert rec["rows"] and not [r for r in rec["rows"] if "cv2" in r["method"]
                                or "@" in r["method"]]
    assert rec.get("matched_coverage", []) == []
