"""The benchmark's copies of chip_smoke.py's bounds give chip_smoke's
figures."""

import importlib.util
from types import SimpleNamespace

import pytest

from benchmark import harness, roofline

_spec = importlib.util.spec_from_file_location("chip_smoke", harness.REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _cfg(**kw):
    base = dict(aggregation="asw", window_radius=16, max_disparity=128, asw_symmetric=True,
                sgm_paths=4)
    return SimpleNamespace(**{**base, **kw})


def test_kitti_figures():
    assert roofline.k1_bound(375, 1242, _cfg()) == pytest.approx((4.046, "operations"), rel=1e-3)
    assert roofline.k2_bound(375, 1242, _cfg())[0] == pytest.approx(0.288, rel=1e-3)


@pytest.mark.parametrize("name,kw", [
    ("k1_bound", {}), ("k1_bound", {"asw_symmetric": False}), ("k2_bound", {}),
    ("k2_bound", {"asw_symmetric": False}), ("box_bound", {"aggregation": "box"}),
    ("sgm_bound", {"aggregation": "sgm"}), ("sgm_bound", {"aggregation": "sgm", "sgm_paths": 8}),
])
@pytest.mark.parametrize("shape", [(375, 1242, 128, 16), (375, 450, 64, 16), (288, 384, 16, 4)])
def test_copy_equals_chip_smoke(name, kw, shape):
    h, w, d, r = shape
    cfg = _cfg(max_disparity=d, window_radius=r, **kw)
    assert getattr(roofline, name)(h, w, cfg) == getattr(chip_smoke, name)(h, w, cfg)
