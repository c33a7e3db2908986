"""The hand-written SGM scan kernel (sgm_kernel.cu) against its plain
PyTorch version, on the card, bit for bit; and the card-side paths that
this kernel's slice brought (the kitti_sgm pipeline, eager y_chunks).

chip_smoke.py's small SGM geometries run as tests, each under the default
plan and, where that is the register path, the long-D path, plus the
pipeline at a small size.  They need a CUDA device and nvcc, so they skip on machines
without a card; run them there with

    python -m pytest --noconftest tests/test_torch_sgm_kernel_cuda.py

(tests/conftest.py imports jax, which the port does not need.)
"""

import importlib.util
from pathlib import Path

import pytest
import torch  # noqa: F401  (read by the skipif condition string)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# The condition string is evaluated when the test runs, not at import.
pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]


@pytest.mark.parametrize("case", chip_smoke.SGM_SMALL_CASES,
                         ids=[c[0] for c in chip_smoke.SGM_SMALL_CASES])
def test_sgm_kernel_matches_plain_version(case):
    from aswstereomatch_torch.ops.cuda import sgm_kernel

    before = sgm_kernel.launches
    n = chip_smoke.check_sgm(*case, device=torch.device("cuda", 0))
    assert n == len(chip_smoke.sgm_check_plans(*case[1], case[2]))
    assert sgm_kernel.launches == before + n


@pytest.mark.parametrize("shape", [(64, 256, 256), (64, 256, 128)], ids=["d256", "d128"])
def test_long_launches_count_the_long_d_volumes(shape):
    """A mid-size volume at D = 256, 8 paths, bit for bit with the plain
    version on the long-D path, which ``long_launches`` counts once per
    volume; a D = 128 volume takes the register path and leaves it."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import sgm_kernel

    H, W, D = shape
    cfg = StereoConfig(aggregation="sgm", max_disparity=D, sgm_paths=8)
    rng = np.random.default_rng(H + W + D)
    vol = torch.from_numpy((rng.random(shape) * 40.0).astype(np.float32)).cuda()
    ref = sgm_kernel.aggregate_reference(vol, cfg)
    before, long_before = sgm_kernel.launches, sgm_kernel.long_launches
    for _ in range(2):
        assert torch.equal(sgm_kernel.aggregate(vol, cfg), ref)
    long_d = D > sgm_kernel.REG_MAX_D
    assert sgm_kernel.launches - before == 2
    assert sgm_kernel.long_launches - long_before == (2 if long_d else 0)


@pytest.mark.parametrize("paths", [4, 8])
def test_sgm_pipeline_on_card_equals_plain_sgm_pipeline(paths, monkeypatch):
    """A kitti_sgm-style config through StereoMatcher: one SGM launch per
    pair, none of K1-K4, and the map of the same pipeline with the plain
    SGM bit for bit."""
    import numpy as np

    import aswstereomatch_torch as asm
    from aswstereomatch_torch.ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel,
                                               asw_sym_dlanes_kernel, sgm_kernel)
    from aswstereomatch_torch.utils import synthetic

    p = synthetic.make_pair(height=48, width=96, max_disparity=24, seed=4)
    m = asm.StereoMatcher(asm.StereoConfig(max_disparity=24, aggregation="sgm",
                                           sgm_paths=paths))
    others = [k.launches for k in (asw_kernel, asw_sep_kernel, asw_dlanes_kernel,
                                   asw_sym_dlanes_kernel)]
    before = sgm_kernel.launches
    got = m(p["left"], p["right"]).cpu().numpy()
    torch.cuda.synchronize()
    assert sgm_kernel.launches == before + 1
    assert others == [k.launches for k in (asw_kernel, asw_sep_kernel, asw_dlanes_kernel,
                                           asw_sym_dlanes_kernel)]
    monkeypatch.setattr(sgm_kernel, "aggregate", sgm_kernel.aggregate_reference)
    np.testing.assert_array_equal(got, m(p["left"], p["right"]).cpu().numpy())


def test_eager_y_chunks_on_card_bit_for_bit():
    """The eager path in bands on the card: a window of 169 taps (summed in
    ops/aggregate.py::_window_sum's fixed order), W = 66 and an odd halo,
    so that bands start at addresses of every alignment."""
    import aswstereomatch_torch as asm
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.utils import synthetic

    p = synthetic.make_pair(height=90, width=66, max_disparity=16, seed=13)
    dev = torch.device("cuda", 0)
    l = torch.from_numpy(p["left"]).to(dev)
    r = torch.from_numpy(p["right"]).to(dev)
    cfg = asm.StereoConfig(max_disparity=16, window_radius=6, gamma_spatial=9.0,
                           backend="eager")
    want = pipeline.match_pair(l, r, cfg)
    for n in (2, 3, 4):
        assert torch.equal(pipeline.match_pair(l, r, cfg.replace(y_chunks=n)), want), n
