"""The hand-written d-lanes CUDA kernels (K3: left-only ASW and box,
asw_dlanes_kernel.cu; K4: symmetric ASW, asw_sym_dlanes_kernel.cu) against
their plain PyTorch version, on the card.

These are chip_smoke.py's phase-3 K3 and K4 comparisons (the reference
kernel tests' geometries and bars, tests/test_pallas_dlanes.py), run as
tests, plus random small configs and the kernel routes end to end.  They
need a CUDA device and nvcc, so they skip on machines without a card; run
them there with

    python -m pytest --noconftest tests/test_torch_dlanes_kernel_cuda.py

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


def _counts():
    from aswstereomatch_torch.ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel,
                                               asw_sym_dlanes_kernel)

    return (asw_kernel.launches, asw_sep_kernel.launches, asw_dlanes_kernel.launches,
            asw_sym_dlanes_kernel.launches)


@pytest.mark.parametrize("case", chip_smoke.DLANES_SMALL_CASES,
                         ids=[c[0] for c in chip_smoke.DLANES_SMALL_CASES])
def test_dlanes_kernel_matches_plain_version(case):
    before = _counts()
    chip_smoke.check_small(*case, device=torch.device("cuda", 0), kernel="asw_dlanes_kernel")
    assert _counts() == (before[0], before[1], before[2] + 1, before[3])


@pytest.mark.parametrize("case", chip_smoke.SYM_DLANES_SMALL_CASES,
                         ids=[c[0] for c in chip_smoke.SYM_DLANES_SMALL_CASES])
def test_sym_dlanes_kernel_matches_plain_version(case):
    before = _counts()
    chip_smoke.check_small(*case, device=torch.device("cuda", 0),
                           kernel="asw_sym_dlanes_kernel")
    assert _counts() == (before[0], before[1], before[2], before[3] + 1)


@pytest.mark.parametrize("seed", range(10))
def test_dlanes_kernels_fuzz_random_configs(seed):
    """Random small configs for K3 (left-only ASW or box) and K4 (symmetric):
    D anywhere in [2, 128] (not a multiple of the kernels' d-groups), r up
    to each kernel's bound, widths over several column tiles.  K3: argmin
    agreement > 99.9%; K4 > 99.5% (its bar); the float planes at rtol 1e-4
    / atol 1e-3 where the argmin agrees."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_dlanes_kernel, asw_sym_dlanes_kernel
    from aswstereomatch_torch.utils import synthetic

    rng = np.random.default_rng(500 + seed)
    mode = ["left_only", "box", "symmetric"][seed % 3]
    cfg = StereoConfig(
        max_disparity=int(rng.choice([2, 3, 7, 13, 40, 77, 128])),
        window_radius=int(rng.choice([0, 1, 4, 9, 31 if mode == "symmetric" else 32])),
        cost=str(rng.choice(["ad", "tad_grad"])),
        aggregation="box" if mode == "box" else "asw",
        asw_symmetric=mode == "symmetric",
        kernel_layout="dlanes",
        gamma_color=float(rng.uniform(5, 30)),
        gamma_spatial=float(rng.uniform(5, 40)),
        alpha=float(rng.uniform(0.5, 1.0)),
    )
    kernel = asw_sym_dlanes_kernel if mode == "symmetric" else asw_dlanes_kernel
    h, w = int(rng.integers(4, 24)), int(rng.integers(20, 300))
    p = synthetic.make_pair(height=h, width=w, max_disparity=cfg.max_disparity, seed=seed)
    dev = torch.device("cuda", 0)
    l, r = torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)
    got = kernel.wta_outputs(l, r, cfg)
    ref = kernel.wta_outputs_reference(l, r, cfg)
    bar = 0.995 if mode == "symmetric" else 0.999
    for k in ("bestd", "rbestd"):
        assert (got[k] == ref[k]).float().mean().item() > bar, k
    chip_smoke.check_floats_where_argmin_agrees(
        {k: v.cpu().numpy() for k, v in got.items()},
        {k: v.cpu().numpy() for k, v in ref.items()}, cfg.max_disparity)
    # the same launch again gives the same planes bit for bit
    again = kernel.wta_outputs(l, r, cfg)
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize(
    "overrides,shape",
    [(dict(asw_symmetric=False, max_disparity=40, window_radius=4), (19, 90)),
     (dict(aggregation="box", max_disparity=40, window_radius=4), (19, 90)),
     (dict(asw_symmetric=False, max_disparity=16, window_radius=32), (10, 70)),
     (dict(aggregation="box", max_disparity=128, window_radius=32), (11, 100))],
    ids=["left_only", "box", "left_only_k65", "box_k65_d128"],
)
def test_dlanes_kernel_two_tile_plans_same_bits(overrides, shape):
    """One pair through K3's default tile plan and through a one-row plan
    of 8 columns, each passed to the launch: the six planes are equal bit
    for bit, since every output sums its taps in one (dy, dx) order."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_dlanes_kernel, common
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**chip_smoke._BASE, "kernel_layout": "dlanes", **overrides})
    D, r, box = cfg.max_disparity, cfg.window_radius, cfg.aggregation == "box"
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, seed=9)
    dev = torch.device("cuda", 0)
    ls, rs = common.stacks(torch.from_numpy(p["left"]).to(dev),
                           torch.from_numpy(p["right"]).to(dev), cfg)
    default = asw_dlanes_kernel.tile_plan(shape[0], shape[1], D, r, box)
    other = asw_dlanes_kernel.TilePlan(ty=1, tx=8, dp=default.dp)
    assert other != default and default.ty > 1
    a = asw_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg, default)
    b = asw_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg, other)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_dlanes_kernel_refuses_a_plan_it_cannot_run():
    """A plan over the thread limit, with the wrong disparity width, or a
    box plan whose rows are no power of two raises; nothing runs."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_dlanes_kernel, common

    z = torch.zeros((16, 64, 3), device="cuda")
    for over, plan in ((dict(asw_symmetric=False, max_disparity=128),
                        asw_dlanes_kernel.TilePlan(ty=8, tx=64, dp=128)),
                       (dict(asw_symmetric=False), asw_dlanes_kernel.TilePlan(ty=1, tx=64, dp=16)),
                       (dict(aggregation="box"), asw_dlanes_kernel.TilePlan(ty=3, tx=64, dp=8))):
        cfg = StereoConfig(**{**chip_smoke._BASE, "kernel_layout": "dlanes", **over})
        ls, rs = common.stacks(z, z, cfg)
        before = _counts()
        with pytest.raises(RuntimeError, match="asw_dlanes_wta launch failed"):
            asw_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg, plan)
        assert _counts() == before


@pytest.mark.parametrize(
    "overrides,shape,plan",
    [(dict(max_disparity=40, window_radius=5), (29, 130), (1, 32, 24, 11)),
     (dict(max_disparity=64, window_radius=4), (29, 150), (2, 16, 64, 9)),
     (dict(max_disparity=128, window_radius=16), (20, 200), (1, 64, 128, 17)),
     (dict(max_disparity=16, window_radius=31), (10, 70), (3, 24, 8, 7))],
    ids=["d40_chunks", "d64", "d128_k33", "k63"],
)
def test_sym_dlanes_kernel_two_tile_plans_same_bits(overrides, shape, plan):
    """One pair through K4's default tile plan and through another (other
    rows, columns, runs of window columns, consumer warpgroups, and d-chunks
    where the other plan's dc is below D), each passed to the launch: the
    six planes are equal bit for bit, and equal K1's over the same stacks."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sym_dlanes_kernel, common
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**chip_smoke._BASE, "kernel_layout": "dlanes", **overrides})
    D, r = cfg.max_disparity, cfg.window_radius
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, seed=9)
    dev = torch.device("cuda", 0)
    ls, rs = common.stacks(torch.from_numpy(p["left"]).to(dev),
                           torch.from_numpy(p["right"]).to(dev), cfg)
    default = asw_sym_dlanes_kernel.tile_plan(shape[0], shape[1], D, r)
    other = asw_sym_dlanes_kernel.TilePlan(*plan)
    assert other != default and other.fits(D, r)
    a = asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg, default)
    b = asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg, other)
    k1 = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg.replace(kernel_layout="xlanes"))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], k1[k]), k


@pytest.mark.parametrize("D", [64, 2])
@pytest.mark.parametrize("case", chip_smoke.SYM_DLANES_SMALL_CASES[:4],
                         ids=[c[0] for c in chip_smoke.SYM_DLANES_SMALL_CASES[:4]])
def test_sym_dlanes_kernel_at_d64_and_d2(case, D):
    """K4 at D = 64 (one d-chunk filling every consumer thread) and D = 2
    against its plain version on tests/test_pallas_dlanes.py:185-196's
    geometries, at the reference's bars: argmin agreement > 99.5% in both
    views (:211-218) and |delta d| > 2 on fewer than 0.5% of the pixels."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_sym_dlanes_kernel
    from aswstereomatch_torch.utils import synthetic

    name, over, shape, pair_kw, bar = case
    cfg = StereoConfig(**{**chip_smoke._BASE, **over, "max_disparity": D})
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, **pair_kw)
    dev = torch.device("cuda", 0)
    l, r = torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)
    before = _counts()
    got = asw_sym_dlanes_kernel.wta_outputs(l, r, cfg)
    assert _counts() == (before[0], before[1], before[2], before[3] + 1)
    ref = asw_sym_dlanes_kernel.wta_outputs_reference(l, r, cfg)
    for k in ("bestd", "rbestd"):
        a, b = got[k].cpu().numpy(), ref[k].cpu().numpy()
        assert np.mean(a == b) > bar, k
        assert np.mean(np.abs(a - b) > 2) < 0.005, k
    chip_smoke.check_floats_where_argmin_agrees(
        {k: v.cpu().numpy() for k, v in got.items()},
        {k: v.cpu().numpy() for k, v in ref.items()}, D)


def test_sym_dlanes_kernel_refuses_a_plan_it_cannot_run():
    """A plan over the consumer-thread limit, with a window-column run past
    K, with columns not a multiple of 8, or over shared memory raises;
    nothing runs."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_sym_dlanes_kernel, common

    cfg = StereoConfig(**{**chip_smoke._BASE, "kernel_layout": "dlanes",
                          "max_disparity": 128, "window_radius": 16})
    z = torch.zeros((16, 64, 3), device="cuda")
    ls, rs = common.stacks(z, z, cfg)
    TP = asw_sym_dlanes_kernel.TilePlan
    for plan in (TP(2, 64, 128, 33), TP(2, 48, 128, 34), TP(2, 44, 128, 33),
                 TP(1, 96, 128, 33)):
        assert not plan.fits(128, 16)
        before = _counts()
        with pytest.raises(RuntimeError, match="asw_sym_dlanes_wta launch failed"):
            asw_sym_dlanes_kernel.wta_outputs_from_stacks(ls, rs, cfg, plan)
        assert _counts() == before

@pytest.mark.parametrize(
    "overrides",
    [dict(asw_symmetric=False), dict(asw_symmetric=False, uniqueness_ratio=8.0, fill_holes=False),
     dict(aggregation="box", window_radius=3, kernel_layout="dlanes"),
     dict(kernel_layout="dlanes"), dict(kernel_layout="dlanes", median_mode="weighted")],
    ids=["left_only", "left_only_uniqueness", "box_dlanes", "sym_dlanes", "sym_weighted_median"],
)
def test_dlanes_pipeline_matches_eager_on_the_card(overrides):
    """The d-lanes kernel routes end to end against the eager route, both on
    the card (test_pallas_dlanes.py:80-92's bars), and a batch equal to
    single calls bit for bit."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**dict(max_disparity=16, window_radius=4, gamma_spatial=9.0),
                          **overrides})
    p = synthetic.make_pair(height=48, width=80, max_disparity=16, seed=5)
    dev = torch.device("cuda", 0)
    l, r = torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)
    assert pipeline._resolve_backend(cfg, dev) == "cuda"
    before = _counts()
    d_k = pipeline.match_pair(l, r, cfg)
    k4 = cfg.kernel_layout == "dlanes" and cfg.aggregation == "asw" and cfg.asw_symmetric
    assert _counts() == (before[0], before[1], before[2] + (not k4), before[3] + k4)
    batch = pipeline.match_batch(torch.stack([l, l]), torch.stack([r, r]), cfg)
    assert torch.equal(batch[0], d_k) and torch.equal(batch[1], d_k)
    d_e = pipeline.match_pair(l, r, cfg.replace(backend="eager")).cpu().numpy()
    diff = np.abs(d_k.cpu().numpy() - d_e)
    assert np.mean(diff <= 0.51) > 0.99
    assert np.mean(diff > 2.0) < 0.005


def test_dlanes_on_unsupported_geometry_raises_on_the_card():
    from aswstereomatch_torch.config import get_preset
    from aswstereomatch_torch.models import pipeline

    dev = torch.device("cuda", 0)
    z = torch.zeros((8, 16, 3), device=dev)
    before = _counts()
    for overrides in (dict(max_disparity=256), dict(window_radius=32)):
        cfg = get_preset("kitti_tiled").replace(kernel_layout="dlanes", **overrides)
        with pytest.raises(ValueError, match="dlanes"):
            pipeline.match_pair(z, z, cfg)
    assert _counts() == before
