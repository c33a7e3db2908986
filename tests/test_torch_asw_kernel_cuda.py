"""The hand-written CUDA kernel against its plain PyTorch version, on the card.

These are chip_smoke.py's phase-3 comparisons (the reference kernel test's
geometries and bars), run as tests.  They need a CUDA device and nvcc, so
they skip on machines without a card; run them there with

    python -m pytest --noconftest tests/test_torch_asw_kernel_cuda.py

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


@pytest.mark.parametrize("case", chip_smoke.SMALL_CASES, ids=[c[0] for c in chip_smoke.SMALL_CASES])
def test_cuda_kernel_matches_plain_version(case):
    from aswstereomatch_torch.ops.cuda import asw_kernel

    before = asw_kernel.launches
    chip_smoke.check_small(*case, device=torch.device("cuda", 0))
    assert asw_kernel.launches == before + 1


@pytest.mark.parametrize("seed", range(8))
def test_cuda_kernel_fuzz_random_configs(seed):
    """Random small configs (test_pallas_kernel.py's fuzz, widened to D over
    one d-chunk of 128 and r up to 5; D not a multiple of 8 included):
    argmin agreement > 99.9%, and the float planes at the box bar where the
    argmin agrees."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel
    from aswstereomatch_torch.utils import synthetic

    rng = np.random.default_rng(100 + seed)
    cfg = StereoConfig(
        max_disparity=int(rng.choice([4, 8, 12, 37, 130, 160])),
        window_radius=int(rng.choice([1, 2, 3, 4, 5])),
        cost=str(rng.choice(["ad", "tad_grad"])),
        asw_symmetric=bool(rng.choice([True, False])),
        aggregation=str(rng.choice(["asw", "box"])),
        gamma_color=float(rng.uniform(5, 30)),
        gamma_spatial=float(rng.uniform(5, 40)),
        alpha=float(rng.uniform(0.5, 1.0)),
    )
    h, w = int(rng.integers(10, 30)), int(rng.integers(20, 60))
    p = synthetic.make_pair(height=h, width=w, max_disparity=cfg.max_disparity, seed=seed)
    dev = torch.device("cuda", 0)
    l, r = torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)
    got = asw_kernel.wta_outputs(l, r, cfg)
    ref = asw_kernel.wta_outputs_reference(l, r, cfg)
    for k in ("bestd", "rbestd"):
        assert (got[k] == ref[k]).float().mean().item() > 0.999, k
    chip_smoke.check_floats_where_argmin_agrees(
        {k: v.cpu().numpy() for k, v in got.items()},
        {k: v.cpu().numpy() for k, v in ref.items()}, cfg.max_disparity)


@pytest.mark.parametrize(
    "overrides,shape",
    [({}, (45, 150)), (dict(max_disparity=160), (16, 200)),
     (dict(asw_symmetric=False, max_disparity=37), (21, 90)),
     (dict(aggregation="box", max_disparity=130), (16, 170))],
    ids=["symmetric", "symmetric_d160", "left_only", "box_d130"],
)
def test_cuda_kernel_two_tile_plans_same_bits(overrides, shape):
    """One pair through the default tile plan and through another (one row,
    8 columns, d-chunks of 32, two runs of window columns), each passed to
    the launch: the six planes are equal bit for
    bit, since every output sums its taps in one (dy, dx) order."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel, common
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**chip_smoke._BASE, **overrides})
    D, r = cfg.max_disparity, cfg.window_radius
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, seed=4)
    dev = torch.device("cuda", 0)
    ls, rs = common.stacks(torch.from_numpy(p["left"]).to(dev),
                           torch.from_numpy(p["right"]).to(dev), cfg)
    default = asw_kernel.tile_plan(shape[0], shape[1], D, r, asw_kernel._mode(cfg))
    other = asw_kernel.TilePlan(ty=1, tx=8, dc=min(32, -(-D // 8) * 8), kx=r + 1)
    assert other != default
    a = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, default)
    b = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, other)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cuda_kernel_refuses_a_plan_it_cannot_run():
    """A plan over the thread or shared-memory limit raises; nothing runs."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel, common

    cfg = StereoConfig(**chip_smoke._BASE)
    z = torch.zeros((16, 64, 3), device="cuda")
    ls, rs = common.stacks(z, z, cfg)
    for plan in (asw_kernel.TilePlan(ty=64, tx=64, dc=8, kx=5),
                 asw_kernel.TilePlan(ty=1, tx=64, dc=12, kx=5)):
        with pytest.raises(RuntimeError, match="asw_wta launch failed"):
            asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, plan)


@pytest.mark.parametrize(
    "overrides",
    [{}, dict(median_mode="weighted"), dict(uniqueness_ratio=8.0, fill_holes=False),
     dict(asw_symmetric=False), dict(aggregation="box", window_radius=3)],
    ids=["full", "weighted_median", "uniqueness", "left_only", "box"],
)
def test_cuda_pipeline_matches_eager_on_the_card(overrides):
    """The kernel route end to end against the eager route, both on the card
    (test_pallas_kernel.py:86-87's bars)."""
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
    d_k = pipeline.match_pair(l, r, cfg).cpu().numpy()
    d_e = pipeline.match_pair(l, r, cfg.replace(backend="eager")).cpu().numpy()
    diff = np.abs(d_k - d_e)
    assert np.mean(diff <= 0.51) > 0.99
    assert np.mean(diff > 2.0) < 0.005
