"""The hand-written separable CUDA kernel against its plain PyTorch version,
on the card.

These are chip_smoke.py's phase-3 K2 comparisons (the reference kernel
test's geometries and bars, tests/test_pallas_dlanes.py), run as tests, plus
random small configs and the kernel route end to end.  They need a CUDA
device and nvcc, so they skip on machines without a card; run them there
with

    python -m pytest --noconftest tests/test_torch_sep_kernel_cuda.py

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


@pytest.mark.parametrize("case", chip_smoke.SEP_SMALL_CASES,
                         ids=[c[0] for c in chip_smoke.SEP_SMALL_CASES])
def test_sep_kernel_matches_plain_version(case):
    from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sep_kernel

    before = (asw_kernel.launches, asw_sep_kernel.launches)
    chip_smoke.check_small(*case, device=torch.device("cuda", 0))
    assert (asw_kernel.launches, asw_sep_kernel.launches) == (before[0], before[1] + 1)


@pytest.mark.parametrize("name,sym", chip_smoke.SEP_BF16_CASES,
                         ids=[c[0] for c in chip_smoke.SEP_BF16_CASES])
def test_sep_kernel_bf16_storage(name, sym):
    chip_smoke.check_sep_bf16(name, sym, torch.device("cuda", 0))


@pytest.mark.parametrize("seed", range(8))
def test_sep_kernel_fuzz_random_configs(seed):
    """Random small separable configs (D not a multiple of the kernel's
    d-chunk, widths over several column tiles): argmin agreement > 99.9%,
    and the float planes at rtol 1e-4 / atol 1e-3 where the argmin agrees."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_sep_kernel
    from aswstereomatch_torch.utils import synthetic

    rng = np.random.default_rng(300 + seed)
    cfg = StereoConfig(
        max_disparity=int(rng.choice([2, 5, 12, 24, 40])),
        window_radius=int(rng.choice([0, 1, 3, 8, 32])),
        cost=str(rng.choice(["ad", "tad_grad"])),
        asw_symmetric=bool(rng.choice([True, False])),
        asw_separable=True,
        gamma_color=float(rng.uniform(5, 30)),
        gamma_spatial=float(rng.uniform(5, 40)),
        alpha=float(rng.uniform(0.5, 1.0)),
    )
    h, w = int(rng.integers(5, 30)), int(rng.integers(20, 300))
    p = synthetic.make_pair(height=h, width=w, max_disparity=cfg.max_disparity, seed=seed)
    dev = torch.device("cuda", 0)
    l, r = torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)
    got = asw_sep_kernel.wta_outputs(l, r, cfg)
    ref = asw_sep_kernel.wta_outputs_reference(l, r, cfg)
    for k in ("bestd", "rbestd"):
        assert (got[k] == ref[k]).float().mean().item() > 0.999, k
    chip_smoke.check_floats_where_argmin_agrees(
        {k: v.cpu().numpy() for k, v in got.items()},
        {k: v.cpu().numpy() for k, v in ref.items()}, cfg.max_disparity)


@pytest.mark.parametrize(
    "overrides",
    [{}, dict(asw_symmetric=False), dict(uniqueness_ratio=8.0, fill_holes=False),
     dict(median_mode="weighted")],
    ids=["sym", "left_only", "uniqueness", "weighted_median"],
)
def test_sep_pipeline_matches_eager_on_the_card(overrides):
    """The separable kernel route end to end against the eager route, both
    on the card (test_pallas_kernel.py:86-87's bars)."""
    import numpy as np

    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.ops.cuda import asw_sep_kernel
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**dict(max_disparity=16, window_radius=4, gamma_spatial=9.0,
                                 asw_separable=True), **overrides})
    p = synthetic.make_pair(height=48, width=80, max_disparity=16, seed=5)
    dev = torch.device("cuda", 0)
    l, r = torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)
    assert pipeline._resolve_backend(cfg, dev) == "cuda"
    before = asw_sep_kernel.launches
    d_k = pipeline.match_pair(l, r, cfg).cpu().numpy()
    assert asw_sep_kernel.launches == before + 1
    d_e = pipeline.match_pair(l, r, cfg.replace(backend="eager")).cpu().numpy()
    diff = np.abs(d_k - d_e)
    assert np.mean(diff <= 0.51) > 0.99
    assert np.mean(diff > 2.0) < 0.005


@pytest.mark.parametrize(
    "overrides,shape",
    [(dict(max_disparity=40, window_radius=5), (41, 130)),
     (dict(asw_symmetric=False, max_disparity=40, window_radius=5), (41, 130)),
     (dict(max_disparity=16, window_radius=32), (10, 70)),
     (dict(max_disparity=128, window_radius=3, volume_dtype="bfloat16"), (19, 100))],
    ids=["sym", "left_only", "sym_k65", "bf16_d128"],
)
def test_sep_kernel_two_tile_plans_same_bits(overrides, shape):
    """One pair through K2's default tile plan and through a one-row plan
    of 8 columns, chunks of 8 and runs of 3 taps (left-only: all K), each
    passed to the launch: the six planes are equal bit for bit, since every
    output sums its taps in one (dy, then dx) order."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_sep_kernel, common
    from aswstereomatch_torch.utils import synthetic

    cfg = StereoConfig(**{**chip_smoke._BASE, **chip_smoke._SYM, **overrides})
    D, r = cfg.max_disparity, cfg.window_radius
    p = synthetic.make_pair(height=shape[0], width=shape[1], max_disparity=D, seed=9)
    dev = torch.device("cuda", 0)
    ls, rs = common.stacks(torch.from_numpy(p["left"]).to(dev),
                           torch.from_numpy(p["right"]).to(dev), cfg)
    default = asw_sep_kernel.tile_plan(shape[0], shape[1], D, r, cfg.asw_symmetric)
    other = asw_sep_kernel.TilePlan(ty=1, tx=8, dc=8, kx=3 if cfg.asw_symmetric else 2 * r + 1)
    assert other != default and default.ty > 1
    a = asw_sep_kernel.wta_outputs_from_stacks(ls, rs, cfg, default)
    b = asw_sep_kernel.wta_outputs_from_stacks(ls, rs, cfg, other)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sep_kernel_refuses_a_plan_it_cannot_run():
    """A plan over the thread limit, over the shared memory, with a chunk
    that is no multiple of 8 or with runs longer than K raises; nothing
    runs."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sep_kernel, common

    z = torch.zeros((16, 64, 3), device="cuda")
    cfg = StereoConfig(**{**chip_smoke._BASE, **chip_smoke._SYM, "max_disparity": 128,
                          "window_radius": 16})
    ls, rs = common.stacks(z, z, cfg)
    for plan in (asw_sep_kernel.TilePlan(ty=8, tx=96, dc=32, kx=17),
                 asw_sep_kernel.TilePlan(ty=4, tx=96, dc=32, kx=33),
                 asw_sep_kernel.TilePlan(ty=1, tx=64, dc=12, kx=5),
                 asw_sep_kernel.TilePlan(ty=1, tx=64, dc=16, kx=34)):
        before = (asw_kernel.launches, asw_sep_kernel.launches)
        with pytest.raises(RuntimeError, match="asw_sep_wta launch failed"):
            asw_sep_kernel.wta_outputs_from_stacks(ls, rs, cfg, plan)
        assert (asw_kernel.launches, asw_sep_kernel.launches) == before
