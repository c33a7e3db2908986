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
