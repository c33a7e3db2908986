"""The fused kernel's plain PyTorch version against the reference's Pallas
kernel (run in interpret mode on the CPU, as tests/test_pallas_kernel.py
runs it), and the wrapper's device routing.

Same fixtures and bars as tests/test_pallas_kernel.py: exact bestd/rbestd
and rtol 1e-5 / atol 1e-4 on bestc/cm/cp/ubest for ASW (:55-71, :160-162);
> 99.9% argmin agreement and rtol 1e-4 / atol 1e-3 on bestc for box
(:173-178).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.ops.pallas import asw_kernel as ref_kernel
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.ops.cuda import asw_kernel
from aswstereomatch_torch.utils import convert

CFG = RefConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                gamma_color=14.0, gamma_spatial=9.0)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def both(ref_cfg, pair):
    """(port plain outputs, reference Pallas-kernel outputs) as numpy."""
    l, r = pair["left"], pair["right"]
    got = asw_kernel.wta_outputs_reference(torch.from_numpy(l), torch.from_numpy(r),
                                           port(ref_cfg))
    ref = J(ref_kernel.wta_outputs, cfg=ref_cfg)(jnp.asarray(l), jnp.asarray(r))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def assert_exact_outputs(got, ref, D, floats=True):
    np.testing.assert_array_equal(got["bestd"], ref["bestd"])
    np.testing.assert_array_equal(got["rbestd"], ref["rbestd"])
    if not floats:
        return
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["bestc"], ref["bestc"], **tol)
    bd = ref["bestd"]
    mask = (bd > 0) & (bd < D - 1)
    np.testing.assert_allclose(got["cm"][mask], ref["cm"][mask], **tol)
    np.testing.assert_allclose(got["cp"][mask], ref["cp"][mask], **tol)
    np.testing.assert_allclose(got["ubest"], ref["ubest"], **tol)


@pytest.mark.parametrize(
    "ref_cfg,shape",
    [
        (CFG, (24, 40)),
        (CFG.replace(asw_symmetric=False), (24, 40)),
        (CFG.replace(cost="ad"), (24, 40)),
        (CFG, (16, 200)),
        (CFG.replace(max_disparity=12, window_radius=1), (16, 48)),
        (CFG.replace(max_disparity=20), (24, 48)),
    ],
    ids=["symmetric", "left_only", "ad_cost", "multi_xtile", "r1_d12", "d20"],
)
def test_reference_outputs_match_pallas_kernel(ref_cfg, shape):
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=ref_cfg.max_disparity, seed=3)
    got, ref = both(ref_cfg, pair)
    assert got["bestd"].dtype == np.int32 and got["rbestd"].dtype == np.int32
    assert_exact_outputs(got, ref, ref_cfg.max_disparity)


@pytest.mark.parametrize(
    "r,D,shape",
    [(0, 2, (13, 24)), (1, 4, (11, 40)), (2, 8, (8, 128))],
    ids=["r0_d2", "r1_d4", "one_tile"],
)
def test_reference_edge_geometries_match_pallas_kernel(r, D, shape):
    ref_cfg = CFG.replace(max_disparity=D, window_radius=r)
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=6, num_layers=1)
    got, ref = both(ref_cfg, pair)
    assert_exact_outputs(got, ref, D, floats=False)


@pytest.mark.parametrize("cost_kind", ["ad", "tad_grad"])
def test_box_reference_matches_pallas_kernel(cost_kind):
    ref_cfg = CFG.replace(aggregation="box", cost=cost_kind, window_radius=3)
    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=12)
    got, ref = both(ref_cfg, pair)
    assert (got["bestd"] == ref["bestd"]).mean() > 0.999
    np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3)
    assert (got["rbestd"] == ref["rbestd"]).mean() > 0.999


@pytest.mark.parametrize("agg", ["asw", "box"])
def test_wrapper_on_cpu_is_the_plain_version(agg):
    cfg = port(CFG.replace(aggregation=agg, window_radius=3))
    pair = synthetic.make_pair(height=20, width=36, max_disparity=8, seed=2)
    l, r = torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"])
    before = asw_kernel.launches
    got = asw_kernel.wta_outputs(l, r, cfg)
    assert asw_kernel.launches == before  # no kernel launch for CPU tensors
    ref = asw_kernel.wta_outputs_reference(l, r, cfg)
    assert sorted(got) == sorted(ref) == ["bestc", "bestd", "cm", "cp", "rbestd", "ubest"]
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


@pytest.mark.parametrize(
    "overrides",
    [{}, dict(asw_symmetric=False), dict(aggregation="box"), dict(aggregation="none"),
     dict(asw_separable=True), dict(aggregation="sgm")],
)
def test_supports_matches_reference(overrides):
    ref_cfg = CFG.replace(**overrides)
    assert asw_kernel.supports(port(ref_cfg)) == ref_kernel.supports(ref_cfg)


def test_kernel_rejects_unsupported():
    cfg = port(CFG.replace(aggregation="none"))
    z = torch.zeros((8, 8, 3))
    for fn in (asw_kernel.wta_outputs, asw_kernel.wta_outputs_reference):
        with pytest.raises(ValueError):
            fn(z, z, cfg)
    with pytest.raises(ValueError):
        asw_kernel.wta_outputs_from_stacks(torch.zeros(7, 8, 8), torch.zeros(7, 8, 15), cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        asw_kernel.wta_outputs_from_stacks(torch.zeros(7, 8, 12, device="meta"),
                                           torch.zeros(7, 8, 19, device="meta"),
                                           port(CFG))


def test_build_failure_raises(monkeypatch, tmp_path):
    """A missing compiler is a BuildError, and no half-built library stays
    behind to be loaded later."""
    from aswstereomatch_torch.ops.cuda import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(build.BuildError, match="compiler not found"):
        build.library_path()
    assert not list((tmp_path / "build").iterdir())
