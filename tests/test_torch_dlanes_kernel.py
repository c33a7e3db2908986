"""The d-lanes kernel's plain PyTorch version (left-only ASW and box) against
the reference's Pallas kernel asw_dlanes (run in interpret mode on the CPU,
as tests/test_pallas_dlanes.py runs it), and the wrapper's routing rules
against the reference's.

Bars are the reference's (tests/test_pallas_dlanes.py:56-77, :106-115):
exact bestd and rbestd, bestc at rtol 1e-4 / atol 1e-3, and cm / cp at the
same tolerance where both neighbours of bestd exist (the reference pads d
to 128 lanes, so its cp at bestd = D - 1 is not a cost).
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.ops.pallas import asw_dlanes as ref_kernel
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.ops.cuda import asw_dlanes_kernel, asw_kernel
from aswstereomatch_torch.utils import convert

# tests/test_pallas_dlanes.py's CFG: left-only ASW
CFG = RefConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                asw_symmetric=False, gamma_color=14.0, gamma_spatial=9.0)
BOX = RefConfig(max_disparity=16, cost="tad_grad", aggregation="box", window_radius=3,
                kernel_layout="dlanes")


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def both(ref_cfg, shape):
    """(port plain outputs, reference Pallas-kernel outputs) as numpy, on
    make_pair(seed=3) of ``shape``."""
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=ref_cfg.max_disparity, seed=3)
    got = asw_dlanes_kernel.wta_outputs_reference(
        torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"]), port(ref_cfg))
    ref = J(ref_kernel.wta_outputs, cfg=ref_cfg)(jnp.asarray(pair["left"]),
                                                 jnp.asarray(pair["right"]))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def assert_outputs_match(got, ref, D, triple=True):
    np.testing.assert_array_equal(got["bestd"], ref["bestd"])
    np.testing.assert_array_equal(got["rbestd"], ref["rbestd"])
    tol = dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["bestc"], ref["bestc"], **tol)
    if triple:
        bd = ref["bestd"]
        mask = (bd > 0) & (bd < D - 1)
        np.testing.assert_allclose(got["cm"][mask], ref["cm"][mask], **tol)
        np.testing.assert_allclose(got["cp"][mask], ref["cp"][mask], **tol)


@pytest.mark.parametrize(
    "ref_cfg,shape",
    [
        (CFG, (24, 40)),
        (CFG.replace(cost="ad"), (24, 40)),
        (CFG, (21, 150)),
        (CFG.replace(max_disparity=16, window_radius=3), (20, 100)),
        (CFG.replace(max_disparity=128), (16, 192)),
    ],
    ids=["base", "ad_cost", "multitile_odd", "d16_r3", "d128_multinb"],
)
def test_plain_version_matches_pallas_kernel(ref_cfg, shape):
    got, ref = both(ref_cfg, shape)
    assert got["bestd"].dtype == np.int32 and got["rbestd"].dtype == np.int32
    assert_outputs_match(got, ref, ref_cfg.max_disparity)


@pytest.mark.parametrize("shape", [(24, 40), (21, 150)], ids=["one", "multi"])
def test_box_plain_version_matches_pallas_kernel(shape):
    """test_pallas_dlanes.py:95-115: box through the d-lanes kernel."""
    got, ref = both(BOX, shape)
    assert_outputs_match(got, ref, BOX.max_disparity, triple=False)


@pytest.mark.parametrize("ref_cfg", [CFG, BOX], ids=["left_only", "box"])
def test_wrapper_on_cpu_is_the_plain_version(ref_cfg):
    """On a CPU tensor the wrapper computes the plain version, which is
    K1's plain version of the same function, and launches nothing."""
    cfg = port(ref_cfg)
    pair = synthetic.make_pair(height=20, width=36, max_disparity=cfg.max_disparity, seed=2)
    l, r = torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"])
    before = asw_dlanes_kernel.launches
    got = asw_dlanes_kernel.wta_outputs(l, r, cfg)
    assert asw_dlanes_kernel.launches == before
    ref = asw_kernel.wta_outputs_reference(l, r, cfg)
    assert sorted(got) == sorted(ref) == ["bestc", "bestd", "cm", "cp", "rbestd", "ubest"]
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def test_kernel_rejects_unsupported():
    z = torch.zeros((8, 8, 3))
    for ref_cfg in (CFG.replace(max_disparity=256), CFG.replace(window_radius=33),
                    CFG.replace(asw_symmetric=True), CFG.replace(asw_separable=True),
                    CFG.replace(aggregation="none")):
        for fn in (asw_dlanes_kernel.wta_outputs, asw_dlanes_kernel.wta_outputs_reference):
            with pytest.raises(ValueError, match="d-lanes"):
                fn(z, z, port(ref_cfg))
    with pytest.raises(ValueError, match="no kernel for device"):
        asw_dlanes_kernel.wta_outputs_from_stacks(torch.zeros(7, 8, 12, device="meta"),
                                                  torch.zeros(7, 8, 19, device="meta"),
                                                  port(CFG))


def outcome(fn, cfg):
    """fn(cfg), or "raises" where it raises ValueError."""
    try:
        return fn(cfg)
    except ValueError:
        return "raises"


# The routing grid (test_pallas_dlanes.py:118-158, widened): D across the
# kernel's bounds, r across K = 63 / 65 / 67, both aggregations, both weight
# modes and every layout.
GRID_R = (2, 16, 30, 31, 32, 33)
GRID_MODES = list(itertools.product(("asw", "box"), (True, False), ("auto", "xlanes", "dlanes")))


@pytest.mark.parametrize("D", [2, 8, 64, 65, 128, 129, 256])
def test_supports_and_routed_match_reference(D):
    for r, (agg, sym, layout) in itertools.product(GRID_R, GRID_MODES):
        ref_cfg = CFG.replace(max_disparity=D, window_radius=r, aggregation=agg,
                              asw_symmetric=sym, kernel_layout=layout)
        cfg = port(ref_cfg)
        assert asw_dlanes_kernel.supports(cfg) == ref_kernel.supports(ref_cfg), ref_cfg
        assert (outcome(asw_dlanes_kernel.routed, cfg)
                == outcome(ref_kernel.routed, ref_cfg)), ref_cfg


def test_routing_rules():
    """test_pallas_dlanes.py:118-158 on asw_dlanes_kernel.routed."""
    routed = lambda c: asw_dlanes_kernel.routed(port(c))  # noqa: E731
    assert routed(CFG)
    assert not routed(CFG.replace(asw_symmetric=True))
    assert not routed(CFG.replace(kernel_layout="xlanes"))
    assert routed(CFG.replace(aggregation="box", max_disparity=128))
    assert not routed(CFG.replace(aggregation="box", max_disparity=64))
    assert not routed(CFG.replace(aggregation="box"))
    assert routed(CFG.replace(aggregation="box", kernel_layout="dlanes"))
    assert not routed(CFG.replace(aggregation="box", max_disparity=128, kernel_layout="xlanes"))
    assert not routed(CFG.replace(asw_symmetric=True, kernel_layout="dlanes"))
    with pytest.raises(ValueError, match="dlanes"):
        routed(CFG.replace(max_disparity=256, kernel_layout="dlanes"))
