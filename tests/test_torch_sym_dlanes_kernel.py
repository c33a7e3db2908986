"""The symmetric d-lanes kernel's plain PyTorch version against the
reference's Pallas kernel asw_sym_dlanes (run in interpret mode on the CPU,
as tests/test_pallas_dlanes.py runs it), and the wrapper's routing rules
against the reference's.

Bars are the reference's (tests/test_pallas_dlanes.py:197-218): argmin
agreement > 99.5% in both views (the Pallas kernel folds sw^2 into the left
weight and sums in another order) and bestc at rtol 1e-4 / atol 1e-3.
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
from aswstereomatch_tpu.ops.pallas import asw_sym_dlanes as ref_kernel
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sym_dlanes_kernel
from aswstereomatch_torch.utils import convert

# tests/test_pallas_dlanes.py's SCFG: symmetric ASW
SCFG = RefConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                 asw_symmetric=True, gamma_color=14.0, gamma_spatial=9.0)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize(
    "ref_cfg,shape",
    [
        (SCFG, (24, 40)),
        (SCFG, (21, 150)),
        (SCFG.replace(max_disparity=16, window_radius=3), (20, 100)),
        (SCFG.replace(max_disparity=128), (16, 192)),
    ],
    ids=["base", "multitile_odd", "d16_r3", "d128_multinb"],
)
def test_plain_version_matches_pallas_kernel(ref_cfg, shape):
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=ref_cfg.max_disparity, seed=3)
    got = asw_sym_dlanes_kernel.wta_outputs_reference(
        torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"]), port(ref_cfg))
    got = {k: v.numpy() for k, v in got.items()}
    ref = J(ref_kernel.wta_outputs, cfg=ref_cfg)(jnp.asarray(pair["left"]),
                                                 jnp.asarray(pair["right"]))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for k in ("bestd", "rbestd"):
        agree = np.mean(got[k] == ref[k])
        assert agree > 0.995, f"{k} argmin disagreement {1 - agree:.4%}"
    np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3)


def test_wrapper_on_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper computes the plain version, which is
    K1's plain version of the same function, and launches nothing."""
    cfg = port(SCFG.replace(window_radius=3, kernel_layout="dlanes"))
    pair = synthetic.make_pair(height=20, width=36, max_disparity=8, seed=2)
    l, r = torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"])
    before = asw_sym_dlanes_kernel.launches
    got = asw_sym_dlanes_kernel.wta_outputs(l, r, cfg)
    assert asw_sym_dlanes_kernel.launches == before
    ref = asw_kernel.wta_outputs_reference(l, r, cfg)
    assert sorted(got) == sorted(ref) == ["bestc", "bestd", "cm", "cp", "rbestd", "ubest"]
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def test_kernel_rejects_unsupported():
    z = torch.zeros((8, 8, 3))
    for ref_cfg in (SCFG.replace(max_disparity=256), SCFG.replace(window_radius=32),
                    SCFG.replace(asw_symmetric=False), SCFG.replace(aggregation="box"),
                    SCFG.replace(asw_separable=True)):
        for fn in (asw_sym_dlanes_kernel.wta_outputs,
                   asw_sym_dlanes_kernel.wta_outputs_reference):
            with pytest.raises(ValueError, match="symmetric d-lanes"):
                fn(z, z, port(ref_cfg))
    with pytest.raises(ValueError, match="no kernel for device"):
        asw_sym_dlanes_kernel.wta_outputs_from_stacks(torch.zeros(7, 8, 12, device="meta"),
                                                      torch.zeros(7, 8, 19, device="meta"),
                                                      port(SCFG))


def outcome(fn, cfg):
    """fn(cfg), or "raises" where it raises ValueError."""
    try:
        return fn(cfg)
    except ValueError:
        return "raises"


GRID_R = (2, 16, 30, 31, 32, 33)
GRID_MODES = list(itertools.product(("asw", "box"), (True, False), ("auto", "xlanes", "dlanes")))


@pytest.mark.parametrize("D", [2, 8, 64, 65, 128, 129, 256])
def test_supports_and_routed_match_reference(D):
    """test_pallas_dlanes.py:118-158, widened to D across the kernel's
    bounds, r across K = 61 / 63 / 65, both aggregations, both weight
    modes and every layout; raising on the same configs."""
    for r, (agg, sym, layout) in itertools.product(GRID_R, GRID_MODES):
        ref_cfg = SCFG.replace(max_disparity=D, window_radius=r, aggregation=agg,
                               asw_symmetric=sym, kernel_layout=layout)
        cfg = port(ref_cfg)
        assert asw_sym_dlanes_kernel.supports(cfg) == ref_kernel.supports(ref_cfg), ref_cfg
        assert (outcome(asw_sym_dlanes_kernel.routed, cfg)
                == outcome(ref_kernel.routed, ref_cfg)), ref_cfg
    sep = SCFG.replace(max_disparity=D, asw_separable=True, kernel_layout="dlanes")
    assert asw_sym_dlanes_kernel.supports(port(sep)) == ref_kernel.supports(sep) is False
