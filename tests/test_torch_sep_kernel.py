"""The separable kernel's plain PyTorch version against the reference's
separable Pallas kernel (asw_sep_dlanes, run in interpret mode on the CPU as
tests/test_pallas_dlanes.py runs it), against the reference's jnp volume on
the rest of that file's fixtures, and the wrapper's routing rules.

Bars are the reference's (tests/test_pallas_dlanes.py:304-312, :360-365):
exact bestd and rbestd, bestc at rtol 1e-4 / atol 1e-3; the bf16 storage
mode against the f32 one at > 99.5% argmin agreement, |delta| > 2 on fewer
than 0.2% and winner cost at rtol / atol 1e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.ops import postprocess as ref_postprocess
from aswstereomatch_tpu.ops.pallas import asw_sep_dlanes as ref_kernel
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sep_kernel
from aswstereomatch_torch.utils import convert

# tests/test_pallas_dlanes.py's SEP fixture config
SEP = RefConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                asw_symmetric=False, gamma_color=14.0, gamma_spatial=9.0,
                asw_separable=True)
SYM = SEP.replace(asw_symmetric=True)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def plain(ref_cfg, pair):
    got = asw_sep_kernel.wta_outputs_reference(
        torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"]), port(ref_cfg))
    return {k: v.numpy() for k, v in got.items()}


def assert_outputs_match(got, ref):
    np.testing.assert_array_equal(got["bestd"], ref["bestd"])
    np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got["rbestd"], ref["rbestd"])


@pytest.mark.parametrize(
    "ref_cfg,shape",
    [
        (SYM, (24, 40)),
        (SEP, (24, 40)),
        # the flagship K=33 window
        (SYM.replace(max_disparity=16, window_radius=16), (12, 80)),
        # bfloat16 cost storage, both weight modes
        (SYM.replace(volume_dtype="bfloat16"), (24, 40)),
        (SEP.replace(volume_dtype="bfloat16"), (24, 40)),
    ],
    ids=["sym", "leftonly", "k33_flagship", "bf16_sym", "bf16_leftonly"],
)
def test_plain_version_matches_pallas_kernel(ref_cfg, shape):
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=ref_cfg.max_disparity, seed=3)
    got = plain(ref_cfg, pair)
    ref = J(ref_kernel.wta_outputs, cfg=ref_cfg)(jnp.asarray(pair["left"]),
                                                 jnp.asarray(pair["right"]))
    assert got["bestd"].dtype == np.int32 and got["rbestd"].dtype == np.int32
    assert_outputs_match(got, {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize(
    "ref_cfg,shape",
    [
        (SYM.replace(cost="ad"), (24, 40)),
        (SYM, (21, 150)),
        (SYM.replace(max_disparity=16, window_radius=3), (20, 100)),
        (SYM.replace(max_disparity=128), (16, 192)),
        (SYM.replace(max_disparity=16, window_radius=32), (10, 70)),
        (SEP.replace(max_disparity=16, window_radius=16), (12, 80)),
    ],
    ids=["ad_cost", "multitile_odd", "d16_r3", "d128_multinb", "k65_boundary",
         "leftonly_k33"],
)
def test_plain_version_matches_jnp_volume(ref_cfg, shape):
    """The rest of test_pallas_dlanes.py's separable fixtures, held against
    the argmin of the reference's jnp aggregated volume (the reference holds
    its kernel to the same volume there)."""
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=ref_cfg.max_disparity, seed=3)
    got = plain(ref_cfg, pair)
    vol = J(ref_pipeline.aggregated_volume, cfg=ref_cfg)(jnp.asarray(pair["left"]),
                                                        jnp.asarray(pair["right"]))
    volr = np.asarray(J(ref_postprocess.right_volume)(vol))
    vol = np.asarray(vol)
    assert_outputs_match(got, {"bestd": np.argmin(vol, -1), "bestc": vol.min(-1),
                               "rbestd": np.argmin(volr, -1)})


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "leftonly"])
def test_bf16_storage_tracks_f32(sym):
    """test_pallas_dlanes.py:346-365 on the port's plain version."""
    cfg32 = port(SEP.replace(asw_symmetric=sym, max_disparity=32, window_radius=8))
    cfg16 = cfg32.replace(volume_dtype="bfloat16")
    pair = synthetic.make_pair(height=40, width=120, max_disparity=32, seed=7)
    l, r = torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"])
    o32 = asw_sep_kernel.wta_outputs_reference(l, r, cfg32)
    o16 = asw_sep_kernel.wta_outputs_reference(l, r, cfg16)
    d32, d16 = o32["bestd"].numpy(), o16["bestd"].numpy()
    assert not torch.equal(o16["bestc"], o32["bestc"])  # the rounding happened
    assert np.mean(d32 == d16) > 0.995
    assert np.mean(np.abs(d32 - d16) > 2) < 0.002
    np.testing.assert_allclose(o16["bestc"].numpy(), o32["bestc"].numpy(),
                               rtol=1e-2, atol=1e-2)


def test_wrapper_on_cpu_is_the_plain_version():
    cfg = port(SYM.replace(window_radius=3))
    pair = synthetic.make_pair(height=20, width=36, max_disparity=8, seed=2)
    l, r = torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"])
    before = asw_sep_kernel.launches
    got = asw_sep_kernel.wta_outputs(l, r, cfg)
    assert asw_sep_kernel.launches == before  # no kernel launch for CPU tensors
    ref = asw_sep_kernel.wta_outputs_reference(l, r, cfg)
    assert sorted(got) == sorted(ref) == ["bestc", "bestd", "cm", "cp", "rbestd", "ubest"]
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def test_kernel_rejects_unsupported():
    z = torch.zeros((8, 8, 3))
    for cfg in (port(SYM.replace(max_disparity=256)), port(SYM.replace(window_radius=33)),
                port(SYM.replace(asw_separable=False))):
        for fn in (asw_sep_kernel.wta_outputs, asw_sep_kernel.wta_outputs_reference):
            with pytest.raises(ValueError, match="separable"):
                fn(z, z, cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        asw_sep_kernel.wta_outputs_from_stacks(torch.zeros(7, 8, 12, device="meta"),
                                               torch.zeros(7, 8, 19, device="meta"),
                                               port(SYM))


@pytest.mark.parametrize("D", [1, 2, 8, 128, 129, 256])
@pytest.mark.parametrize("r", [0, 2, 16, 32, 33])
def test_supports_matches_reference(D, r):
    for sym in (True, False):
        ref_cfg = SEP.replace(asw_symmetric=sym, max_disparity=D, window_radius=r)
        assert asw_sep_kernel.supports(port(ref_cfg)) == ref_kernel.supports(ref_cfg)


def test_routing_rules():
    """test_pallas_dlanes.py:382-405 on asw_sep_kernel.routed."""
    for cfg in (SEP, SYM, SEP.replace(kernel_layout="dlanes"),
                SYM.replace(kernel_layout="dlanes")):
        assert asw_sep_kernel.routed(port(cfg))
    # auto + unsupported geometry falls to the eager path instead of raising
    assert not asw_sep_kernel.routed(port(SEP.replace(max_disparity=256)))
    # the exact kernel refuses separable configs
    assert not asw_kernel.supports(port(SEP))
    assert not asw_kernel.supports(port(SYM))
    # xlanes pin -> the eager path serves separable
    assert not asw_sep_kernel.routed(port(SEP.replace(kernel_layout="xlanes")))
    # unsupported geometry under an explicit dlanes pin raises
    with pytest.raises(ValueError, match="separable|dlanes"):
        asw_sep_kernel.routed(port(SEP.replace(kernel_layout="dlanes", max_disparity=256)))
    # non-separable configs never land here
    assert not asw_sep_kernel.routed(port(SEP.replace(asw_separable=False)))
    for cfg in (SEP, SYM, SEP.replace(max_disparity=256),
                SEP.replace(kernel_layout="xlanes"), SEP.replace(asw_separable=False)):
        assert asw_sep_kernel.routed(port(cfg)) == ref_kernel.routed(cfg)


def test_exact_kernel_refuses_separable_stacks():
    """A separable config fed to the exact kernel's entry points raises,
    never silently computing the exact window
    (test_pallas_dlanes.py:459-470)."""
    cfg = port(SYM)
    ls, rs = torch.zeros(7, 16, 36), torch.zeros(7, 16, 43)
    with pytest.raises(ValueError, match="separable"):
        asw_kernel.wta_outputs_from_stacks(ls, rs, cfg)
    with pytest.raises(ValueError, match="separable"):
        asw_kernel.wta_outputs(torch.zeros(16, 32, 3), torch.zeros(16, 32, 3), cfg)
