"""The port's separable path end to end on the CPU: match_pair against the
reference's jnp pipeline and loop oracle, the separable-vs-exact accuracy
contract, backend resolution, the bf16 warning and the make_hard_pair copy.

Bars: winners within 0.51 px on more than 99.5% of pixels and |delta| > 2
on fewer than 0.2% (tests/test_oracle_parity.py:140-143); the accuracy
contract of tests/test_accuracy_regression.py:143-180 (SEP_CONTRACT).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import oracle_numpy as oracle
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

import aswstereomatch_torch as asm
from aswstereomatch_torch.config import SEP_CONTRACT
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops.cuda import asw_kernel, asw_sep_kernel
from aswstereomatch_torch.utils import convert, evaluate, synthetic

# test_oracle_parity.py:128's asw_separable pipeline config
CFG_SEP = RefConfig(max_disparity=12, cost="tad_grad", aggregation="asw", window_radius=4,
                    gamma_color=14.0, gamma_spatial=9.0, asw_separable=True)
# test_accuracy_regression.py's CFG
CFG_ACC = RefConfig(max_disparity=24, cost="tad_grad", aggregation="asw", window_radius=8,
                    lr_check=True, fill_holes=True, subpixel=True, median_filter=True)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def assert_agree(d_t, d_ref):
    diff = np.abs(d_t - d_ref)
    agree = np.mean(diff <= 0.51)
    assert agree > 0.995, f"disagreement {1 - agree:.4%}"
    bad2 = np.mean(diff > 2.0)
    assert bad2 < 0.002, f"bad-2.0 {bad2:.4%}"


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "left_only"])
def test_eager_separable_pipeline_matches_jnp(small_pair, symmetric):
    ref_cfg = CFG_SEP.replace(asw_symmetric=symmetric)
    left, right = small_pair["left"], small_pair["right"]
    d_j = np.asarray(J(ref_pipeline.match_pair, cfg=ref_cfg.replace(backend="jnp"))(
        jnp.asarray(left), jnp.asarray(right)))
    d_t = pipeline.match_pair(T(left), T(right), port(ref_cfg)).numpy()
    assert d_t.dtype == np.float32 and d_t.shape == left.shape[:2]
    assert_agree(d_t, d_j)


def test_eager_separable_pipeline_matches_oracle(small_pair):
    left, right = small_pair["left"], small_pair["right"]
    d_o = oracle.match_pair(left, right, CFG_SEP)
    d_t = pipeline.match_pair(T(left), T(right), port(CFG_SEP)).numpy()
    assert_agree(d_t, d_o)


def test_kernel_route_postprocess_equals_eager(small_pair):
    """The kernel route's post-processing from the separable wrapper's seven
    planes (its plain version on the CPU) equals the eager route."""
    cfg = port(CFG_SEP)
    l, r = T(small_pair["left"]), T(small_pair["right"])
    outs = asw_sep_kernel.wta_outputs(l, r, cfg)
    d_wta = pipeline.disparity(outs, cfg, pipeline.guide_lab(l, cfg)).numpy()
    np.testing.assert_array_equal(d_wta, pipeline.match_pair(l, r, cfg).numpy())


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "leftonly"])
def test_separable_tracks_exact(symmetric):
    """One seed of test_accuracy_regression.py:141-180 on the port's eager
    path: (1) smooth scene, raw delta <= 1%; (2) hard scene, delta on the
    pixels exact gets right <= 1%; (3) hard scene, GT bad-2.0 cost <= 0.3pp."""
    cfg_e = port(CFG_ACC.replace(asw_symmetric=symmetric))
    cfg_s = cfg_e.replace(asw_separable=True)

    def run(cfg, pair):
        return pipeline.match_pair(T(pair["left"]), T(pair["right"]), cfg).numpy()

    pair = synthetic.make_pair(height=96, width=160, max_disparity=24, seed=0)
    raw = evaluate.bad_delta_between(run(cfg_s, pair), run(cfg_e, pair), 2.0,
                                     ~pair["occluded"])
    assert raw <= SEP_CONTRACT["delta_bad2_max"], f"smooth delta {raw:.4%}"
    pair = synthetic.make_hard_pair(96, 160, 24, seed=0)
    nonocc = ~pair["occluded"]
    de, ds = run(cfg_e, pair), run(cfg_s, pair)
    restr = evaluate.bad_delta_between(ds, de, 2.0, nonocc & (np.abs(de - pair["gt"]) <= 2.0))
    assert restr <= SEP_CONTRACT["delta_bad2_max"], f"exact-correct delta {restr:.4%}"
    cost = (evaluate.bad_delta(ds, pair["gt"], 2.0, nonocc)
            - evaluate.bad_delta(de, pair["gt"], 2.0, nonocc))
    assert cost <= SEP_CONTRACT["gt_bad2_cost_max"], f"GT cost {cost * 100:.3f}pp"


@pytest.mark.parametrize("seed", [0, 3])
def test_make_hard_pair_byte_equal_reference(seed):
    kw = dict(height=37, width=61, max_disparity=12, seed=seed)
    ref = ref_synthetic.make_hard_pair(**kw)
    got = synthetic.make_hard_pair(**kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].tobytes() == ref[k].tobytes(), k


def test_resolve_backend_separable():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for name in ("kitti_sep", "kitti_seplo"):
        cfg = asm.get_preset(name)
        assert pipeline._resolve_backend(cfg, cuda) == "cuda"
        assert pipeline._resolve_backend(cfg, cpu) == "eager"
        assert pipeline._resolve_backend(cfg.replace(kernel_layout="dlanes"), cuda) == "cuda"
        assert pipeline._resolve_backend(cfg.replace(backend="cuda"), cuda) == "cuda"
        # no kernel for these: the eager path serves them
        assert pipeline._resolve_backend(cfg.replace(kernel_layout="xlanes"), cuda) == "eager"
        assert pipeline._resolve_backend(cfg.replace(max_disparity=256), cuda) == "eager"
        with pytest.raises(ValueError, match="no kernel"):
            pipeline._resolve_backend(cfg.replace(backend="cuda", max_disparity=256), cuda)
        with pytest.raises(ValueError, match="no kernel"):
            pipeline._resolve_backend(cfg.replace(backend="cuda", kernel_layout="xlanes"),
                                      cuda)
        for device in (cuda, cpu):  # the reference checks this on every platform
            with pytest.raises(ValueError, match="dlanes"):
                pipeline._resolve_backend(
                    cfg.replace(kernel_layout="dlanes", max_disparity=256), device)


def test_kernel_wta_never_computes_separable_with_the_exact_kernel(small_pair):
    l, r = T(small_pair["left"]), T(small_pair["right"])
    cfg = port(CFG_SEP)
    before = (asw_kernel.launches, asw_sep_kernel.launches)
    outs = pipeline._kernel_wta(l, r, cfg)
    assert (asw_kernel.launches, asw_sep_kernel.launches) == before  # CPU: plain
    ref = asw_sep_kernel.wta_outputs_reference(l, r, cfg)
    for k in ref:
        torch.testing.assert_close(outs[k], ref[k], rtol=0, atol=0)
    for bad in (cfg.replace(max_disparity=256), cfg.replace(kernel_layout="xlanes")):
        with pytest.raises(ValueError, match="separable"):
            pipeline._kernel_wta(l, r, bad)


def test_bf16_warning_on_the_eager_path(small_pair):
    cfg = port(CFG_SEP.replace(volume_dtype="bfloat16"))
    with pytest.warns(UserWarning, match="float32"):
        assert pipeline._resolve_backend(cfg, torch.device("cpu")) == "eager"
    with pytest.warns(UserWarning, match="float32"):
        assert pipeline._resolve_backend(cfg.replace(backend="eager"),
                                         torch.device("cuda")) == "eager"
    # the kernel route stores bf16 and does not warn
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pipeline._resolve_backend(cfg, torch.device("cuda")) == "cuda"
    # the eager path computes in float32: the same map as the float32 config
    l, r = T(small_pair["left"]), T(small_pair["right"])
    with pytest.warns(UserWarning, match="float32"):
        d16 = pipeline.match_pair(l, r, cfg)
    torch.testing.assert_close(d16, pipeline.match_pair(l, r, port(CFG_SEP)), rtol=0, atol=0)
