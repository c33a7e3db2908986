"""The port's end-to-end pipeline and StereoMatcher on the CPU, against the
reference's loop oracle and its jnp / Pallas (interpret-mode) pipelines.

Bar (tests/test_oracle_parity.py:141-143): winners within 0.51 px on more
than 99.5% of pixels and |delta| > 2 on fewer than 0.2%.
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
from aswstereomatch_tpu.utils import synthetic

import aswstereomatch_torch as asm
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops import aggregate, wta
from aswstereomatch_torch.ops.cuda import asw_kernel
from aswstereomatch_torch.utils import convert

CFG_AD = RefConfig(max_disparity=12, cost="ad", aggregation="box", window_radius=3,
                   lr_check=False, fill_holes=False, subpixel=False, median_filter=False)
CFG_TAD = RefConfig(max_disparity=12, cost="tad_grad", aggregation="asw",
                    window_radius=4, gamma_color=14.0, gamma_spatial=9.0)
# test_oracle_parity.py's pipeline configs, minus the separable mode
# (tests/test_torch_sep_pipeline.py)
PIPELINE_CFGS = [
    CFG_AD,
    CFG_TAD,
    CFG_TAD.replace(lr_check=False, fill_holes=False),
    CFG_TAD.replace(subpixel=False, median_filter=False),
    CFG_TAD.replace(aggregation="none"),
]
PIPELINE_IDS = ["ad_box", "asw_full", "asw_nopost", "asw_nosubpix", "none_agg"]


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_agree(d_t, d_ref, bar=0.995, gross=0.002):
    diff = np.abs(d_t - d_ref)
    agree = np.mean(diff <= 0.51)
    assert agree > bar, f"disagreement {1 - agree:.4%}"
    bad2 = np.mean(diff > 2.0)
    assert bad2 < gross, f"bad-2.0 {bad2:.4%}"


@pytest.fixture(scope="module")
def oracle_pair():
    """Small enough for the 5-loop oracle at r=4, D=12."""
    return synthetic.make_pair(height=18, width=30, max_disparity=12, seed=3)


@pytest.mark.parametrize("ref_cfg", PIPELINE_CFGS, ids=PIPELINE_IDS)
def test_eager_pipeline_matches_oracle(oracle_pair, ref_cfg):
    left, right = oracle_pair["left"], oracle_pair["right"]
    d_o = oracle.match_pair(left, right, ref_cfg)
    d_t = pipeline.match_pair(T(left), T(right), port(ref_cfg)).numpy()
    assert d_t.dtype == np.float32 and d_t.shape == left.shape[:2]
    assert_agree(d_t, d_o)


@pytest.mark.parametrize(
    "ref_cfg",
    PIPELINE_CFGS + [CFG_TAD.replace(median_mode="weighted"),
                     CFG_TAD.replace(uniqueness_ratio=8.0),
                     CFG_TAD.replace(uniqueness_ratio=8.0, fill_holes=False),
                     CFG_TAD.replace(asw_symmetric=False)],
    ids=PIPELINE_IDS + ["weighted_median", "uniqueness", "uniqueness_nofill", "left_only"],
)
def test_eager_pipeline_matches_jnp(small_pair, ref_cfg):
    left, right = small_pair["left"], small_pair["right"]
    d_j = np.asarray(J(ref_pipeline.match_pair, cfg=ref_cfg.replace(backend="jnp"))(
        jnp.asarray(left), jnp.asarray(right)))
    d_t = pipeline.match_pair(T(left), T(right), port(ref_cfg)).numpy()
    assert_agree(d_t, d_j)


@pytest.mark.parametrize(
    "ref_cfg",
    [CFG_TAD.replace(max_disparity=8, window_radius=2),
     CFG_TAD.replace(max_disparity=8, window_radius=2, uniqueness_ratio=8.0),
     CFG_AD.replace(max_disparity=8, lr_check=True, fill_holes=True, subpixel=True,
                    median_filter=True)],
    ids=["asw", "asw_uniqueness", "box"],
)
def test_kernel_route_postprocess_matches_pallas_pipeline(ref_cfg):
    """The kernel route's post-processing (from the seven WTA planes), fed
    by the plain version on the CPU: equal to the eager route, and in
    agreement with the reference's Pallas pipeline (interpret mode)."""
    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=5)
    l, r = T(pair["left"]), T(pair["right"])
    cfg = port(ref_cfg)
    outs = asw_kernel.wta_outputs_reference(l, r, cfg)
    d_wta = pipeline.disparity(outs, cfg, pipeline.guide_lab(l, cfg)).numpy()
    d_eager = pipeline.match_pair(l, r, cfg).numpy()
    np.testing.assert_array_equal(d_wta, d_eager)
    d_pal = np.asarray(J(ref_pipeline.match_pair, cfg=ref_cfg.replace(backend="pallas"))(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    assert_agree(d_wta, d_pal, bar=0.99, gross=0.005)


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpix", "int"])
@pytest.mark.parametrize("uniqueness_ratio", [0.0, 15.0], ids=["u0", "u15"])
@pytest.mark.parametrize("lr_check", [True, False], ids=["lr", "nolr"])
@pytest.mark.parametrize("aggregation", ["asw", "box", "sgm", "none"])
def test_eager_planes_equal_the_kernels_plain_six(aggregation, lr_check, uniqueness_ratio,
                                                  subpixel):
    """The eager route's planes for a config are, plane for plane and bit
    for bit, the full six the kernels' plain versions build (asw_kernel's
    over the stacks for asw and box, ``wta.planes`` of the volume for the
    aggregations no kernel serves); ``rbestd`` is there iff the LR check
    reads it and ``ubest`` iff the uniqueness gate does."""
    pair = synthetic.make_pair(height=16, width=32, max_disparity=8, seed=5)
    l, r = T(pair["left"]), T(pair["right"])
    cfg = port(CFG_TAD.replace(max_disparity=8, window_radius=2, aggregation=aggregation,
                               lr_check=lr_check, uniqueness_ratio=uniqueness_ratio,
                               subpixel=subpixel))
    got = pipeline._planes(l, r, cfg, "eager")
    if aggregation in ("asw", "box"):
        six = asw_kernel.wta_outputs_reference(l, r, cfg)
    else:
        six = wta.planes(aggregate.aggregated_volume(l, r, cfg))
    want = {"bestd", "bestc", "cm", "cp"}
    want |= {"rbestd"} if lr_check else set()
    want |= {"ubest"} if uniqueness_ratio > 0 else set()
    assert set(got) == want and set(six) == set(asw_kernel.PLANES)
    for k in want:
        assert got[k].dtype == six[k].dtype and torch.equal(got[k], six[k]), k


def test_resolve_backend():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = asm.get_preset("middlebury_asw_full")
    assert pipeline._resolve_backend(cfg, cpu) == "eager"
    assert pipeline._resolve_backend(cfg, cuda) == "cuda"
    for overrides in (dict(asw_symmetric=False), dict(aggregation="box"),
                      dict(kernel_layout="dlanes")):
        assert pipeline._resolve_backend(cfg.replace(**overrides), cuda) == "cuda"
    # the separable presets have their own kernel (tests/test_torch_sep_pipeline.py)
    for name in ("kitti_sep", "kitti_seplo"):
        assert pipeline._resolve_backend(asm.get_preset(name), cuda) == "cuda"
    assert pipeline._resolve_backend(asm.get_preset("kitti_sgm"), cuda) == "eager"
    assert pipeline._resolve_backend(cfg.replace(aggregation="none"), cuda) == "eager"
    assert pipeline._resolve_backend(cfg.replace(backend="eager"), cuda) == "eager"
    with pytest.raises(ValueError, match="CUDA device"):
        pipeline._resolve_backend(cfg.replace(backend="cuda"), cpu)
    with pytest.raises(ValueError, match="no kernel"):
        pipeline._resolve_backend(asm.get_preset("kitti_sgm").replace(backend="cuda"), cuda)


def test_cuda_backend_on_cpu_tensor_raises(small_pair):
    cfg = port(CFG_TAD).replace(backend="cuda")
    l, r = T(small_pair["left"]), T(small_pair["right"])
    with pytest.raises(ValueError, match="CUDA device"):
        pipeline.match_pair(l, r, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        asm.StereoMatcher(cfg, device="cpu")(small_pair["left"], small_pair["right"])


def test_matcher_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        asm.StereoMatcher(asm.get_preset("middlebury_asw_full"))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        asm.StereoMatcher.from_preset("middlebury_asw_full")


def test_matcher_uint8_equals_float_and_batch_equals_singles():
    m = asm.StereoMatcher(port(CFG_TAD.replace(max_disparity=8, window_radius=2)),
                          device="cpu")
    pairs = [synthetic.make_pair(height=20, width=32, max_disparity=8, seed=s)
             for s in (1, 2)]
    singles = []
    for p in pairs:
        d_f = m(p["left"], p["right"])
        d_u = m(p["left"].astype(np.uint8), p["right"].astype(np.uint8))
        d_t = m(T(p["left"]), T(p["right"]))
        assert d_f.dtype == torch.float32 and d_f.device.type == "cpu"
        torch.testing.assert_close(d_u, d_f, rtol=0, atol=0)
        torch.testing.assert_close(d_t, d_f, rtol=0, atol=0)
        singles.append(d_f)
    lefts = np.stack([p["left"].astype(np.uint8) for p in pairs])
    rights = np.stack([p["right"].astype(np.uint8) for p in pairs])
    out = m.batch(lefts, rights)
    assert out.shape == (2, 20, 32)
    for i in range(2):
        torch.testing.assert_close(out[i], singles[i], rtol=0, atol=0)
    torch.testing.assert_close(pipeline.match_batch(T(lefts), T(rights), m.cfg), out,
                               rtol=0, atol=0)


def test_matcher_batch_of_zero_pairs():
    """A batch of no pairs gives an empty (0, H, W) float32 map, the shape
    the reference's match_batch returns for the same inputs."""
    cfg = CFG_TAD.replace(max_disparity=8, window_radius=2)
    z = np.zeros((0, 24, 40, 3), np.uint8)
    out = asm.StereoMatcher(port(cfg), device="cpu").batch(z, z)
    ref = np.asarray(J(ref_pipeline.match_batch, cfg=cfg)(jnp.asarray(z, jnp.float32),
                                                          jnp.asarray(z, jnp.float32)))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    assert tuple(out.shape) == ref.shape == (0, 24, 40)
    assert ref.dtype == np.float32


def test_matcher_validates_shapes():
    m = asm.StereoMatcher.from_preset("tsukuba_ad_box", device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        m(np.zeros((8, 8, 3)), np.zeros((8, 9, 3)))
    with pytest.raises(ValueError, match="expected"):
        m(np.zeros(8), np.zeros(8))
    with pytest.raises(ValueError, match="expected"):
        m.batch(np.zeros((8, 8)), np.zeros((8, 8)))


def test_preset_matcher_on_cpu_matches_jnp():
    """A BASELINE preset end to end through the public entry (grayscale
    inputs included), against the reference's jnp pipeline."""
    pair = synthetic.make_pair(height=32, width=48, max_disparity=16, seed=8)
    m = asm.StereoMatcher.from_preset("tsukuba_ad_box", device="cpu")
    ref_cfg = RefConfig(**{**dataclasses.asdict(m.cfg), "backend": "jnp"})
    for l, r in ((pair["left"], pair["right"]),
                 (pair["left"][..., 1], pair["right"][..., 1])):
        d_t = m(l, r).numpy()
        d_j = np.asarray(J(ref_pipeline.match_pair, cfg=ref_cfg)(jnp.asarray(l), jnp.asarray(r)))
        assert_agree(d_t, d_j)


def test_profiling_busy_time_is_the_union_of_device_intervals():
    from aswstereomatch_torch.utils import profiling

    spans = [(10, 12, "c"), (0, 5, "a"), (3, 8, "b"), (12, 13, "d")]
    assert profiling._union_us(spans) == 11.0
    assert profiling._union_us([]) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            profiling.main(["--geometry", "middlebury"])
