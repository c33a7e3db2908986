"""Stage-by-stage parity of the port's plain PyTorch stages (on the CPU)
with the reference's NumPy path, loop oracle and jnp stages.

Bars are the reference's own (tests/test_oracle_parity.py): colorspace and
preprocess bit-exact against NumPy; cost rtol 1e-5 / atol 1e-3; box
aggregation rtol 1e-5 / atol 1e-3; ASW rtol 2e-4 / atol 2e-3; WTA exact;
subpixel 1e-5 / 1e-4; right volume 1e-6 / 1e-5; LR mask exact; fill and
median 1e-6; weighted median > 99.5% identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import oracle_numpy as oracle
from aswstereomatch_tpu.ops import aggregate as ref_aggregate
from aswstereomatch_tpu.ops import wta as ref_wta
from aswstereomatch_tpu.utils import colorspace as ref_cs
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.ops import aggregate, cost, postprocess, preprocess, wta
from aswstereomatch_torch.utils import colorspace, convert

CFG_AD = RefConfig(max_disparity=12, cost="ad", aggregation="box", window_radius=3,
                   lr_check=False, fill_holes=False, subpixel=False, median_filter=False)
CFG_TAD = RefConfig(max_disparity=12, cost="tad_grad", aggregation="asw",
                    window_radius=4, gamma_color=14.0, gamma_spatial=9.0)


def port(ref_cfg):
    import dataclasses

    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


@pytest.fixture(scope="module")
def tiny_pair():
    """Pair small enough for the literal 5-loop ASW oracle."""
    return ref_synthetic.make_pair(height=12, width=20, max_disparity=8, seed=4)


# ---- colorspace / preprocess: bit-exact vs NumPy ---------------------------

def test_colorspace_bit_exact(small_pair):
    img = small_pair["left"]
    np.testing.assert_array_equal(
        colorspace.rgb_to_gray(T(img)).numpy(), ref_cs.rgb_to_gray(img, np))
    np.testing.assert_array_equal(
        colorspace.srgb_decode(T(img)).numpy(), ref_cs.srgb_decode(img, np))
    np.testing.assert_array_equal(
        colorspace.rgb_to_lab(T(img)).numpy(), ref_cs.rgb_to_lab(img, np))
    # every 8-bit grey level and random colors, half-integers included
    rng = np.random.default_rng(0)
    rgb = np.concatenate([
        np.repeat(np.arange(256, dtype=np.float32)[:, None], 3, 1),
        rng.integers(0, 256, (500, 3)).astype(np.float32),
        rng.integers(0, 255, (100, 3)).astype(np.float32) + 0.5,
    ])
    np.testing.assert_array_equal(
        colorspace.rgb_to_lab(T(rgb)).numpy(), ref_cs.rgb_to_lab(rgb, np))


def test_cbrt_and_lab_f_bit_exact():
    rng = np.random.default_rng(1)
    t = np.concatenate([
        np.zeros(3, np.float32), rng.uniform(0, 1.2, 2000).astype(np.float32),
        np.float32([1e-6, 0.008856, 0.00885645, 1.0]),
    ])
    np.testing.assert_array_equal(
        colorspace.cbrt_newton(T(t)).numpy(), ref_cs.cbrt_newton(t, np))
    np.testing.assert_array_equal(colorspace._lab_f(T(t)).numpy(), ref_cs._lab_f(t, np))


def test_gradient_and_channel_stack_bit_exact(small_pair):
    img = small_pair["left"]
    gray_o, grad_o = oracle.gray_and_grad(img)
    np.testing.assert_array_equal(preprocess.rgb_to_gray(T(img)).numpy(), gray_o)
    np.testing.assert_array_equal(
        preprocess.x_gradient(preprocess.rgb_to_gray(T(img))).numpy(), grad_o)
    stack = preprocess.channel_stack(T(img)).numpy()
    assert stack.shape == (7,) + img.shape[:2]
    np.testing.assert_array_equal(stack[0:3], np.moveaxis(img, -1, 0))
    np.testing.assert_array_equal(stack[3], grad_o)
    np.testing.assert_array_equal(stack[4:7], np.moveaxis(ref_cs.rgb_to_lab(img, np), -1, 0))
    # grayscale input: three equal channels
    g = gray_o
    stack_g = preprocess.channel_stack(T(g)).numpy()
    np.testing.assert_array_equal(stack_g[0:3], np.stack([g] * 3))
    np.testing.assert_array_equal(stack_g[3], oracle.gray_and_grad(g)[1])


# ---- cost ------------------------------------------------------------------

@pytest.mark.parametrize("ref_cfg", [CFG_AD, CFG_TAD], ids=["ad", "tad_grad"])
@pytest.mark.parametrize("x_extend", [0, 3])
def test_cost_volume_matches_oracle(small_pair, ref_cfg, x_extend):
    left, right = small_pair["left"], small_pair["right"]
    v_o = oracle.cost_volume_ext(left, right, ref_cfg, x_extend)
    v_t = cost.cost_volume(T(left), T(right), port(ref_cfg), x_extend=x_extend).numpy()
    np.testing.assert_allclose(v_t, v_o, rtol=1e-5, atol=1e-3)


def test_cost_from_stacks_equals_cost_from_images(small_pair):
    cfg = port(CFG_TAD)
    r, D = cfg.window_radius, cfg.max_disparity
    l, rr = T(small_pair["left"]), T(small_pair["right"])
    ls = preprocess.pad_edge(preprocess.channel_stack(l), 2, r, r)
    rs = preprocess.pad_edge(preprocess.channel_stack(rr), 2, r + D - 1, r)
    v_s = aggregate.cost_volume_from_stacks(ls, rs, cfg)
    v_i = cost.cost_volume(l, rr, cfg, x_extend=r)
    torch.testing.assert_close(v_s, v_i, rtol=0, atol=0)


# ---- aggregation ------------------------------------------------------------

def test_box_aggregation_matches_oracle(small_pair):
    v = oracle.cost_volume_ext(small_pair["left"], small_pair["right"], CFG_AD,
                               CFG_AD.window_radius)
    a_o = oracle.aggregate_box(v, CFG_AD)
    a_t = aggregate.aggregate_box(T(v), port(CFG_AD)).numpy()
    np.testing.assert_allclose(a_t, a_o, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "left_only"])
def test_asw_aggregation_matches_oracle(tiny_pair, symmetric):
    ref_cfg = RefConfig(max_disparity=8, window_radius=3, gamma_spatial=9.0,
                        asw_symmetric=symmetric)
    left, right = tiny_pair["left"], tiny_pair["right"]
    v = oracle.cost_volume_ext(left, right, ref_cfg, ref_cfg.window_radius)
    a_o = oracle.aggregate_asw(v, left, right, ref_cfg)
    a_t = aggregate.aggregate_asw(T(left), T(right), port(ref_cfg)).numpy()
    np.testing.assert_allclose(a_t, a_o, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "left_only"])
def test_asw_aggregation_matches_jnp(small_pair, symmetric):
    ref_cfg = CFG_TAD.replace(asw_symmetric=symmetric)
    left, right = small_pair["left"], small_pair["right"]
    a_j = np.asarray(J(ref_aggregate.aggregate_asw, cfg=ref_cfg)(
        jnp.asarray(left), jnp.asarray(right)))
    a_t = aggregate.aggregate_asw(T(left), T(right), port(ref_cfg)).numpy()
    np.testing.assert_allclose(a_t, a_j, rtol=2e-4, atol=2e-3)


def test_bilateral_planes_match_jnp(small_pair):
    cfg = CFG_TAD
    r = cfg.window_radius
    lab = np.pad(ref_cs.rgb_to_lab(small_pair["left"], np), ((0, 0), (r, r), (0, 0)),
                 mode="edge")
    w_j = np.asarray(J(ref_aggregate.bilateral_planes_from_lab, cfg=cfg)(jnp.asarray(lab)))
    w_t = aggregate.bilateral_planes_from_lab(T(lab), port(cfg)).numpy()
    assert w_t.shape == w_j.shape == small_pair["left"].shape[:2] + (cfg.window_size**2,)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5, atol=1e-6)


def test_not_ported_aggregations_raise(tiny_pair):
    """Every aggregation is ported now (SGM raised here until it was): SGM's
    volume is the semi-global aggregation of the raw cost volume, as the
    reference composes it (tests/test_torch_sgm.py holds it to the
    reference bit for bit)."""
    l, r = T(tiny_pair["left"]), T(tiny_pair["right"])
    cfg_sgm = port(CFG_TAD.replace(aggregation="sgm"))
    vol_sgm = aggregate.aggregated_volume(l, r, cfg_sgm)
    assert torch.equal(vol_sgm, aggregate.aggregate_sgm(cost.cost_volume(l, r, cfg_sgm), cfg_sgm))
    assert vol_sgm.shape == tiny_pair["left"].shape[:2] + (cfg_sgm.max_disparity,)
    # separable ASW is ported: the volume of its own function
    # (tests/test_torch_sep_aggregate.py holds it to the reference)
    cfg = port(CFG_TAD.replace(asw_separable=True))
    vol = aggregate.aggregated_volume(l, r, cfg)
    assert vol.shape == tiny_pair["left"].shape[:2] + (cfg.max_disparity,)
    assert torch.isfinite(vol).all()
    exact = aggregate.aggregated_volume(l, r, cfg.replace(asw_separable=False))
    assert not torch.equal(vol, exact)


# ---- WTA ---------------------------------------------------------------------

def test_wta_subpixel_match_oracle(small_pair):
    v = oracle.cost_volume(small_pair["left"], small_pair["right"], CFG_TAD)
    d_o = oracle.wta(v)
    d_t = wta.wta(T(v))
    assert d_t.dtype == torch.int32
    np.testing.assert_array_equal(d_t.numpy(), d_o)
    s_o = oracle.subpixel(v, d_o)
    trip = wta.wta_with_triple(T(v))
    s_t = wta.subpixel_from_triple(trip["bestd"], trip["bestc"], trip["cm"], trip["cp"],
                                   v.shape[-1])
    np.testing.assert_allclose(s_t.numpy(), s_o, rtol=1e-5, atol=1e-4)


def test_wta_triple_second_best_and_gate_match_jnp(small_pair):
    v = oracle.cost_volume(small_pair["left"], small_pair["right"], CFG_TAD)
    v[3, 5, :] = 1.0  # an all-tie pixel: first occurrence must win
    trip_j = J(ref_wta.wta_with_triple)(jnp.asarray(v))
    trip_t = wta.wta_with_triple(T(v))
    for k in ("bestd", "bestc", "cm", "cp"):
        np.testing.assert_array_equal(trip_t[k].numpy(), np.asarray(trip_j[k]), err_msg=k)
    d = trip_t["bestd"]
    sub_j = J(ref_wta.subpixel_from_triple, max_disparity=12)(
        *(jnp.asarray(trip_j[k]) for k in ("bestd", "bestc", "cm", "cp")))
    sub_t = wta.subpixel_from_triple(d, trip_t["bestc"], trip_t["cm"], trip_t["cp"], 12)
    np.testing.assert_allclose(sub_t.numpy(), np.asarray(sub_j), rtol=1e-5, atol=1e-4)
    for vol in (v, v[..., :3]):  # D <= 3: no far candidate, +inf
        dd = wta.wta(T(vol))
        sec_j = np.asarray(J(ref_wta.second_best_excl_neighbors)(
            jnp.asarray(vol), jnp.asarray(dd.numpy())))
        sec_t = wta.second_best_excl_neighbors(T(vol), dd).numpy()
        np.testing.assert_array_equal(sec_t, sec_j)
    best = trip_t["bestc"]
    second = wta.second_best_excl_neighbors(T(v), d)
    for ratio in (0.0, 5.0, 15.0):
        uv_j = np.asarray(ref_wta.uniqueness_valid(
            jnp.asarray(best.numpy()), jnp.asarray(second.numpy()), ratio))
        np.testing.assert_array_equal(wta.uniqueness_valid(best, second, ratio).numpy(), uv_j)


# ---- post-processing ----------------------------------------------------------

def test_right_volume_and_lr_match_oracle(small_pair):
    cfg = CFG_TAD
    v = oracle.cost_volume(small_pair["left"], small_pair["right"], cfg)
    vr_o = oracle.right_volume(v)
    vr_t = postprocess.right_volume(T(v)).numpy()
    np.testing.assert_allclose(vr_t, vr_o, rtol=1e-6, atol=1e-5)
    dl = oracle.wta(v).astype(np.float32)
    dr = oracle.wta(vr_o).astype(np.float32)
    m_o = oracle.lr_check(dl, dr, cfg)
    m_t = postprocess.lr_check(T(dl), T(dr), port(cfg)).numpy()
    np.testing.assert_array_equal(m_t, m_o)
    # subpixel / out-of-range disparities, half-way rounding included
    rng = np.random.default_rng(2)
    dl2 = np.round(rng.uniform(-2, 15, dl.shape) * 2) / 2
    dl2 = dl2.astype(np.float32)
    np.testing.assert_array_equal(
        postprocess.lr_check(T(dl2), T(dr), port(cfg)).numpy(),
        oracle.lr_check(dl2, dr, cfg))


def test_fill_and_median_match_oracle():
    rng = np.random.default_rng(0)
    disp = rng.uniform(0, 12, size=(17, 23)).astype(np.float32)
    valid = rng.random((17, 23)) > 0.35
    valid[3] = False  # a fully-invalid row exercises the 0-fill path
    valid[5, :4] = False
    valid[6, -4:] = False
    f_o = oracle.fill_holes(disp, valid)
    f_t = postprocess.fill_holes(T(disp), T(valid)).numpy()
    np.testing.assert_allclose(f_t, f_o, rtol=1e-6, atol=1e-6)
    m_o = oracle.median3(f_o)
    np.testing.assert_allclose(postprocess.median3(T(f_o)).numpy(), m_o, rtol=1e-6, atol=1e-6)


def test_weighted_median_matches_oracle(small_pair):
    cfg = CFG_TAD.replace(median_mode="weighted")
    rng = np.random.default_rng(4)
    disp = (np.round(rng.uniform(0, 12, (19, 21)) * 2) / 2).astype(np.float32)
    left = small_pair["left"][:19, :21]
    w_o = oracle.weighted_median3(disp, left, cfg)
    guide = preprocess.rgb_to_lab(T(left))
    w_t = postprocess.median_filter(T(disp), port(cfg), guide).numpy()
    assert (w_t == w_o).mean() > 0.995  # f32-vs-f64 cumsum can flip rare ties
    with pytest.raises(ValueError, match="Lab guide"):
        postprocess.median_filter(T(disp), port(cfg))
