"""The port's confidence surface, ``match_pair_with_confidence`` -> (disp,
uniq_pct, lr_valid), on the CPU.

Against the reference's ``match_pair_with_confidence`` on its jnp path for
every aggregation, LR on and off; its kernel branch (fed by the kernels'
plain versions on the CPU) against the port's eager branch and the
reference's Pallas branch (interpret mode); and the port's counterparts of
tests/test_uniqueness.py:147-198 (gate reproduction, the zero-cost rule,
the y_chunks refusal).

Tolerance on ``uniq_pct`` where both are below the 1e6 sentinel and the two
winners agree: |delta| <= 1e-3 * (uniq_pct + 100), i.e. 1e-3 relative on
second / best.  The aggregated volumes agree to rtol 2e-4
(tests/test_oracle_parity.py:65), and the ratio of two such sums can
differ by twice that; 1e-3 leaves room for the order of the sums.
``lr_valid`` is a function of the two views' winners: it is held equal on
every pixel whose left winner and whose matched right winner agree with
the reference's, and those pixels must be more than 99.5% of the image
(the winner-agreement bar of tests/test_oracle_parity.py:141), since a
near-tie can fall the other way when the window sums run in another order.
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

from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops import aggregate, postprocess, wta
from aswstereomatch_torch.utils import convert, synthetic


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _cfg(**kw):
    """tests/test_uniqueness.py's config."""
    base = dict(max_disparity=16, cost="tad_grad", aggregation="asw", window_radius=3,
                lr_check=True, fill_holes=False, subpixel=True, median_filter=False,
                uniqueness_ratio=10.0)
    base.update(kw)
    return RefConfig(**base)


@pytest.fixture(scope="module")
def pair():
    return synthetic.make_pair(height=40, width=72, max_disparity=16, seed=3)


def assert_agree(d_t, d_ref, bar=0.995, gross=0.002):
    """tests/test_oracle_parity.py:141-143."""
    diff = np.abs(d_t - d_ref)
    assert np.mean(diff <= 0.51) > bar, f"disagreement {np.mean(diff > 0.51):.4%}"
    assert np.mean(diff > 2.0) < gross


def assert_margins_close(u_t, u_ref, same):
    """Equal where both are the 1e6 sentinel; elsewhere, on pixels whose
    winners agree (``same``), within the module's stated tolerance."""
    sentinel = (u_t == 1e6) & (u_ref == 1e6)
    check = same & ~sentinel
    np.testing.assert_array_less(np.abs(u_t - u_ref)[check], 1e-3 * (u_ref[check] + 100.0))
    np.testing.assert_array_equal(u_t[same & (u_ref == 1e6)], 1e6)


def _ref_confidence(left, right, ref_cfg):
    out = J(ref_pipeline.match_pair_with_confidence, cfg=ref_cfg)(
        jnp.asarray(left), jnp.asarray(right))
    return tuple(map(np.asarray, out))


def _ref_bestd(left, right, ref_cfg):
    vol = J(ref_pipeline.aggregated_volume, cfg=ref_cfg)(jnp.asarray(left), jnp.asarray(right))
    return np.asarray(vol).argmin(-1)


def _winners(vol):
    """(left winner, right-view winner) of an (H, W, D) volume."""
    vol = torch.as_tensor(vol)
    return vol.argmin(-1).numpy(), postprocess.right_volume(vol).argmin(-1).numpy()


def lr_inputs_agree(vol_t, vol_ref):
    """Pixels whose left winner and whose matched right-view winner (at
    x - d) are the same in both volumes."""
    lt, rt = _winners(vol_t)
    lref, rref = _winners(vol_ref)
    cols = np.clip(np.arange(lt.shape[1])[None, :] - lt, 0, lt.shape[1] - 1)
    same_r = np.take_along_axis(rt == rref, cols, axis=1)
    return (lt == lref) & same_r


@pytest.mark.parametrize("lr", [True, False], ids=["lr", "nolr"])
@pytest.mark.parametrize(
    "agg", [dict(), dict(aggregation="box", cost="ad"), dict(aggregation="none"),
            dict(aggregation="sgm", sgm_paths=8)],
    ids=["asw", "box", "none", "sgm"])
def test_confidence_matches_reference_jnp(pair, agg, lr):
    ref_cfg = _cfg(lr_check=lr, backend="jnp", **agg)
    cfg = port(ref_cfg)
    l, r = T(pair["left"]), T(pair["right"])
    disp, uniq, lrv = pipeline.match_pair_with_confidence(l, r, cfg)
    assert disp.dtype == torch.float32 and uniq.dtype == torch.float32
    assert lrv.dtype == torch.bool and disp.shape == uniq.shape == lrv.shape == (40, 72)
    d_ref, u_ref, lr_ref = _ref_confidence(pair["left"], pair["right"], ref_cfg)
    assert_agree(disp.numpy(), d_ref)
    vol_t = aggregate.aggregated_volume(l, r, cfg)
    vol_ref = np.array(J(ref_pipeline.aggregated_volume, cfg=ref_cfg)(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    agree = lr_inputs_agree(vol_t, vol_ref)
    assert agree.mean() > 0.995
    np.testing.assert_array_equal(lrv.numpy()[agree], lr_ref[agree])
    if not lr:
        assert lrv.all() and lr_ref.all()
    assert_margins_close(uniq.numpy(), u_ref, vol_t.argmin(-1).numpy() == vol_ref.argmin(-1))


def _kernel_route(monkeypatch):
    """Send the port's configs down the kernel branch on the CPU, where each
    kernel wrapper computes its plain version."""
    monkeypatch.setattr(pipeline, "_resolve_backend", lambda cfg, device: "cuda")


@pytest.mark.parametrize(
    "kw", [dict(), dict(lr_check=False), dict(asw_symmetric=False),
           dict(asw_separable=True), dict(aggregation="box", cost="ad")],
    ids=["asw", "asw_nolr", "left_only", "separable", "box"])
def test_kernel_branch_equals_eager_branch(pair, kw, monkeypatch):
    """The kernel branch's operands are the kernel's planes (bestc, ubest,
    bestd, rbestd); from the plain versions they equal the eager branch's,
    all three outputs bit for bit."""
    cfg = port(_cfg(**kw))
    l, r = T(pair["left"]), T(pair["right"])
    eager = pipeline.match_pair_with_confidence(l, r, cfg)
    _kernel_route(monkeypatch)
    kernel = pipeline.match_pair_with_confidence(l, r, cfg)
    for a, b in zip(kernel, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(uniqueness_ratio=0.0, fill_holes=True,
                                             median_filter=True)],
                         ids=["gates", "defaults_post"])
def test_kernel_branch_matches_reference_pallas(kw, monkeypatch):
    """tests/test_torch_pipeline.py:102-116's comparison for the confidence
    surface: the kernel branch fed by the plain version against the
    reference's Pallas branch in interpret mode (argmin bar 0.99 / 0.005)."""
    p = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=5)
    ref_cfg = _cfg(max_disparity=8, window_radius=2, **kw)
    _kernel_route(monkeypatch)
    disp, uniq, lrv = pipeline.match_pair_with_confidence(T(p["left"]), T(p["right"]),
                                                          port(ref_cfg))
    d_ref, u_ref, lr_ref = _ref_confidence(p["left"], p["right"],
                                           ref_cfg.replace(backend="pallas"))
    assert_agree(disp.numpy(), d_ref, bar=0.99, gross=0.005)
    assert float(np.mean(lrv.numpy() == lr_ref)) > 0.99
    same = (_ref_bestd(p["left"], p["right"], ref_cfg.replace(backend="jnp"))
            == aggregate.aggregated_volume(T(p["left"]), T(p["right"]),
                                          port(ref_cfg)).argmin(-1).numpy())
    assert_margins_close(uniq.numpy(), u_ref, same)


@pytest.mark.parametrize("lr", [True, False], ids=["lr", "nolr"])
@pytest.mark.parametrize("agg", [dict(), dict(aggregation="sgm", sgm_paths=8)],
                         ids=["asw", "sgm"])
def test_eager_confidence_is_one_set_of_planes(pair, agg, lr):
    """On the eager path the map is match_pair's, and the margin and the
    mask are those of one set of planes, the volume's six, bit for bit."""
    cfg = port(_cfg(lr_check=lr, **agg))
    l, r = T(pair["left"]), T(pair["right"])
    disp, uniq, lrv = pipeline.match_pair_with_confidence(l, r, cfg)
    assert torch.equal(disp, pipeline.match_pair(l, r, cfg))
    p = wta.planes(aggregate.aggregated_volume(l, r, cfg))
    pos = p["bestc"] > 0.0
    margin = torch.clamp((p["ubest"] / torch.where(pos, p["bestc"], 1.0) - 1.0) * 100.0,
                         0.0, 1e6)
    assert torch.equal(uniq, torch.where(pos, margin, torch.full_like(margin, 1e6)))
    want = (postprocess.lr_check(p["bestd"], p["rbestd"], cfg) if lr
            else torch.ones_like(lrv))
    assert torch.equal(lrv, want)


def test_confidence_surface_reproduces_gate(pair):
    """tests/test_uniqueness.py:147-170: disp is match_pair's; host-side
    thresholding of uniq_pct and lr_valid gives the in-graph gate's reject
    mask exactly on this scene."""
    l, r = T(pair["left"]), T(pair["right"])
    base = port(_cfg(uniqueness_ratio=0.0))
    disp, uniq, lrv = pipeline.match_pair_with_confidence(l, r, base)
    torch.testing.assert_close(disp, pipeline.match_pair(l, r, base), rtol=0, atol=0)
    for ratio in (5.0, 15.0):
        gated = pipeline.match_pair(l, r, port(_cfg(uniqueness_ratio=ratio)))
        np.testing.assert_array_equal((lrv & (uniq >= ratio)).numpy(), (gated >= 0).numpy())


def test_confidence_zero_cost_pixels_accept():
    """tests/test_uniqueness.py:173-190: an exact-zero best cost gives the
    1e6 margin (the gate accepts such a pixel at every ratio), not 0."""
    flat = T(np.full((16, 48, 3), 128.0, np.float32))
    cfg = port(_cfg(cost="ad", lr_check=False, uniqueness_ratio=0.0, aggregation="box",
                    window_radius=2, max_disparity=8))
    _, uniq, lrv = pipeline.match_pair_with_confidence(flat, flat, cfg)
    assert float(uniq.min()) >= 1e6 - 1 and bool(lrv.all())
    gated = pipeline.match_pair(flat, flat, cfg.replace(uniqueness_ratio=50.0, fill_holes=False))
    assert float((gated >= 0).float().mean()) == 1.0


def test_confidence_rejects_y_chunks(monkeypatch):
    """tests/test_uniqueness.py:193-198 on the eager path; the kernel path
    ignores y_chunks, as match_pair does."""
    z = torch.zeros((32, 48, 3))
    cfg = port(_cfg(y_chunks=2))
    with pytest.raises(ValueError, match="y_chunks"):
        pipeline.match_pair_with_confidence(z, z, cfg)
    _kernel_route(monkeypatch)
    disp, _, _ = pipeline.match_pair_with_confidence(z, z, cfg)
    assert disp.shape == (32, 48)
