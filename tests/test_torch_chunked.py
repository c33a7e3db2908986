"""``y_chunks`` row streaming in the port (``match_pair_chunked``,
``tile_disparity``) on the CPU.

Chunked equals unchunked bit for bit on the eager path and through the
kernel route (the kernels' plain versions on the CPU), for 2, 3 and 4
bands; chunked against the reference's chunked ``match_pair``
(tests/test_sharding.py:98-106's config) at assert_agree's bars; the
halo refusal; one band of ``tile_disparity`` against the reference's.
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
from aswstereomatch_torch.ops import aggregate
from aswstereomatch_torch.utils import convert, synthetic


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


# tests/test_sharding.py's configs
CFG_FULL = RefConfig(
    max_disparity=16, cost="tad_grad", aggregation="asw", window_radius=4,
    gamma_color=14.0, gamma_spatial=9.0,
    lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
)
CFG_BOX = RefConfig(
    max_disparity=16, cost="ad", aggregation="box", window_radius=3,
    lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
)
EAGER_CFGS = [
    CFG_FULL,
    CFG_BOX,
    CFG_FULL.replace(median_mode="weighted"),
    CFG_FULL.replace(asw_symmetric=False, uniqueness_ratio=10.0, fill_holes=False),
    CFG_FULL.replace(asw_separable=True),
    CFG_FULL.replace(aggregation="none", median_filter=False),
    # 13 x 13 = 169 window taps: the two-level window sum
    CFG_FULL.replace(window_radius=6),
]
EAGER_IDS = ["asw_full", "ad_box", "weighted_median", "left_only_uniq", "separable", "none",
             "asw_r6"]


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test's PyTorch work on one thread: tier-1 runs six pytest
    workers on the machine's cores, and at the default count their OpenMP
    threads oversubscribe them (this file ran ~7x longer).  Bands equal the
    whole image at the default count too (the y layout of
    test_torch_sharding.py::test_layouts_equal_unsharded_at_default_threads
    runs the same band function)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair96():
    """tests/test_sharding.py's pair."""
    return synthetic.make_pair(height=96, width=64, max_disparity=16, seed=13)


def assert_bits_equal(got, want):
    diff = (got != want).nonzero()
    assert got.shape == want.shape and diff.numel() == 0, (
        f"{diff.shape[0]} pixels differ, first at {diff[:5].tolist()}: "
        f"{got[tuple(diff[0])].item()!r} vs {want[tuple(diff[0])].item()!r}")


def assert_agree(d_t, d_ref, bar=0.995, gross=0.002):
    """tests/test_oracle_parity.py:141-143."""
    diff = np.abs(d_t - d_ref)
    assert np.mean(diff <= 0.51) > bar, f"disagreement {np.mean(diff > 0.51):.4%}"
    assert np.mean(diff > 2.0) < gross


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("ref_cfg", EAGER_CFGS, ids=EAGER_IDS)
def test_chunked_equals_unchunked_eager(pair96, ref_cfg, n):
    l, r = T(pair96["left"]), T(pair96["right"])
    cfg = port(ref_cfg)
    want = pipeline.match_pair(l, r, cfg)
    got = pipeline.match_pair(l, r, cfg.replace(y_chunks=n))
    assert got.dtype == torch.float32
    assert_bits_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize(
    "ref_cfg", [CFG_FULL, CFG_BOX, CFG_FULL.replace(asw_separable=True),
                CFG_FULL.replace(asw_symmetric=False)],
    ids=["asw_full", "ad_box", "separable", "left_only"])
def test_chunked_equals_unchunked_kernel_route(pair96, ref_cfg, n, monkeypatch):
    """Through the kernel route (``_resolve_backend`` -> "cuda"; each kernel
    wrapper computes its plain version on a CPU tensor): every band's
    kernel outputs, post-processed, equal the whole image's."""
    monkeypatch.setattr(pipeline, "_resolve_backend", lambda cfg, device: "cuda")
    l, r = T(pair96["left"]), T(pair96["right"])
    cfg = port(ref_cfg)
    want = pipeline.match_pair(l, r, cfg)
    got = pipeline.match_pair_chunked(l, r, cfg.replace(y_chunks=n))
    assert_bits_equal(got, want)


@pytest.mark.parametrize("n", [3, 4])
def test_chunked_matches_reference_chunked(pair96, n):
    """tests/test_sharding.py:98-106's config against the reference's own
    chunked run (jnp)."""
    cfg = CFG_FULL.replace(y_chunks=n, backend="jnp")
    want = np.asarray(J(ref_pipeline.match_pair, cfg=cfg)(jnp.asarray(pair96["left"]),
                                                          jnp.asarray(pair96["right"])))
    got = pipeline.match_pair(T(pair96["left"]), T(pair96["right"]), port(cfg)).numpy()
    assert_agree(got, want)


def test_rows_fewer_than_halo_raise(pair96):
    """96 rows in 8 bands of 12 < halo 17 (r = 16 + 1 for the median)."""
    cfg = port(CFG_FULL.replace(window_radius=16, y_chunks=8))
    with pytest.raises(ValueError, match="halo"):
        pipeline.match_pair(T(pair96["left"]), T(pair96["right"]), cfg)


@pytest.mark.parametrize("start", [0, 24, 72])
def test_tile_disparity_matches_reference(pair96, start):
    """One band of 24 rows (top, middle, bottom) from the same halo-extended
    tiles: the port's against the reference's tile_disparity."""
    rows, halo, h = 24, CFG_FULL.halo_y, 96
    idx = np.clip(np.arange(start - halo, start + rows + halo), 0, h - 1)
    le, re_ = pair96["left"][idx], pair96["right"][idx]
    ref_cfg = CFG_FULL.replace(backend="jnp")
    want = np.asarray(J(ref_pipeline.tile_disparity, cfg=ref_cfg, halo=halo, rows=rows,
                        true_h=h, start=start)(jnp.asarray(le), jnp.asarray(re_)))
    got = pipeline.tile_disparity(T(le), T(re_), port(CFG_FULL), halo, rows, h, start).numpy()
    assert got.shape == want.shape == (rows, 64)
    assert_agree(got, want)


def test_window_sum_is_the_plain_sum_in_a_fixed_order():
    """Short windows sum directly; from 128 taps on, dx within each dy row
    then over dy: the same value up to f32 rounding."""
    x = torch.from_numpy(np.random.default_rng(0).random((5, 7, 169)).astype(np.float32))
    torch.testing.assert_close(aggregate._window_sum(x, 13), x.sum(-1), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(aggregate._window_sum(x, 13),
                               x.view(5, 7, 13, 13).sum(-1).sum(-1), rtol=0, atol=0)
    small = x[..., :121].contiguous()
    torch.testing.assert_close(aggregate._window_sum(small, 11), small.sum(-1), rtol=0, atol=0)
