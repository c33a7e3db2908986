"""The port's plain separable aggregation against the reference's jnp
function and its literal-loop oracle (on the CPU).

Bars are the reference's (tests/test_oracle_parity.py:68-81): rtol 2e-4 /
atol 2e-3 on the aggregated volume.
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
from aswstereomatch_tpu.ops import aggregate as ref_aggregate
from aswstereomatch_tpu.ops import preprocess as ref_preprocess

from aswstereomatch_torch.ops import aggregate, preprocess
from aswstereomatch_torch.utils import convert

# test_oracle_parity.py's CFG_TAD, separable
SEP = RefConfig(max_disparity=12, cost="tad_grad", aggregation="asw", window_radius=4,
                gamma_color=14.0, gamma_spatial=9.0, asw_separable=True)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize("cost", ["ad", "tad_grad"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "left_only"])
def test_separable_aggregation_matches_jnp(small_pair, symmetric, cost):
    ref_cfg = SEP.replace(asw_symmetric=symmetric, cost=cost)
    left, right = small_pair["left"], small_pair["right"]
    a_j = np.asarray(J(ref_aggregate.aggregate_asw, cfg=ref_cfg)(
        jnp.asarray(left), jnp.asarray(right)))
    a_t = aggregate.aggregate_asw(T(left), T(right), port(ref_cfg)).numpy()
    assert a_t.dtype == np.float32 and a_t.shape == a_j.shape
    np.testing.assert_allclose(a_t, a_j, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "left_only"])
def test_separable_aggregation_matches_oracle(small_pair, symmetric):
    ref_cfg = SEP.replace(asw_symmetric=symmetric)
    left, right = small_pair["left"], small_pair["right"]
    v = oracle.cost_volume_ext(left, right, ref_cfg, ref_cfg.window_radius)
    a_o = oracle.aggregate_asw_separable(v, left, right, ref_cfg)
    a_t = aggregate.aggregate_asw(T(left), T(right), port(ref_cfg)).numpy()
    np.testing.assert_allclose(a_t, a_o, rtol=2e-4, atol=2e-3)


def test_from_stacks_d_indices_match_jnp(small_pair):
    """aggregate_asw_separable_from_stacks on a subset of disparities (the
    reference's d_indices), from pre-extended stacks."""
    ref_cfg = SEP
    r, D = ref_cfg.window_radius, ref_cfg.max_disparity
    left, right = small_pair["left"], small_pair["right"]
    d_idx = [0, 3, 7, 11]

    def ref_fn(l, rr):
        ls = jnp.pad(ref_preprocess.channel_stack(l), ((0, 0), (0, 0), (r, r)), mode="edge")
        rs = jnp.pad(ref_preprocess.channel_stack(rr), ((0, 0), (0, 0), (r + D - 1, r)),
                     mode="edge")
        return ref_aggregate.aggregate_asw_separable_from_stacks(
            ls, rs, ref_cfg, jnp.asarray(d_idx))

    a_j = np.asarray(jax.jit(ref_fn)(jnp.asarray(left), jnp.asarray(right)))
    ls = preprocess.pad_edge(preprocess.channel_stack(T(left)), 2, r, r)
    rs = preprocess.pad_edge(preprocess.channel_stack(T(right)), 2, r + D - 1, r)
    cfg = port(ref_cfg)
    a_t = aggregate.aggregate_asw_separable_from_stacks(ls, rs, cfg, d_idx).numpy()
    assert a_t.shape == small_pair["left"].shape[:2] + (len(d_idx),)
    np.testing.assert_allclose(a_t, a_j, rtol=2e-4, atol=2e-3)
    full = aggregate.aggregate_asw_separable_from_stacks(ls, rs, cfg).numpy()
    np.testing.assert_array_equal(a_t, full[..., d_idx])


def test_bf16_storage_rounds_the_raw_cost(small_pair):
    """storage_dtype=bfloat16 equals aggregating the bf16-rounded cost: the
    volume moves by the rounding and no more."""
    cfg = port(SEP)
    r, D = cfg.window_radius, cfg.max_disparity
    ls = preprocess.pad_edge(preprocess.channel_stack(T(small_pair["left"])), 2, r, r)
    rs = preprocess.pad_edge(preprocess.channel_stack(T(small_pair["right"])), 2, r + D - 1, r)
    a32 = aggregate.aggregate_asw_separable_from_stacks(ls, rs, cfg)
    a16 = aggregate.aggregate_asw_separable_from_stacks(ls, rs, cfg,
                                                        storage_dtype=torch.bfloat16)
    assert a16.dtype == torch.float32 and not torch.equal(a16, a32)
    # bf16 keeps 8 significant bits: relative error <= 2^-9 per raw cost
    torch.testing.assert_close(a16, a32, rtol=2.0**-8, atol=0.0)


@pytest.mark.parametrize("r,gamma_p", [(0, 9.0), (2, 9.0), (16, 31.0), (32, 31.0)])
def test_axial_weights_bit_equal_reference(r, gamma_p):
    ref_cfg = SEP.replace(window_radius=r, gamma_spatial=gamma_p)
    got = convert.axial_weights_np(port(ref_cfg))
    assert got.dtype == np.float32 and got.shape == (2 * r + 1,)
    np.testing.assert_array_equal(got, ref_aggregate._axial_weights_np(ref_cfg))
    tables = convert.constant_tables(port(ref_cfg), "cpu")
    np.testing.assert_array_equal(tables["axial_weights"].numpy(), got)
