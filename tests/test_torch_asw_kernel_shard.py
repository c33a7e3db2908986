"""K1's shard inputs in the plain version against the reference's Pallas
kernel (interpret mode on the CPU): ``n_valid_cols``, ``d_window`` and
``want_strip`` (the reference's asw_kernel.py:466-473, :270-298, :618-626).

Both take the same channel stacks (built by the port, handed over as numpy).
Bars of tests/test_torch_asw_kernel.py::assert_exact_outputs: integer planes
exactly (``r_strip_d`` where its cost is finite; elsewhere both hold 0),
floats at rtol 1e-5 / atol 1e-4 (``rbestc`` and ``r_strip_c`` too, inf where
no candidate reaches the column).
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

from aswstereomatch_torch.ops.cuda import asw_kernel, common
from aswstereomatch_torch.utils import convert

from test_torch_asw_kernel import assert_exact_outputs

CFG = RefConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                gamma_color=14.0, gamma_spatial=9.0)
TOL = dict(rtol=1e-5, atol=1e-4)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def both(ref_cfg, shape, seed, **shard):
    """(port plain outputs, reference Pallas outputs) over the same stacks."""
    h, w = shape
    pair = synthetic.make_pair(height=h, width=w, max_disparity=ref_cfg.max_disparity,
                               seed=seed)
    cfg = port(ref_cfg)
    ls, rs = common.stacks(torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"]), cfg)
    got = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, **shard)
    n_valid = shard.get("n_valid_cols")
    fn = jax.jit(functools.partial(ref_kernel.wta_outputs_from_stacks, cfg=ref_cfg,
                                   n_valid_cols=w if n_valid is None else n_valid,
                                   want_strip=shard.get("want_strip", False),
                                   d_window=shard.get("d_window")))
    ref = fn(jnp.asarray(ls.numpy()), jnp.asarray(rs.numpy()))
    return ({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in ref.items()})


def assert_shard_outputs(got, ref, D, strip):
    assert sorted(got) == sorted(ref)
    assert_exact_outputs(got, ref, D)
    if not strip:
        return
    assert got["r_strip_c"].shape == got["r_strip_d"].shape == (got["bestd"].shape[0], D - 1)
    np.testing.assert_allclose(got["rbestc"], ref["rbestc"], **TOL)
    np.testing.assert_allclose(got["r_strip_c"], ref["r_strip_c"], **TOL)
    finite = np.isfinite(ref["r_strip_c"])
    np.testing.assert_array_equal(got["r_strip_d"][finite], ref["r_strip_d"][finite])
    np.testing.assert_array_equal(got["r_strip_d"][~finite], 0)


# (id, config overrides, (H, W), seed): tests/test_torch_asw_kernel.py's
# geometries, its edge geometries among them
GEOMETRIES = [
    ("symmetric", {}, (24, 40), 3),
    ("left_only", dict(asw_symmetric=False), (24, 40), 3),
    ("ad_cost", dict(cost="ad"), (24, 40), 3),
    ("multi_xtile", {}, (16, 200), 3),
    ("r1_d12", dict(max_disparity=12, window_radius=1), (16, 48), 3),
    ("r0_d2", dict(max_disparity=2, window_radius=0), (13, 24), 6),
    ("r1_d4", dict(max_disparity=4, window_radius=1), (11, 40), 6),
    ("one_tile", {}, (8, 128), 6),
]


def _shards(D, W):
    """n_valid_cols < W; a window of the d-shard form (one overlap d each
    side, as dshard.py runs it) and one touching d = 0; the strip; all three."""
    mid = (1, max(2, D - 1))
    return {
        "n_valid": dict(n_valid_cols=W - 5),
        "window": dict(d_window=mid),
        "window_lo0": dict(d_window=(0, max(1, D // 2))),
        "strip": dict(want_strip=True),
        "all": dict(n_valid_cols=W - 7, d_window=mid, want_strip=True),
    }


@pytest.mark.parametrize("kind", ["n_valid", "window", "window_lo0", "strip", "all"])
@pytest.mark.parametrize("case", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_shard_inputs_match_pallas_kernel(case, kind):
    _, over, shape, seed = case
    ref_cfg = CFG.replace(**over)
    D = ref_cfg.max_disparity
    shard = _shards(D, shape[1])[kind]
    got, ref = both(ref_cfg, shape, seed, **shard)
    assert_shard_outputs(got, ref, D, shard.get("want_strip", False))


@pytest.mark.parametrize("agg", ["box", "asw_left_only"])
def test_shard_inputs_box_and_left_only(agg):
    """Box (the reference's bar for its sums: argmin agreement > 99.9%) and
    left-only ASW (exact) with every shard input at once."""
    ref_cfg = (CFG.replace(aggregation="box", window_radius=3) if agg == "box"
               else CFG.replace(asw_symmetric=False))
    shard = dict(n_valid_cols=33, d_window=(1, 7), want_strip=True)
    got, ref = both(ref_cfg, (24, 40), 12, **shard)
    if agg == "box":
        for k in ("bestd", "rbestd"):
            assert (got[k] == ref[k]).mean() > 0.999
        np.testing.assert_allclose(got["bestc"], ref["bestc"], rtol=1e-4, atol=1e-3)
        finite = np.isfinite(ref["r_strip_c"])
        assert (got["r_strip_d"][finite] == ref["r_strip_d"][finite]).mean() > 0.999
    else:
        assert_shard_outputs(got, ref, 8, True)


def test_no_shard_inputs_is_the_unsharded_plain_version():
    """The defaults (n_valid_cols = W, the window [0, D), no strip) and the
    same values spelled out give the unsharded planes, bit for bit."""
    cfg = port(CFG)
    pair = synthetic.make_pair(height=20, width=36, max_disparity=8, seed=2)
    ls, rs = common.stacks(torch.from_numpy(pair["left"]), torch.from_numpy(pair["right"]), cfg)
    want = asw_kernel.reference_from_stacks(ls, rs, cfg)
    spelled = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, n_valid_cols=36, d_window=(0, 8))
    strip = asw_kernel.wta_outputs_from_stacks(ls, rs, cfg, want_strip=True)
    for k in want:
        assert torch.equal(spelled[k], want[k]), k
        assert torch.equal(strip[k], want[k]), k
    # the strip's own part: every right pixel has its d = 0 candidate
    assert torch.isfinite(strip["rbestc"]).all()


@pytest.mark.parametrize("shard", [dict(n_valid_cols=37), dict(n_valid_cols=-1),
                                   dict(d_window=(3, 3)), dict(d_window=(0, 9))])
def test_shard_inputs_out_of_range_raise(shard):
    cfg = port(CFG)
    with pytest.raises(ValueError, match="n_valid_cols|d_window"):
        asw_kernel.wta_outputs_from_stacks(torch.zeros(7, 8, 40), torch.zeros(7, 8, 47), cfg,
                                           **shard)
