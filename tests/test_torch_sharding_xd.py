"""The port's x- and d-sharded layouts on the eager path (CPU tensors), case
for case tests/test_sharding.py, and their checks.

Every sharded map equals the port's unsharded map bit for bit and agrees
with the reference's own sharded function (jnp on 8 virtual XLA devices) at
assert_agree's bars.  The kernel route of these layouts is in
test_torch_sharding_kernel.py.
"""

import numpy as np
import pytest
import torch

from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.parallel import dshard, tiling

from test_torch_sharding import (CFG_BOX, CFG_FULL, T, check_layout, cpu_mesh,  # noqa: F401
                                 one_thread, pair96, port)


def test_dsharded_equals_unsharded_exactly(pair96):
    """Disparity-axis sharding: D=16 over 4 shards."""
    check_layout("d", CFG_FULL, pair96, 4)


@pytest.mark.parametrize("ntile", [2, 8])
def test_dsharded_other_shard_counts(pair96, ntile):
    """Two slabs of 8 and eight of 2 (one overlap d each side)."""
    check_layout("d", CFG_FULL, pair96, ntile)


def test_dshard_validates_divisibility(pair96):
    with pytest.raises(ValueError, match="divisible"):
        dshard.match_pair_dsharded(T(pair96["left"]), T(pair96["right"]), port(CFG_FULL),
                                   cpu_mesh(3))
    with pytest.raises(ValueError, match="divisible"):
        dshard.shard_wta_outputs(T(pair96["left"]), T(pair96["right"]), port(CFG_FULL), 0, 3)


def test_xtiled_equals_untiled_exactly(pair96):
    """x-tiling with the D_max right-image halo: 64 cols / 2 shards = 32 >=
    halo (r + D - 1 = 19), and a 128-wide pair over 4 shards."""
    check_layout("x", CFG_FULL, pair96, 2)
    wide = synthetic.make_pair(height=48, width=128, max_disparity=16, seed=31)
    check_layout("x", CFG_FULL, wide, 4)


def test_xtiled_nondivisible_width_exact():
    pair = synthetic.make_pair(height=48, width=61, max_disparity=8, seed=21)
    got = check_layout("x", CFG_FULL.replace(max_disparity=8), pair, 2)
    assert got.shape == (48, 61)


def test_xtiled_halo_validation(pair96):
    with pytest.raises(ValueError, match="halo"):  # 8 cols/shard < halo 19
        tiling.match_pair_tiled_x(T(pair96["left"]), T(pair96["right"]), port(CFG_FULL),
                                  cpu_mesh(8))


def test_xtiled_weighted_median_exact(pair96):
    """x-tiling with the weighted median (gathered Lab guide)."""
    check_layout("x", CFG_FULL.replace(median_mode="weighted"), pair96, 2)


def test_xtiled_box_exact(pair96):
    check_layout("x", CFG_BOX.replace(lr_check=True, fill_holes=True, subpixel=True), pair96, 2)


def test_xtiled_uniqueness_gate_exact(pair96):
    """x-tiling keeps full d rows per pixel, so the uniqueness gate tiles."""
    check_layout("x", CFG_FULL.replace(uniqueness_ratio=10.0, fill_holes=False), pair96, 2)


def test_separable_tiled_xtiled_dsharded_exact(pair96):
    """The separable speed mode through all three layouts (eager: the
    slab's d_indices reach the separable aggregation)."""
    cfg = CFG_FULL.replace(asw_separable=True)
    check_layout("y", cfg, pair96, 4)
    check_layout("x", cfg, pair96, 2)
    check_layout("d", cfg, pair96, 4)


def test_layout_rejections(pair96):
    """The reference's refusals: SGM does not tile (y, x) and d-sharding
    covers asw only off the kernel route; x-tiling covers asw / box; the
    uniqueness gate does not d-shard."""
    l, r = T(pair96["left"]), T(pair96["right"])
    sgm = port(CFG_FULL.replace(aggregation="sgm"))
    for fn, m in ((tiling.match_pair_tiled, cpu_mesh(4)), (tiling.match_pair_tiled_x, cpu_mesh(2))):
        with pytest.raises(ValueError, match="scanlines"):
            fn(l, r, sgm, m)
    with pytest.raises(ValueError, match="covers asw"):
        dshard.match_pair_dsharded(l, r, sgm, cpu_mesh(4))
    with pytest.raises(ValueError, match=r"covers asw \(both backends\) and box"):
        dshard.match_pair_dsharded(l, r, port(CFG_BOX), cpu_mesh(4))
    with pytest.raises(ValueError, match="asw/box"):
        tiling.match_pair_tiled_x(l, r, port(CFG_FULL.replace(aggregation="none")), cpu_mesh(2))
    with pytest.raises(ValueError, match="uniqueness_ratio"):
        dshard.match_pair_dsharded(l, r, port(CFG_FULL.replace(uniqueness_ratio=5.0)),
                                   cpu_mesh(4))


def test_shards_of_one_device_equal_a_mesh_of_one(pair96):
    """A one-shard mesh runs each layout as the whole image."""
    l, r = T(pair96["left"]), T(pair96["right"])
    cfg = port(CFG_FULL)
    want = tiling.match_pair_tiled(l, r, cfg, cpu_mesh(1))
    for fn in (tiling.match_pair_tiled_x, dshard.match_pair_dsharded):
        assert torch.equal(fn(l, r, cfg, cpu_mesh(1)), want)
    assert np.isfinite(want.numpy()).all()
