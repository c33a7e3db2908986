"""The port's sharded layouts on meshes of repeated CPU devices, case for
case tests/test_sharding.py: y-tiling, data x tile batches, the mesh and
its checks, reshard and the config-driven API (the x- and d-sharded cases
are in test_torch_sharding_xd.py).

In every case the port's sharded map equals the port's unsharded map bit
for bit, and agrees with the reference's own sharded function on the same
inputs (8 virtual XLA devices, tests/conftest.py) at assert_agree's bars.
The validation tests use the reference's ``match=`` strings.  The
reference's y_chunks case is tests/test_torch_chunked.py's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.parallel import dshard as ref_dshard
from aswstereomatch_tpu.parallel import mesh as ref_mesh
from aswstereomatch_tpu.parallel import tiling as ref_tiling
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.parallel import api, distributed, dshard, mesh, reshard, tiling
from aswstereomatch_torch.utils import convert

CPU = torch.device("cpu")

# tests/test_sharding.py's configs
CFG_FULL = RefConfig(
    max_disparity=16, cost="tad_grad", aggregation="asw", window_radius=4,
    gamma_color=14.0, gamma_spatial=9.0,
    lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
)
CFG_BOX = RefConfig(
    max_disparity=16, cost="ad", aggregation="box", window_radius=4,
    lr_check=False, fill_holes=False, subpixel=False, median_filter=True,
)


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def cpu_mesh(tile, data=1):
    return mesh.build_mesh(data=data, tile=tile, devices=[CPU] * (data * tile))


REF_FN = {"y": ref_tiling.match_pair_tiled, "x": ref_tiling.match_pair_tiled_x,
          "d": ref_dshard.match_pair_dsharded}
PORT_FN = {"y": tiling.match_pair_tiled, "x": tiling.match_pair_tiled_x,
           "d": dshard.match_pair_dsharded}


def assert_bits_equal(got, want):
    diff = (got != want).nonzero()
    assert got.shape == want.shape and diff.numel() == 0, (
        f"{diff.shape[0]} pixels differ, first at {diff[:5].tolist()}")


def assert_agree(d_t, d_ref, bar=0.995, gross=0.002):
    """tests/test_oracle_parity.py:141-143."""
    diff = np.abs(d_t - d_ref)
    assert np.mean(diff <= 0.51) > bar, f"disagreement {np.mean(diff > 0.51):.4%}"
    assert np.mean(diff > 2.0) < gross


def check_layout(axis, ref_cfg, pair, ntile, ref_kw=None):
    """The port's ``axis`` layout on ``ntile`` CPU shards: bit for bit its
    unsharded map, and within assert_agree of the reference's own sharded
    function (at ``ref_cfg`` with ``ref_kw`` replaced)."""
    l, r = T(pair["left"]), T(pair["right"])
    cfg = port(ref_cfg)
    want = pipeline.match_pair(l, r, cfg)
    got = PORT_FN[axis](l, r, cfg, cpu_mesh(ntile))
    assert got.dtype == torch.float32
    assert_bits_equal(got, want)
    rc = ref_cfg.replace(**(ref_kw or {}))
    ref = np.asarray(J(REF_FN[axis], cfg=rc, device_mesh=ref_mesh.build_mesh(data=1, tile=ntile))(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    assert_agree(got.numpy(), ref)
    return got


# PyTorch's thread count in this process before any test changes it.
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread per test: tier-1 runs six pytest workers on the
    machine's cores, and at the default count their OpenMP threads
    oversubscribe them (these files ran 2-10x longer).  Sharded equals
    unsharded at the default count too (the test below)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair96():
    return synthetic.make_pair(height=96, width=64, max_disparity=16, seed=13)


@pytest.mark.parametrize("axis,ntile,over", [
    ("y", 4, {}), ("x", 2, {}), ("d", 4, {}), ("x", 2, dict(asw_separable=True))],
    ids=["y", "x", "d", "x_separable"])
def test_layouts_equal_unsharded_at_default_threads(pair96, axis, ntile, over):
    """Each layout on the eager path at PyTorch's default thread count
    (the other tests run on one thread, see one_thread): bit for bit the
    unsharded map computed at the same count."""
    torch.set_num_threads(DEFAULT_THREADS)
    cfg = port(CFG_FULL.replace(**over))
    l, r = T(pair96["left"]), T(pair96["right"])
    assert_bits_equal(PORT_FN[axis](l, r, cfg, cpu_mesh(ntile)), pipeline.match_pair(l, r, cfg))


@pytest.mark.parametrize("ref_cfg", [CFG_FULL, CFG_BOX], ids=["asw_full", "ad_box"])
@pytest.mark.parametrize("ntile", [2, 4, 8])
def test_tiled_equals_untiled_exactly(pair96, ref_cfg, ntile):
    check_layout("y", ref_cfg, pair96, ntile)


def test_tiled_nondivisible_height_exact():
    pair = synthetic.make_pair(height=94, width=64, max_disparity=16, seed=4)
    assert check_layout("y", CFG_FULL, pair, 4).shape == (94, 64)


def test_batch_sharded_matches_per_pair(pair96):
    pair2 = synthetic.make_pair(height=96, width=64, max_disparity=16, seed=77)
    lefts = np.stack([pair96["left"], pair2["left"]])
    rights = np.stack([pair96["right"], pair2["right"]])
    cfg = port(CFG_FULL)
    outs = tiling.match_batch_sharded(T(lefts), T(rights), cfg, cpu_mesh(4, data=2))
    assert outs.shape == (2, 96, 64)
    ref = np.asarray(J(ref_tiling.match_batch_sharded, cfg=CFG_FULL,
                       device_mesh=ref_mesh.build_mesh(data=2, tile=4))(
        jnp.asarray(lefts), jnp.asarray(rights)))
    for i in range(2):
        assert_bits_equal(outs[i], pipeline.match_pair(T(lefts[i]), T(rights[i]), cfg))
        assert_agree(outs[i].numpy(), ref[i])


def test_batch_sharded_sgm_data_only_and_tile_rejected(pair96):
    """A data-only SGM batch runs the unsharded pipeline per shard; a tile
    axis is refused (scanline-global aggregation)."""
    ref_cfg = RefConfig(max_disparity=16, aggregation="sgm")
    cfg = port(ref_cfg)
    lefts = T(np.stack([pair96["left"]] * 2))
    rights = T(np.stack([pair96["right"]] * 2))
    outs = tiling.match_batch_sharded(lefts, rights, cfg, cpu_mesh(1, data=2))
    want = pipeline.match_pair(lefts[0], rights[0], cfg)
    for i in range(2):
        assert_bits_equal(outs[i], want)
    ref = np.asarray(J(ref_tiling.match_batch_sharded, cfg=ref_cfg,
                       device_mesh=ref_mesh.build_mesh(data=2, tile=1))(
        jnp.asarray(lefts.numpy()), jnp.asarray(rights.numpy())))
    assert_agree(outs[0].numpy(), ref[0])
    with pytest.raises(ValueError, match="scanlines"):
        tiling.match_batch_sharded(lefts, rights, cfg, cpu_mesh(2))
    with pytest.raises(ValueError, match="scanlines"):
        tiling.match_pair_tiled(lefts[0], rights[0], cfg, cpu_mesh(2))


def test_batch_not_divisible_by_data_axis_raises(pair96):
    lefts = T(np.stack([pair96["left"]] * 3))
    with pytest.raises(ValueError, match="divisible"):
        tiling.match_batch_sharded(lefts, lefts, port(CFG_FULL), cpu_mesh(1, data=2))


def test_shard_batch_arrays_places_data_x_tile_blocks():
    a = torch.arange(4 * 10 * 3, dtype=torch.float32).reshape(4, 10, 3)
    b = a + 0.5
    m = mesh.build_mesh(data=2, tile=3, devices=[CPU] * 6)
    sa, sb = tiling.shard_batch_arrays((a, b), m)
    assert len(sa) == 2 and all(len(row) == 3 for row in sa)
    assert [blk.shape[1] for blk in sa[0]] == [4, 3, 3]
    for src, blocks in ((a, sa), (b, sb)):
        back = torch.cat([torch.cat(row, dim=1) for row in blocks], dim=0)
        assert torch.equal(back, src)
        assert all(blk.device == CPU for row in blocks for blk in row)


def test_halo_too_small_raises(pair96):
    cfg = port(CFG_FULL.replace(window_radius=16))  # halo 17 > 12 rows/shard
    with pytest.raises(ValueError, match="halo"):
        tiling.match_pair_tiled(T(pair96["left"]), T(pair96["right"]), cfg, cpu_mesh(8))


def test_mesh_validation():
    with pytest.raises(ValueError, match="devices"):
        mesh.build_mesh(data=4, tile=4, devices=[CPU] * 8)
    m = mesh.build_mesh(data=2, tile=4, devices=[CPU] * 8)
    assert m.shape == {"data": 2, "tile": 4} and m.devices.shape == (2, 4)
    assert mesh.mesh_from_config(port(CFG_FULL.replace(mesh_tile=2)), [CPU] * 2).shape == {
        "data": 1, "tile": 2}
    assert mesh.single_device_mesh([CPU]).shape == {"data": 1, "tile": 1}
    if not torch.cuda.is_available():  # the default is every visible card
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            mesh.single_device_mesh()


def test_tiled_weighted_median_exact(pair96):
    check_layout("y", CFG_FULL.replace(median_mode="weighted"), pair96, 4)


@pytest.mark.parametrize("ntile", [2, 4])
def test_reshard_roundtrip_and_layout(ntile):
    """x_to_d / d_to_x: the blocks of the other placement, values unchanged."""
    rng = np.random.default_rng(5)
    vol = T(rng.random((16, 32, 8)).astype(np.float32))  # (H, W, D)
    m = cpu_mesh(ntile)
    xs = list(torch.tensor_split(vol, ntile, dim=1))
    ds = reshard.x_to_d(xs, m)
    assert [tuple(b.shape) for b in ds] == [(16, 32, 8 // ntile)] * ntile
    assert torch.equal(torch.cat(ds, dim=2), vol)
    back = reshard.d_to_x(ds, m)
    assert all(torch.equal(a, b) for a, b in zip(back, xs))
    with pytest.raises(ValueError, match="blocks"):
        reshard.x_to_d(xs[:-1], m)


def test_config_driven_sharded_api(pair96):
    """parallel.api: the config's declared mesh layout drives the run."""
    l, r = T(pair96["left"]), T(pair96["right"])
    want = pipeline.match_pair(l, r, port(CFG_FULL))
    for axis in ("y", "x", "d"):
        tile = 2 if axis == "x" else 4  # x: the D_max halo needs wide shards
        cfg = port(CFG_FULL.replace(mesh_data=1, mesh_tile=tile, tile_axis=axis))
        assert api.layout_fits(cfg, [CPU] * 4)
        fn = api.sharded_match_fn(cfg, [CPU] * 4)
        assert fn.func is PORT_FN[axis]
        assert_bits_equal(fn(l, r), want)
        batch = api.sharded_batch_fn(cfg, [CPU] * 4)(torch.stack([l, l]), torch.stack([r, r]))
        assert batch.shape == (2, 96, 64)
        assert_bits_equal(batch[1], want)
    # 1x1 layout falls back to the plain pipeline
    fn = api.sharded_match_fn(port(CFG_FULL), [CPU])
    assert fn.func is pipeline.match_pair
    assert_bits_equal(fn(l, r), want)
    assert api.sharded_batch_fn(port(CFG_FULL), [CPU]).func is pipeline.match_batch
    assert not api.layout_fits(port(CFG_FULL))


def test_sharded_api_fallback_warns(pair96, monkeypatch):
    cfg = port(CFG_FULL.replace(mesh_data=16, mesh_tile=16))  # > 8 devices
    with pytest.warns(UserWarning, match="running unsharded"):
        fn = api.sharded_match_fn(cfg, [CPU] * 8)
    out = fn(T(pair96["left"]), T(pair96["right"]))
    assert out.shape == pair96["gt"].shape
    with pytest.warns(UserWarning, match="16x16 mesh but only 8 device"):
        assert api.sharded_batch_fn(cfg, [CPU] * 8).func is pipeline.match_batch
    # without a device list: every visible card; with none visible the
    # defaults raise and name the way to ask for the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    asks = r'devices=\[torch.device\("cpu"\)\]'
    cfg22 = port(CFG_FULL.replace(mesh_data=2, mesh_tile=2))
    for default in (mesh.default_devices, lambda: api.layout_fits(cfg22),
                    lambda: api.sharded_match_fn(cfg22), lambda: api.sharded_batch_fn(cfg22),
                    distributed.global_mesh, lambda: distributed.global_mesh(tile=2)):
        with pytest.raises(ValueError, match=asks):
            default()


def test_global_mesh_tile_across_processes_raises():
    """Without a process group the global mesh is this process's, every
    owner rank 0; ``tile`` shrinks to a count that divides the devices, as
    the reference's does.  A mesh over owners of other ranks spans
    processes: this process owns only its entries (the multi-process runs
    are tests/test_torch_distributed_tile.py's)."""
    g = distributed.global_mesh(tile=4, devices=[CPU] * 8)
    assert g.shape == {"data": 2, "tile": 4} and g.devices.shape == (2, 4)
    assert g.owners(1) == [(0, CPU)] * 4 and g.is_local and len(g.local_shards()) == 8
    assert distributed.global_devices([CPU] * 2) == [(0, CPU)] * 2
    assert distributed.global_mesh(tile=3, devices=[CPU] * 8).shape == {"data": 4, "tile": 2}
    assert distributed.global_mesh(tile=8, devices=[CPU] * 4).shape == {"data": 1, "tile": 4}
    assert distributed.global_mesh(devices=[CPU] * 4).shape == {"data": 1, "tile": 4}
    span = mesh.build_mesh(2, 2, [(0, CPU), (1, CPU), (1, CPU), (2, "cpu")])
    assert span.shape == {"data": 2, "tile": 2} and span.ranks.tolist() == [[0, 1], [1, 2]]
    assert span.owners(0) == [(0, CPU), (1, CPU)] and span.owners(1)[1] == (2, CPU)
    assert span.local_shards() == [(0, 0)] and not span.is_local


def test_run_batch_distributed_one_process(pair96):
    """One process: its shards cover the whole batch, each equal to the
    matching slice of the unsharded map; a batch not divisible by the data
    axis raises."""
    pairs = [synthetic.make_pair(height=32, width=48, max_disparity=8, seed=s) for s in range(4)]
    lefts = np.stack([p["left"] for p in pairs])
    rights = np.stack([p["right"] for p in pairs])
    cfg = port(CFG_FULL.replace(max_disparity=8, window_radius=2))
    g = distributed.global_mesh(tile=2, devices=[CPU] * 4)
    shards = distributed.run_batch_distributed(lefts, rights, cfg, g)
    assert len(shards) == 4
    seen = np.zeros((4, 32), bool)
    for s in shards:
        bs, rs = s.index
        for bi in range(bs.start, bs.stop):
            want = pipeline.match_pair(T(lefts[bi]), T(rights[bi]), cfg)[rs]
            assert_bits_equal(s.data[bi - bs.start], want)
        seen[bs, rs] = True
    assert seen.all()
    with pytest.raises(ValueError, match="divisible"):
        distributed.run_batch_distributed(lefts[:3], rights[:3], cfg, g)


def test_weak_scaling_report():
    assert distributed.weak_scaling_report({}) == {}
    rep = distributed.weak_scaling_report({2: 2.5, 1: 2.0, 4: 0.0})
    assert list(rep) == [1, 2, 4] and rep[1] == 1.0 and rep[2] == 0.8 and np.isnan(rep[4])
