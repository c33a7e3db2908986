"""K1's shard inputs and the sharded layouts on the card.

K1 with ``n_valid_cols``, ``d_window`` and the strip against its plain
version (chip_smoke.py's K1_SHARD_CASES and bars), and every layout of
parallel/ on a virtual mesh of the one card against the unsharded run bit
for bit at tests/test_sharding.py's size, each shard launching its kernel
(no plain version, no CPU).  They need a CUDA device and nvcc, so they skip
on machines without a card; run them there with

    python -m pytest --noconftest tests/test_torch_sharding_cuda.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch  # noqa: F401  (read by the skipif condition string)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# The condition string is evaluated when the test runs, not at import.
pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]

_BASE = dict(max_disparity=16, cost="tad_grad", aggregation="asw", window_radius=4,
             gamma_color=14.0, gamma_spatial=9.0)
# (id, config overrides, the unsharded run's overrides for x and d)
CONFIGS = [
    ("asw_full", {}, {}),
    ("left_only", dict(asw_symmetric=False), dict(kernel_layout="xlanes")),
    ("box", dict(aggregation="box", cost="ad"), {}),
    ("box_d128", dict(aggregation="box", max_disparity=128, window_radius=2),
     dict(kernel_layout="xlanes")),
]


@pytest.mark.parametrize("case", chip_smoke.K1_SHARD_CASES,
                         ids=[c[0] for c in chip_smoke.K1_SHARD_CASES])
def test_k1_shard_inputs_match_plain_version(case):
    chip_smoke.check_k1_shard(*case, device=torch.device("cuda", 0))


def _pair(h, w, D, seed=13):
    from aswstereomatch_torch.utils import synthetic

    p = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=seed)
    dev = torch.device("cuda", 0)
    return torch.from_numpy(p["left"]).to(dev), torch.from_numpy(p["right"]).to(dev)


def _launches():
    from aswstereomatch_torch.ops.cuda import (asw_dlanes_kernel, asw_kernel, asw_sep_kernel,
                                               asw_sym_dlanes_kernel)
    torch.cuda.synchronize()
    return {"K1": asw_kernel.launches, "K2": asw_sep_kernel.launches,
            "K3": asw_dlanes_kernel.launches, "K4": asw_sym_dlanes_kernel.launches}


@pytest.mark.parametrize("axis,n", [("y", 4), ("x", 2), ("d", 4)])
@pytest.mark.parametrize("name,over,unsharded_over", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_sharded_layout_equals_unsharded_on_the_card(name, over, unsharded_over, axis, n):
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.parallel import dshard, mesh, tiling

    cfg = StereoConfig(**{**_BASE, **over})
    D = cfg.max_disparity
    if axis == "d" and cfg.aggregation == "box" and D == 16:
        pytest.skip("box at D <= 64 is K1 unsharded too; covered at D = 128")
    l, r = _pair(96, 64 if D <= 16 else 300, D)
    ucfg = cfg if axis == "y" else cfg.replace(**unsharded_over)
    want = pipeline.match_pair(l, r, ucfg)
    fn = {"y": tiling.match_pair_tiled, "x": tiling.match_pair_tiled_x,
          "d": dshard.match_pair_dsharded}[axis]
    before = _launches()
    got = fn(l, r, cfg, mesh.build_mesh(1, n, [l.device] * n))
    after = _launches()
    launched = {k: after[k] - before[k] for k in after}
    kernel = pipeline.kernel_for(ucfg if axis != "y" else cfg)
    key = {"asw_kernel": "K1", "asw_dlanes_kernel": "K3", "asw_sep_kernel": "K2",
           "asw_sym_dlanes_kernel": "K4"}[kernel.__name__.rsplit(".", 1)[1]]
    assert launched == {k: (n if k == key else 0) for k in launched}
    assert got.device == l.device and torch.equal(got, want)


def test_kitti_batch_layout_on_a_2x2_mesh():
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.parallel import mesh, tiling

    cfg = StereoConfig(**_BASE)
    l0, r0 = _pair(96, 64, 16)
    l1, r1 = _pair(96, 64, 16, seed=77)
    lefts, rights = torch.stack([l0, l1]), torch.stack([r0, r1])
    out = tiling.match_batch_sharded(lefts, rights, cfg, mesh.build_mesh(2, 2, [l0.device] * 4))
    for i in range(2):
        assert torch.equal(out[i], pipeline.match_pair(lefts[i], rights[i], cfg))


@pytest.mark.parametrize("axis,n", [("y", 4), ("x", 2), ("d", 4)])
def test_cpu_inputs_over_a_card_mesh(axis, n):
    """A caller's CPU tensors through the config-driven entry point over a
    card mesh: every shard launches K1 on the card and the map comes back
    to the CPU equal to the unsharded run bit for bit."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.parallel import api

    cfg = StereoConfig(**_BASE, mesh_tile=n, tile_axis=axis)
    l, r = _pair(96, 64, 16)
    want = pipeline.match_pair(l, r, cfg).cpu()
    fn = api.sharded_match_fn(cfg, [l.device] * n)
    before = _launches()
    got = fn(l.cpu(), r.cpu())
    after = _launches()
    assert {k: after[k] - before[k] for k in after} == {"K1": n, "K2": 0, "K3": 0, "K4": 0}
    assert got.device.type == "cpu" and torch.equal(got, want)


def test_run_batch_distributed_cpu_inputs_on_the_card():
    """The multi-process runner's batch slice in one process: numpy inputs,
    a 2x2 mesh of the card; each block equals its slice of the pairs'
    single maps bit for bit."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.parallel import distributed

    cfg = StereoConfig(**_BASE)
    pairs = [_pair(96, 64, 16, seed=s) for s in (13, 77)]
    lefts = torch.stack([p[0] for p in pairs]).cpu().numpy()
    rights = torch.stack([p[1] for p in pairs]).cpu().numpy()
    gm = distributed.global_mesh(tile=2, devices=[torch.device("cuda", 0)] * 4)
    before = _launches()
    shards = distributed.run_batch_distributed(lefts, rights, cfg, gm)
    assert _launches()["K1"] - before["K1"] == 4
    want = torch.stack([pipeline.match_pair(l, r, cfg) for l, r in pairs])
    assert len(shards) == 4
    for s in shards:
        assert s.data.device.type == "cuda" and torch.equal(s.data, want[s.index])


def test_separable_x_and_d_refused_on_the_card():
    """K1 does not compute the separable window: the x- and d-sharded
    kernel branches raise on the card, no eager run in its place."""
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.parallel import dshard, mesh, tiling

    cfg = StereoConfig(**_BASE, asw_separable=True)
    l, r = _pair(96, 64, 16)
    for fn, n in ((tiling.match_pair_tiled_x, 2), (dshard.match_pair_dsharded, 4)):
        before = _launches()
        with pytest.raises(ValueError, match="does not implement separable ASW"):
            fn(l, r, cfg, mesh.build_mesh(1, n, [l.device] * n))
        assert _launches() == before
