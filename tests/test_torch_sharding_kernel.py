"""The kernel route of the sharded layouts on the CPU: ``_resolve_backend``
monkeypatched to "cuda" (as tests/test_torch_chunked.py does), so that the
x- and d-sharded shards go through K1's wrapper with its shard inputs
(``n_valid_cols``, ``d_window``, the strip), which computes its plain
version on a CPU tensor, and y-tiling through ``kernel_for``'s kernel.

Each sharded map equals the unsharded kernel-route map bit for bit (at
``kernel_layout="xlanes"`` for x and d, where left-only ASW and box run K1)
and agrees with the reference's sharded function at ``backend="pallas"``
(its kernels in interpret mode, tests/test_sharding.py:264-321).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.parallel import dshard as ref_dshard
from aswstereomatch_tpu.parallel import mesh as ref_mesh
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops.cuda import asw_kernel
from aswstereomatch_torch.parallel import dshard, tiling

from test_torch_sharding import (CFG_BOX, CFG_FULL, PORT_FN, REF_FN, J, T,  # noqa: F401
                                 assert_agree, assert_bits_equal, cpu_mesh, one_thread,
                                 pair96, port)


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel route on CPU tensors, and a record of K1's calls."""
    monkeypatch.setattr(pipeline, "_resolve_backend", lambda cfg, device: "cuda")
    calls = []
    k1 = asw_kernel.wta_outputs_from_stacks

    def spy(ls, rs, cfg, plan=None, **shard):
        calls.append((cfg.max_disparity, shard))
        return k1(ls, rs, cfg, plan, **shard)

    monkeypatch.setattr(asw_kernel, "wta_outputs_from_stacks", spy)
    return calls


def ref_sharded(axis, ref_cfg, pair, ntile):
    m = ref_mesh.build_mesh(data=1, tile=ntile)
    return np.asarray(J(REF_FN[axis], cfg=ref_cfg.replace(backend="pallas"), device_mesh=m)(
        jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))


LAYOUTS = [("y", 4), ("x", 2), ("d", 4)]


@pytest.mark.parametrize("ref_cfg", [CFG_FULL, CFG_BOX.replace(lr_check=True, subpixel=True)],
                         ids=["asw_full", "box"])
def test_kernel_route_layouts_equal_unsharded(pair96, kernel_route, ref_cfg):
    """y, x and d on the kernel route against the unsharded kernel route;
    x and d also against the reference's Pallas-kernel layouts."""
    l, r = T(pair96["left"]), T(pair96["right"])
    cfg = port(ref_cfg)
    want = pipeline.match_pair(l, r, cfg.replace(kernel_layout="xlanes"))
    assert_bits_equal(pipeline.match_pair(l, r, cfg), want)  # D <= 64: K1 either way
    for axis, n in LAYOUTS:
        del kernel_route[:]
        got = PORT_FN[axis](l, r, cfg, cpu_mesh(n))
        assert_bits_equal(got, want)
        if axis == "x":
            assert kernel_route == [(16, dict(n_valid_cols=32, want_strip=True))] * 2
        elif axis == "d":
            assert kernel_route == [(6, dict(n_valid_cols=64, want_strip=True,
                                             d_window=(1, 5)))] * 4
        if axis != "y":
            assert_agree(got.numpy(), ref_sharded(axis, ref_cfg, pair96, n))


def test_kernel_route_nondivisible_width_and_wide_mesh(kernel_route):
    """x: the last shard's padding columns feed no right-view candidate
    (n_valid_cols < ws); 4 shards of a 128-wide pair."""
    for (h, w, D, n), valid in (((48, 61, 8, 2), [31, 30]), ((48, 128, 16, 4), [32] * 4)):
        pair = synthetic.make_pair(height=h, width=w, max_disparity=D, seed=21)
        l, r = T(pair["left"]), T(pair["right"])
        cfg = port(CFG_FULL.replace(max_disparity=D))
        del kernel_route[:]
        got = tiling.match_pair_tiled_x(l, r, cfg, cpu_mesh(n))
        assert [c[1]["n_valid_cols"] for c in kernel_route] == valid
        assert_bits_equal(got, pipeline.match_pair(l, r, cfg))


def test_left_only_sharded_layouts_match_xlanes_exactly(pair96, kernel_route):
    """Left-only ASW resolves to the d-lanes kernel (K3) unsharded, but the
    d-sharded and x-tiled paths need K1's window and strip: bit-exact vs
    the unsharded run at kernel_layout='xlanes'; y-tiling follows the
    unsharded resolution (K3); an explicit 'dlanes' is refused on x and d;
    a data x tile batch equals the unsharded map."""
    ref_cfg = CFG_FULL.replace(asw_symmetric=False)
    cfg = port(ref_cfg)
    assert pipeline.kernel_for(cfg).__name__.endswith("asw_dlanes_kernel")
    l, r = T(pair96["left"]), T(pair96["right"])
    ref_auto = pipeline.match_pair(l, r, cfg)
    ref_xlanes = pipeline.match_pair(l, r, cfg.replace(kernel_layout="xlanes"))

    assert_bits_equal(tiling.match_pair_tiled(l, r, cfg, cpu_mesh(4)), ref_auto)
    for axis, n in (("d", 4), ("x", 2)):
        del kernel_route[:]
        got = PORT_FN[axis](l, r, cfg, cpu_mesh(n))
        assert len(kernel_route) == n  # every shard through K1's wrapper
        assert_bits_equal(got, ref_xlanes)
        assert_agree(got.numpy(), ref_sharded(axis, ref_cfg, pair96, n))

    bad = cfg.replace(kernel_layout="dlanes")
    with pytest.raises(ValueError, match="single-shard fast path"):
        dshard.match_pair_dsharded(l, r, bad, cpu_mesh(4))
    with pytest.raises(ValueError, match="single-shard fast path"):
        tiling.match_pair_tiled_x(l, r, bad, cpu_mesh(2))

    out_b = tiling.match_batch_sharded(torch.stack([l, l]), torch.stack([r, r]), cfg,
                                       cpu_mesh(2, data=2))
    assert_bits_equal(out_b[0], ref_auto)
    assert_bits_equal(out_b[1], ref_auto)


def test_separable_kernel_route(pair96, kernel_route):
    """Separable ASW: y-tiling reaches its kernel (K2) through
    tile_disparity, bit for bit; the x- and d-sharded kernel branches run
    K1, which does not compute the separable window: refused, as the
    reference's x-lanes kernel refuses it (no silent eager run)."""
    cfg = port(CFG_FULL.replace(asw_separable=True))
    l, r = T(pair96["left"]), T(pair96["right"])
    assert_bits_equal(tiling.match_pair_tiled(l, r, cfg, cpu_mesh(4)),
                      pipeline.match_pair(l, r, cfg))
    for fn, n in ((tiling.match_pair_tiled_x, 2), (dshard.match_pair_dsharded, 4)):
        with pytest.raises(ValueError, match="does not implement separable ASW"):
            fn(l, r, cfg, cpu_mesh(n))
    assert kernel_route == []


@pytest.mark.parametrize("n", [2, 4])
def test_shard_wta_outputs_match_reference_and_merge_to_unsharded(n):
    """Each d-shard's windowed K1 planes (the shifted right stack, the
    window and the strip re-sliced to right columns) against the
    reference's shard_wta_outputs (Pallas, interpret mode); merged in
    ascending order they are the unsharded kernel's planes."""
    ref_cfg = CFG_FULL.replace(max_disparity=8, window_radius=2)
    cfg = port(ref_cfg)
    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=9)
    l, r = T(pair["left"]), T(pair["right"])
    parts = [dshard.shard_wta_outputs(l, r, cfg, k, n) for k in range(n)]
    for k, part in enumerate(parts):
        ref = J(ref_dshard.shard_wta_outputs, cfg=ref_cfg, k=k, n=n)(
            jnp.asarray(pair["left"]), jnp.asarray(pair["right"]))
        for name, got, want in zip(("bestc", "bestd", "cm", "cp", "rbestc", "rbestd"), part, ref):
            want = np.asarray(want)
            if name in ("bestd", "rbestd"):
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"shard {k} {name}")
            elif name in ("bestc", "rbestc"):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    bc, bd, cm, cp, rc, rd = dshard._merge(parts)
    whole = asw_kernel.wta_outputs(l, r, cfg)
    assert torch.equal(bd, whole["bestd"]) and torch.equal(rd, whole["rbestd"])
    assert torch.equal(bc, whole["bestc"])
    inner = (whole["bestd"] > 0) & (whole["bestd"] < 7)
    assert torch.equal(cm[inner], whole["cm"][inner]) and torch.equal(cp[inner], whole["cp"][inner])
