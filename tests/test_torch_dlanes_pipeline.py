"""The d-lanes paths end to end on the CPU, and the kernel routing against
the reference's.

- The port's ``match_pair`` for left-only ASW, box pinned to
  kernel_layout="dlanes" and symmetric ASW pinned to "dlanes" against the
  reference's ``match_pair(backend="pallas")``, which runs asw_dlanes /
  asw_sym_dlanes in interpret mode.  Bars: winners within 0.51 px on more
  than 99% of pixels and |delta| > 2 on fewer than 0.5%
  (tests/test_pallas_dlanes.py:80-92, :221-234).
- ``kernel_for`` / ``_resolve_backend(cfg, cuda)`` pick the kernel the
  reference's ``_kernel_wta`` picks on a TPU for every config of a grid, and
  raise where it raises.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.ops.pallas import asw_dlanes, asw_kernel, asw_sep_dlanes, asw_sym_dlanes
from aswstereomatch_tpu.utils import synthetic

import aswstereomatch_torch as asm
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops.cuda import (asw_dlanes_kernel, asw_kernel as port_k1,
                                           asw_sep_kernel, asw_sym_dlanes_kernel)
from aswstereomatch_torch.utils import convert

# tests/test_pallas_dlanes.py's CFG with its pipeline stages
CFG = RefConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                asw_symmetric=False, gamma_color=14.0, gamma_spatial=9.0, lr_check=True,
                fill_holes=True, subpixel=True, median_filter=True)

PATHS = {
    "left_only": (CFG, asw_dlanes_kernel),
    "box_dlanes": (CFG.replace(aggregation="box", kernel_layout="dlanes"), asw_dlanes_kernel),
    "sym_dlanes": (CFG.replace(asw_symmetric=True, kernel_layout="dlanes"),
                   asw_sym_dlanes_kernel),
}


def port(ref_cfg):
    return convert.from_reference(dataclasses.asdict(ref_cfg))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("path", list(PATHS))
def test_match_pair_matches_pallas_pipeline(path):
    ref_cfg, kernel = PATHS[path]
    cfg = port(ref_cfg)
    assert pipeline.kernel_for(cfg) is kernel
    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=5)
    l, r = T(pair["left"]), T(pair["right"])
    d_t = pipeline.match_pair(l, r, cfg).numpy()
    assert d_t.dtype == np.float32 and d_t.shape == (24, 40)
    # the kernel route's post-processing, fed by the wrapper's plain version
    # on the CPU, is the eager route's map
    d_wta = pipeline.disparity(kernel.wta_outputs(l, r, cfg), cfg,
                               pipeline.guide_lab(l, cfg)).numpy()
    np.testing.assert_array_equal(d_wta, d_t)
    d_pal = np.asarray(jax.jit(functools.partial(
        ref_pipeline.match_pair, cfg=ref_cfg.replace(backend="pallas")))(
            jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))
    diff = np.abs(d_t - d_pal)
    agree = np.mean(diff <= 0.51)
    assert agree > 0.99, f"disagreement {1 - agree:.4%}"
    assert np.mean(diff > 2.0) < 0.005


REF_KERNELS = {asw_sep_dlanes: "K2", asw_sym_dlanes: "K4", asw_dlanes: "K3", asw_kernel: "K1"}
PORT_KERNELS = {asw_sep_kernel: "K2", asw_sym_dlanes_kernel: "K4", asw_dlanes_kernel: "K3",
                port_k1: "K1", None: None}


def reference_choice(ref_cfg):
    """The kernel the reference runs ``ref_cfg`` through on a TPU ("K1" ..
    "K4"), None for its jnp path, "raises" where it raises ValueError.
    Called with the reference's kernels replaced by markers."""
    try:
        if ref_pipeline._resolve_backend(ref_cfg) == "jnp":
            return None
        return ref_pipeline._kernel_wta(None, None, ref_cfg)
    except ValueError:
        return "raises"


def port_choice(cfg):
    try:
        choice = PORT_KERNELS[pipeline.kernel_for(cfg)]
    except ValueError:
        with pytest.raises(ValueError):
            pipeline._resolve_backend(cfg, torch.device("cuda"))
        return "raises"
    backend = pipeline._resolve_backend(cfg, torch.device("cuda"))
    assert backend == ("eager" if choice is None else "cuda")
    return choice


@pytest.mark.parametrize("D", [2, 8, 64, 65, 128, 129, 256])
def test_kernel_for_matches_reference(D, monkeypatch):
    """Every config of the grid D x r x {asw, box, separable asw} x weight
    mode x layout goes to the reference's kernel (on a TPU, where the
    reference routes to its Pallas kernels) or raises where it raises."""
    monkeypatch.setattr(ref_pipeline.jax, "default_backend", lambda: "tpu")
    for mod, name in REF_KERNELS.items():
        monkeypatch.setattr(mod, "wta_outputs", lambda l, r, cfg, name=name: name)
    aggs = (("asw", False), ("box", False), ("asw", True))
    for r, (agg, sep), sym, layout in itertools.product(
            (2, 16, 30, 31, 32, 33), aggs, (True, False), ("auto", "xlanes", "dlanes")):
        ref_cfg = CFG.replace(max_disparity=D, window_radius=r, aggregation=agg,
                              asw_separable=sep, asw_symmetric=sym, kernel_layout=layout)
        assert port_choice(port(ref_cfg)) == reference_choice(ref_cfg), ref_cfg
    # configs no kernel serves
    for agg in ("none", "sgm"):
        ref_cfg = CFG.replace(max_disparity=D, aggregation=agg, kernel_layout="dlanes")
        assert port_choice(port(ref_cfg)) == reference_choice(ref_cfg) is None


def test_slice_presets_route_to_their_kernels():
    """The slice's three paths at KITTI geometry and the earlier paths."""
    kitti = asm.get_preset("kitti_tiled")
    assert pipeline.kernel_for(kitti.replace(asw_symmetric=False)) is asw_dlanes_kernel
    assert pipeline.kernel_for(kitti.replace(aggregation="box")) is asw_dlanes_kernel
    assert pipeline.kernel_for(kitti.replace(kernel_layout="dlanes")) is asw_sym_dlanes_kernel
    assert pipeline.kernel_for(kitti) is port_k1
    assert pipeline.kernel_for(asm.get_preset("middlebury_asw_full")) is port_k1
    # box at D <= 64 stays on K1 on "auto"
    mid = asm.get_preset("middlebury_asw_full")
    assert pipeline.kernel_for(mid.replace(aggregation="box")) is port_k1
    for name in ("kitti_sep", "kitti_seplo"):
        assert pipeline.kernel_for(asm.get_preset(name)) is asw_sep_kernel


def test_dlanes_on_unsupported_geometry_raises_on_the_card():
    """The fault this routing repairs: "dlanes" on a geometry no d-lanes
    kernel supports ran K1 on the card; it raises, as the reference does.
    On CPU tensors the eager path serves it."""
    l = r = torch.zeros((8, 16, 3))
    for overrides in (dict(max_disparity=256), dict(window_radius=32),
                      dict(asw_symmetric=False, max_disparity=256),
                      dict(aggregation="box", max_disparity=256)):
        cfg = asm.get_preset("kitti_tiled").replace(kernel_layout="dlanes", **overrides)
        with pytest.raises(ValueError, match="dlanes"):
            pipeline._resolve_backend(cfg, torch.device("cuda"))
        with pytest.raises(ValueError, match="dlanes"):
            pipeline._kernel_wta(l, r, cfg)
        assert pipeline._resolve_backend(cfg, torch.device("cpu")) == "eager"
