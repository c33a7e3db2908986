"""The port's framework-neutral copies held equal to the reference.

aswstereomatch_torch carries its own config, constant tables, synthetic
scenes and evaluation (it never imports jax or aswstereomatch_tpu); these
tests pin each copy to the reference field for field and byte for byte.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aswstereomatch_tpu import config as ref_config
from aswstereomatch_tpu.ops.pallas import asw_kernel as ref_kernel
from aswstereomatch_tpu.utils import colorspace as ref_colorspace
from aswstereomatch_tpu.utils import evaluate as ref_evaluate
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch import config
from aswstereomatch_torch.utils import convert, evaluate, synthetic

REPO = Path(__file__).resolve().parents[1]
_PORT_TO_REF = {"auto": "auto", "eager": "jnp", "cuda": "pallas"}


def test_fields_and_defaults_match_reference():
    ref_fields = {f.name: f for f in dataclasses.fields(ref_config.StereoConfig)}
    fields = {f.name: f for f in dataclasses.fields(config.StereoConfig)}
    assert list(fields) == list(ref_fields)
    for name, f in fields.items():
        assert f.type == ref_fields[name].type, name
        assert f.default == ref_fields[name].default, name


def test_derived_properties_match_reference():
    for name, ref_cfg in ref_config.PRESETS.items():
        cfg = config.PRESETS[name]
        assert cfg.window_size == ref_cfg.window_size
        assert cfg.halo_y == ref_cfg.halo_y
        assert cfg.halo_x == ref_cfg.halo_x
        # backend "auto" on both sides: identical field dicts, identical hash
        assert cfg.config_hash() == ref_cfg.config_hash()


def test_presets_match_reference_except_backend():
    assert sorted(config.PRESETS) == sorted(ref_config.PRESETS)
    assert config.SEP_CONTRACT == ref_config.SEP_CONTRACT
    for name, ref_cfg in ref_config.PRESETS.items():
        assert dataclasses.asdict(config.get_preset(name)) == dataclasses.asdict(ref_cfg)
    with pytest.raises(KeyError, match="unknown preset"):
        config.get_preset("nope")


@pytest.mark.parametrize(
    "bad",
    [
        dict(cost="sad"),
        dict(aggregation="median"),
        dict(aggregation="sgm", sgm_p1=9.0, sgm_p2=4.0),
        dict(aggregation="sgm", sgm_paths=6),
        dict(tile_axis="z"),
        dict(max_disparity=0),
        dict(uniqueness_ratio=-1.0),
        dict(window_radius=-1),
        dict(median_mode="mean"),
        dict(kernel_layout="ylanes"),
        dict(aggregation="box", asw_separable=True),
        dict(volume_dtype="float16"),
        dict(volume_dtype="bfloat16"),
        dict(volume_dtype="bfloat16", asw_separable=True, max_disparity=256),
    ],
)
def test_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        ref_config.StereoConfig(**bad)
    with pytest.raises(ValueError):
        config.StereoConfig(**bad)


def test_backend_vocabulary():
    for b in ("auto", "eager", "cuda"):
        assert config.StereoConfig(backend=b).backend == b
    for b in ("jnp", "pallas", "gpu"):
        with pytest.raises(ValueError, match="unknown backend"):
            config.StereoConfig(backend=b)


@pytest.mark.parametrize("ref_backend,port_backend",
                         [("auto", "auto"), ("jnp", "eager"), ("pallas", "cuda")])
def test_from_reference_round_trip(ref_backend, port_backend):
    for ref_cfg in ref_config.PRESETS.values():
        ref_cfg = ref_cfg.replace(backend=ref_backend, lr_tol=0.5, y_chunks=2)
        cfg = convert.from_reference(dataclasses.asdict(ref_cfg))
        assert cfg.backend == port_backend
        assert cfg.replace(backend="auto") == config.StereoConfig(
            **{**dataclasses.asdict(ref_cfg), "backend": "auto"})
        back = {**dataclasses.asdict(cfg), "backend": _PORT_TO_REF[cfg.backend]}
        assert ref_config.StereoConfig(**back) == ref_cfg


@pytest.mark.parametrize("preset", ["middlebury_asw_full", "kitti_tiled", "tsukuba_ad_box"])
def test_constant_tables_bit_equal_reference(preset):
    cfg = config.get_preset(preset)
    tables = convert.constant_tables(cfg, "cpu")
    sw = tables["spatial_weights"]
    assert sw.dtype == torch.float32 and sw.shape == (cfg.window_size,) * 2
    np.testing.assert_array_equal(
        sw.numpy(), ref_kernel._spatial_weights_np(ref_config.get_preset(preset))
    )
    lut = tables["srgb_lut"]
    assert lut.dtype == torch.float32 and lut.shape == (256,)
    np.testing.assert_array_equal(lut.numpy(), ref_colorspace.SRGB_DECODE_LUT)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_make_pair_byte_equal_reference(seed):
    kw = dict(height=37, width=61, max_disparity=12, seed=seed)
    for extra in ({}, dict(fractional=True, flat_patches=2, num_layers=2)):
        ref = ref_synthetic.make_pair(**kw, **extra)
        got = synthetic.make_pair(**kw, **extra)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            assert got[k].tobytes() == ref[k].tobytes(), k


def test_evaluate_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 20, (30, 40)).astype(np.float32)
    b = a + rng.normal(0, 2, a.shape).astype(np.float32)
    valid = rng.random(a.shape) > 0.2
    assert evaluate.bad_report(a, b, valid) == ref_evaluate.bad_report(a, b, valid)
    assert evaluate.bad_report(a, b) == ref_evaluate.bad_report(a, b)
    assert evaluate.bad_delta(a, b, 1.0) == ref_evaluate.bad_delta(a, b, 1.0)
    assert (evaluate.bad_delta_between(a, b, 2.0, valid)
            == ref_evaluate.bad_delta_between(a, b, 2.0, valid))
    assert evaluate.exact_match_rate(a, b) == ref_evaluate.exact_match_rate(a, b)
    assert np.isnan(evaluate.bad_delta(a, b, valid=np.zeros_like(valid)))


def test_port_never_imports_jax():
    """Every module of the port imports without loading jax or the
    reference package (the machine with the card has no jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aswstereomatch_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'aswstereomatch_torch.ops.cuda.asw_sep_kernel' in sys.modules\n"
        "assert 'aswstereomatch_torch.ops.cuda.asw_dlanes_kernel' in sys.modules\n"
        "assert 'aswstereomatch_torch.ops.cuda.asw_sym_dlanes_kernel' in sys.modules\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'aswstereomatch_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
