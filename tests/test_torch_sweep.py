"""The port's dataset sweep (``aswstereomatch_torch.tools.sweep``) on the
CPU: end to end with resume, the u16 fetch against f32, the dataset writer
against the reference's tools/sweep.py byte for byte, and the written maps
against the reference's ``match_pair(..., backend="jnp")`` at the pipeline
bars of tests/test_oracle_parity.py:141-143."""

import importlib.util
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import get_preset as ref_get_preset
from aswstereomatch_tpu.models import pipeline as ref_pipeline

from aswstereomatch_torch.tools import sweep
from aswstereomatch_torch.utils import io

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--preset", "middlebury_asw_full", "--max-disparity", "8", "--window-radius", "2",
         "--backend", "eager", "--device", "cpu"]


def _reference_sweep():
    spec = importlib.util.spec_from_file_location("ref_tools_sweep", REPO / "tools" / "sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(dir_, *extra, capsys=None):
    rc = sweep.main(["--dir", str(dir_), *SMALL, *extra])
    assert rc == 0
    if capsys is not None:
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sweep_end_to_end_and_resume(tmp_path, capsys):
    sweep.make_synthetic_dataset(str(tmp_path), 4, 48, 64, 8)
    summary = _run(tmp_path, capsys=capsys)
    mpath = tmp_path / "sweep_manifest.json"
    man = json.loads(mpath.read_text())
    assert summary["pairs"] == 4 and summary["manifest"] == str(mpath)
    assert len(man["done"]) == 4 and man["config_hash"] == summary["config_hash"]
    for pid, rec in man["done"].items():
        assert (tmp_path / f"{pid}_disp.pfm").exists()
        assert rec["bad_2"] < 0.05, (pid, rec)
    assert summary["mean_bad_2"] == round(float(np.mean(
        [r["bad_2"] for r in man["done"].values()])), 5)

    # a crash that lost the last two pairs' records and maps
    lost = sorted(man["done"])[2:]
    for pid in lost:
        del man["done"][pid]
        (tmp_path / f"{pid}_disp.pfm").unlink()
    mpath.write_text(json.dumps(man))
    kept = {p: (tmp_path / f"{p}_disp.pfm").stat().st_mtime_ns for p in man["done"]}
    summary2 = _run(tmp_path, capsys=capsys)
    man2 = json.loads(mpath.read_text())
    assert summary2["pairs"] == 4 and len(man2["done"]) == 4
    for pid in lost:
        assert (tmp_path / f"{pid}_disp.pfm").exists()
    # the pairs already done were not run again
    assert {p: (tmp_path / f"{p}_disp.pfm").stat().st_mtime_ns for p in kept} == kept


@pytest.mark.parametrize("queue_depth", ["1", "4"])
def test_sweep_u16_fetch_matches_f32(tmp_path, queue_depth):
    """--fetch u16 (the default) agrees with --fetch f32 to the 1/512 px
    quantization bound, and is the reference's jnp encoding of it."""
    d16, d32 = tmp_path / "u16", tmp_path / "f32"
    for d, fetch in ((d16, "u16"), (d32, "f32")):
        sweep.make_synthetic_dataset(str(d), 2, 48, 64, 8)
        _run(d, "--fetch", fetch, "--queue-depth", queue_depth)
    for i in range(2):
        a = io.read_pfm(str(d16 / f"pair{i:04d}_disp.pfm"))
        b = io.read_pfm(str(d32 / f"pair{i:04d}_disp.pfm"))
        valid = b >= 0
        assert np.max(np.abs(a - b)[valid]) <= 1 / 512 + 1e-6
        enc = np.asarray(jnp.clip(jnp.round(jnp.asarray(b) * 256.0), 0, 65535)
                         .astype(jnp.uint16))
        np.testing.assert_array_equal(a, enc.astype(np.float32) / 256.0)


def test_make_synthetic_dataset_matches_reference(tmp_path):
    a, b = tmp_path / "port", tmp_path / "ref"
    sweep.make_synthetic_dataset(str(a), 3, 24, 40, 8)
    _reference_sweep().make_synthetic_dataset(str(b), 3, 24, 40, 8)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert len(os.listdir(a)) == 9
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("preset", ["middlebury_asw_full", "tsukuba_ad_box"])
def test_sweep_maps_agree_with_reference_pipeline(tmp_path, preset):
    sweep.make_synthetic_dataset(str(tmp_path), 2, 40, 56, 8)
    args = ["--preset", preset, "--max-disparity", "8", "--window-radius", "2",
            "--backend", "eager", "--device", "cpu", "--fetch", "f32"]
    assert sweep.main(["--dir", str(tmp_path), *args]) == 0
    cfg = ref_get_preset(preset).replace(max_disparity=8, window_radius=2, backend="jnp")
    for i in range(2):
        left = io.read_pnm(str(tmp_path / f"pair{i:04d}_left.ppm"))
        right = io.read_pnm(str(tmp_path / f"pair{i:04d}_right.ppm"))
        want = np.asarray(ref_pipeline.match_pair(jnp.asarray(left), jnp.asarray(right), cfg))
        got = io.read_pfm(str(tmp_path / f"pair{i:04d}_disp.pfm"))
        diff = np.abs(got - want)
        assert np.mean(diff <= 0.51) > 0.995
        assert np.mean(diff > 2.0) < 0.002


def test_sweep_keeps_holes_with_f32_when_fill_is_off(tmp_path, capsys):
    """fill_holes=False with a gate produces holes: u16 would encode -1 as
    a legal 0, so the sweep forces the f32 fetch and keeps -1."""
    sweep.make_synthetic_dataset(str(tmp_path), 1, 40, 56, 8)
    assert sweep.main(["--dir", str(tmp_path), "--preset", "tsukuba_ad_box",
                       "--max-disparity", "8", "--window-radius", "2",
                       "--uniqueness-ratio", "15", "--device", "cpu"]) == 0
    assert "forcing --fetch f32" in capsys.readouterr().err
    disp = io.read_pfm(str(tmp_path / "pair0000_disp.pfm"))
    assert (disp == -1).any() and (disp >= 0).any()


def test_sweep_failure_is_raised_on_its_turn_after_the_flush(tmp_path):
    """A pair that cannot be read raises on its own turn; the pairs before
    it are in the manifest, and a re-run after the repair does only the
    rest."""
    sweep.make_synthetic_dataset(str(tmp_path), 3, 24, 40, 8)
    good = (tmp_path / "pair0001_left.ppm").read_bytes()
    (tmp_path / "pair0001_left.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises((ValueError, OSError), match="unsupported PNM magic|sio_pnm_header"):
        sweep.main(["--dir", str(tmp_path), *SMALL])
    man = json.loads((tmp_path / "sweep_manifest.json").read_text())
    assert sorted(man["done"]) == ["pair0000"]
    (tmp_path / "pair0001_left.ppm").write_bytes(good)
    assert sweep.main(["--dir", str(tmp_path), *SMALL]) == 0
    man = json.loads((tmp_path / "sweep_manifest.json").read_text())
    assert sorted(man["done"]) == ["pair0000", "pair0001", "pair0002"]


def test_sweep_without_pairs_exits_2(tmp_path):
    assert sweep.main(["--dir", str(tmp_path), *SMALL]) == 2


def test_sweep_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the machine without one")
    sweep.make_synthetic_dataset(str(tmp_path), 1, 24, 40, 8)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sweep.main(["--dir", str(tmp_path)])
    assert not (tmp_path / "sweep_manifest.json").exists()


@pytest.mark.parametrize("src,dtype", [(np.array([[0.0, 255.0]]), torch.uint8),
                                       (np.array([[0.0, 256.0]]), torch.float32),
                                       (np.array([[0.5, 2.0]]), torch.float32)])
def test_to_device_ships_8bit_sources_as_uint8_only(src, dtype):
    t = sweep._to_device(src.astype(np.float32), torch.device("cpu"))
    assert t.dtype == dtype
    np.testing.assert_array_equal(t.numpy().astype(np.float32), src)
    assert np.array_equal(sweep._Fetch(t).wait(), t.numpy())
