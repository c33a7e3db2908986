"""The port's CLI (``python -m aswstereomatch_torch.cli``) on the CPU: every
case of tests/test_cli.py with ``--device cpu``, and its run record against
the repository's ``cli.py`` (the reference's CLI) for the same flags:
the same config hash and metrics within 1e-3."""

import json
import warnings

import numpy as np
import pytest
import torch

import cli as ref_cli
from aswstereomatch_tpu.utils import io as ref_io

from aswstereomatch_torch import cli
from aswstereomatch_torch.utils import io, native, synthetic

TSUKUBA = ["--synthetic", "tsukuba", "--max-disparity", "8"]
BOX = [*TSUKUBA, "--aggregation", "box", "--window-radius", "2", "--no-postprocess"]


def run_cli(args, tmp_path, name="run"):
    out = tmp_path / f"{name}.json"
    rc = cli.main([*args, "--device", "cpu", "--json", str(out)])
    return rc, (json.loads(out.read_text()) if rc == 0 else None)


def _ppm(path, img):
    arr = img.astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr.tobytes())


def test_cli_synthetic_run(tmp_path):
    rc, rec = run_cli([*BOX, "--out", str(tmp_path / "disp.pgm"),
                       "--err-out", str(tmp_path / "err.pgm")], tmp_path)
    assert rc == 0
    assert rec["metrics"]["bad_2"] < 0.2
    assert rec["pairs_per_s"] > 0 and rec["best_s"] <= rec["mean_s"]
    assert rec["config_hash"] and rec["device"] == "cpu"
    assert set(rec) == {"config", "config_hash", "device", "shape", "compile_s", "best_s",
                        "mean_s", "pairs_per_s", "density", "metrics"}
    disp = io.read_pnm(str(tmp_path / "disp.pgm"))
    assert disp.shape == tuple(rec["shape"]) == (288, 384)
    assert io.read_pnm(str(tmp_path / "err.pgm")).shape == disp.shape


def test_cli_separable_run(tmp_path):
    rc, rec = run_cli([*TSUKUBA, "--aggregation", "asw", "--window-radius", "2",
                       "--separable"], tmp_path)
    assert rc == 0
    assert rec["metrics"]["bad_2"] < 0.2
    assert rec["config"]["asw_separable"] is True


def test_cli_file_inputs(tmp_path):
    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=1)
    lp, rp = str(tmp_path / "l.ppm"), str(tmp_path / "r.ppm")
    _ppm(lp, pair["left"])
    _ppm(rp, pair["right"])
    gt = str(tmp_path / "gt.pfm")
    io.write_pfm(gt, pair["gt"] * 256.0)  # kitti convention scale
    rc, rec = run_cli(["--left", lp, "--right", rp, "--gt", gt, "--dataset", "kitti",
                       "--max-disparity", "8", "--aggregation", "box", "--window-radius",
                       "2", "--no-postprocess"], tmp_path)
    assert rc == 0 and rec["shape"] == [24, 40] and "metrics" in rec


def test_cli_missing_inputs():
    assert cli.main(["--device", "cpu"]) == 2


def _map(args, tmp_path, name):
    out = str(tmp_path / f"{name}.pgm")
    rc, rec = run_cli([*args, "--out", out], tmp_path, name)
    assert rc == 0
    return rec, io.read_pnm(out)


@pytest.mark.parametrize("axis", ["y", "x", "d"])
def test_cli_mesh_warns_and_runs_unsharded(tmp_path, axis):
    """A 1x4 mesh on one visible device: the reference's layout_fits
    warning, then the unsharded run, the same map as without the mesh."""
    args = [*TSUKUBA, "--aggregation", "asw", "--window-radius", "2", "--no-postprocess"]
    with pytest.warns(UserWarning, match="1x4 mesh but only 1 device"):
        rec, disp = _map([*args, "--mesh", "1x4", "--shard-axis", axis], tmp_path, "mesh")
    assert (rec["config"]["mesh_tile"], rec["config"]["tile_axis"]) == (4, axis)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, plain = _map(args, tmp_path, "plain")
    np.testing.assert_array_equal(disp, plain)


@pytest.mark.parametrize("axis", ["y", "x", "d"])
def test_cli_mesh_that_fits_runs_sharded(tmp_path, monkeypatch, axis):
    """Where the mesh fits the visible devices (here 4 CPU devices), the CLI
    runs the declared layout through parallel.api.sharded_match_fn, as the
    reference's CLI does, with no warning, and writes the unsharded map."""
    from aswstereomatch_torch.parallel import api

    monkeypatch.setattr(cli, "visible_devices", lambda device: [torch.device("cpu")] * 4)
    built, sharded_match_fn = [], api.sharded_match_fn

    def spy(cfg, devices=None):
        built.append((cfg.mesh_tile, cfg.tile_axis, len(devices)))
        return sharded_match_fn(cfg, devices)

    monkeypatch.setattr(cli.parallel_api, "sharded_match_fn", spy)
    args = [*TSUKUBA, "--aggregation", "asw", "--window-radius", "2", "--no-postprocess"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rec, disp = _map([*args, "--mesh", "1x4", "--shard-axis", axis], tmp_path, "mesh")
    assert built == [(4, axis, 4)]
    assert (rec["config"]["mesh_tile"], rec["config"]["tile_axis"]) == (4, axis)
    _, plain = _map(args, tmp_path, "plain")
    np.testing.assert_array_equal(disp, plain)


def test_cli_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the machine without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.main([*BOX, "--json", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_cli_profile_writes_a_trace(tmp_path):
    rc, _ = run_cli([*BOX, "--profile", str(tmp_path / "trace")], tmp_path)
    assert rc == 0
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]


def test_device_input_ships_8bit_as_uint8_only():
    ints = np.array([[0.0, 255.0]], np.float32)
    assert cli._device_input(ints).dtype == np.uint8
    for other in (np.array([[0.0, 256.0]], np.float32),   # 16-bit source
                  np.array([[0.5, 3.0]], np.float32),     # float source
                  np.array([[-1.0, 3.0]], np.float32)):
        got = cli._device_input(other)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, other)


def test_cli_dataset_convention_pngs(tmp_path):
    """Both real GT on-disk conventions through the file-based CLI: an 8-bit
    Middlebury scaled PNG (tsukuba x16) and a KITTI uint16 x256 PNG with
    0 = invalid, written by the native codec."""
    if not native.available():
        pytest.skip(f"native codec not built: {native.build_error()}")
    pair = synthetic.make_pair(height=32, width=56, max_disparity=8, seed=2)
    lp, rp = str(tmp_path / "im0.png"), str(tmp_path / "im1.png")
    native.write_png(lp, np.round(pair["left"]))
    native.write_png(rp, np.round(pair["right"]))
    gt8 = str(tmp_path / "gt_x16.png")
    native.write_png(gt8, np.round(pair["gt"] * 16.0))
    dec, valid = io.read_gt_disparity(gt8, "tsukuba")
    assert valid.all() and np.abs(dec - pair["gt"]).max() == 0.0
    gt16 = str(tmp_path / "gt_x256.png")
    native.write_png(gt16, np.where(pair["occluded"], 0.0, pair["gt"]) * 256.0,
                     bit_depth=16)
    dec, valid = io.read_gt_disparity(gt16, "kitti")
    assert (valid == ~pair["occluded"]).all()
    assert np.abs(dec[valid] - pair["gt"][valid]).max() == 0.0
    for gt, ds in [(gt8, "tsukuba"), (gt16, "kitti")]:
        rc, rec = run_cli(["--left", lp, "--right", rp, "--gt", gt, "--dataset", ds,
                           "--max-disparity", "8", "--aggregation", "asw",
                           "--window-radius", "2", "--out", str(tmp_path / f"{ds}.png")],
                          tmp_path, ds)
        assert rc == 0
        assert rec["metrics"]["bad_2"] < 0.2
        assert io.read_image(str(tmp_path / f"{ds}.png")).shape == (32, 56)


# The port's record against the reference CLI's, for the same flags
# (the default backend: "auto" on both sides hashes identically).
REFERENCE_CASES = {
    "box": BOX,
    "asw_full": [*TSUKUBA, "--aggregation", "asw", "--window-radius", "2"],
    "separable": [*TSUKUBA, "--aggregation", "asw", "--window-radius", "2", "--separable"],
    "uniqueness_refuse": [*TSUKUBA, "--aggregation", "asw", "--window-radius", "2",
                          "--uniqueness-ratio", "10", "--no-fill"],
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_cli_record_matches_reference_cli(tmp_path, case, capsys):
    args = REFERENCE_CASES[case]
    rc, rec = run_cli([*args, "--out", str(tmp_path / "port.pgm")], tmp_path, "port")
    assert rc == 0
    ref_json = tmp_path / "ref.json"
    assert ref_cli.main([*args, "--json", str(ref_json),
                         "--out", str(tmp_path / "ref.pgm")]) == 0
    ref = json.loads(ref_json.read_text())
    assert rec["config_hash"] == ref["config_hash"]
    assert rec["config"] == ref["config"]
    assert rec["shape"] == ref["shape"] and rec["density"] == ref["density"]
    assert rec["metrics"].keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        assert abs(rec["metrics"][k] - v) <= 1e-3, (k, rec["metrics"][k], v)
    a = io.read_pnm(str(tmp_path / "port.pgm"))
    b = ref_io.read_pnm(str(tmp_path / "ref.pgm"))
    assert np.mean(np.abs(a - b) <= 1.0) > 0.995  # 8-bit visualizations of the maps
