"""The port's dataset round trip (``aswstereomatch_torch/tools/
dataset_roundtrip.py``) on the CPU.

Each scene's three PNGs equal, byte for byte, what the reference's
``tools/dataset_roundtrip.write_scene`` writes for the same (scene, seed),
and its GT decodes exactly; one tsukuba-sized scene goes through the CLI in
a child process, whose record's bad-2.0 equals the matcher's in this
process on the same decoded pair.
"""

import importlib.util
import json
from pathlib import Path

import pytest

from aswstereomatch_torch.tools import dataset_roundtrip

REPO = Path(__file__).resolve().parents[1]


def ref_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_tools_dataset_roundtrip", REPO / "tools" / "dataset_roundtrip.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i,scene", list(enumerate(dataset_roundtrip.SCENES)))
def test_write_scene_bytes_equal_reference(i, scene, tmp_path):
    ref = ref_tool()
    assert ref.SCENES[scene] == dataset_roundtrip.SCENES[scene]
    ref_paths, _ = ref.write_scene(str(tmp_path / "ref"), scene, seed=40 + i)
    paths, _, err = dataset_roundtrip.write_scene(str(tmp_path / "port"), scene, seed=40 + i)
    assert err == 0.0
    for k in ("im0", "im1", "disp0"):
        assert Path(paths[k]).read_bytes() == Path(ref_paths[k]).read_bytes(), k


def test_roundtrip_through_cli_on_cpu(tmp_path):
    out = tmp_path / "record.json"
    rc = dataset_roundtrip.main(["--device", "cpu", "--dir", str(tmp_path / "scenes"),
                                 "--scenes", "tsukuba", "--radius", "4", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["ok"], rec
    (row,) = rec["rows"]
    assert row["cli_returncode"] == 0 and row["gt_decode_max_err"] == 0.0
    assert row["metrics"]["bad_2"] == row["in_process_metrics"]["bad_2"]
    assert row["metrics"]["bad_2"] < 0.05
    with open(REPO / "bench_results" / "dataset_roundtrip.json") as f:
        ref = json.load(f)
    assert set(ref) <= set(rec) and set(ref["rows"][0]) <= set(row)
    assert row["gt_format"] == ref["rows"][0]["gt_format"]
    assert {"device", "power_limit", "torch", "cuda"} <= set(rec)
