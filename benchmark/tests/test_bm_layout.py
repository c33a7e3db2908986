"""BENCHMARK.json against the benchmark's contract, and every piece it names
found by name under benchmark/."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    spec = harness.resolve(BENCH, workload)
    conf, mix = spec["config"], spec["traffic"]
    assert conf["name"] == spec["cell"]["config"]
    assert (harness.BENCH_DIR / "traffic" / f"{mix['kind']}.py").exists()
    assert (harness.BENCH_DIR / "reference" / f"{conf['reference']}.py").exists()
    assert harness.runner(mix["kind"]).run
    answer_form = "float32" if mix["kind"] == "stream" else mix["response_dtype"]
    assert conf["limits"][answer_form]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert {"setup_s", "pairs_per_s", "latency_p50_ms", "latency_p95_ms"} <= set(names)
    assert spec["per_layer"]
    for name in names:
        if name != "setup_s":
            assert callable(harness.metric_reader(name).read)


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("benchmark/") for f in files)
