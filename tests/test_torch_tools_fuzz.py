"""The port's fuzz tools (``aswstereomatch_torch/tools/card_fuzz.py``,
``tools/fuzz_pipeline.py``) against the reference's ``tools/tpu_fuzz.py``
and ``tools/fuzz_pipeline.py`` on the CPU, and what every tool of the
port shares.

The reference's draws are captured by running its loops with the heavy
calls replaced by recorders (``pipeline._resolve_backend`` answers "jnp",
so every general trial skips; ``dshard.shard_wta_outputs`` raises after
recording; ``jax.jit`` is the identity), so nothing is compiled or run.
A few trials then run on the CPU, where the kernel route runs each
kernel's plain version.
"""

import dataclasses
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.parallel import dshard as ref_dshard
from aswstereomatch_tpu.parallel import tiling as ref_tiling
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.config import StereoConfig
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.tools import card_fuzz, common, fuzz_pipeline
from aswstereomatch_torch.utils import convert

REPO = Path(__file__).resolve().parents[1]
TOOLS = ["card_fuzz", "fuzz_pipeline", "flagship_sharded_check", "run_baseline_configs",
         "pin_sep_accuracy", "sym_vs_leftonly", "compare_opencv", "refuse_curve",
         "dataset_roundtrip"]


def ref_tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def ref_tpu_fuzz_draws():
    """(general, d-window) draws of the reference's tpu_fuzz at its
    defaults: seeds 5000-5023 and 105000-105005."""
    mod = ref_tool("tpu_fuzz")
    general, dwindow, pairs = [], [], []
    mp = pytest.MonkeyPatch()

    def make_pair(**kw):
        pairs.append(kw)
        z = np.zeros((kw["height"], kw["width"], 3), np.float32)
        return {"left": z, "right": z}

    def resolve(cfg, shape):
        general.append((cfg, tuple(shape), pairs[-1]["seed"]))
        return "jnp"

    def shard(left, right, cfg, k, n):
        dwindow.append((cfg, tuple(left.shape[:2]), pairs[-1]["seed"], k, n))
        raise RuntimeError("recorded")

    try:
        mp.setattr(ref_synthetic, "make_pair", make_pair)
        mp.setattr(ref_pipeline, "_resolve_backend", resolve)
        mp.setattr(ref_dshard, "shard_wta_outputs", shard)
        mp.setattr(jax, "jit", lambda fn, **kw: fn)
        mp.setattr(sys, "argv", ["tpu_fuzz.py", "--trials", "24", "--dwindow-trials", "6",
                                 "--seed0", "5000"])
        mod.main()
    finally:
        mp.undo()
    return general, dwindow


def test_card_fuzz_draws_equal_reference(ref_tpu_fuzz_draws):
    general, _ = ref_tpu_fuzz_draws
    assert len(general) == 24
    for t, (ref_cfg, shape, pseed) in enumerate(general):
        cfg, hw, seed = card_fuzz.draw_trial(5000 + t)
        assert fields(cfg) == fields(ref_cfg), t
        assert (hw, seed) == (shape, pseed), t


def test_card_fuzz_dwindow_draws_equal_reference(ref_tpu_fuzz_draws):
    _, dwindow = ref_tpu_fuzz_draws
    assert len(dwindow) == 6
    for t, (ref_cfg, shape, pseed, k, n) in enumerate(dwindow):
        cfg, hw, seed, k_, n_ = card_fuzz.draw_dwindow_trial(105000 + t)
        assert fields(cfg) == fields(ref_cfg), t
        assert (hw, seed, k_, n_) == (shape, pseed, k, n), t


def test_fuzz_pipeline_draws_equal_reference():
    """Seeds 1000-1011: the reference's config (its "pallas" backend is the
    port's "cuda") and geometry, from the first match_pair of each trial."""
    mod = ref_tool("fuzz_pipeline")
    trials = []
    mp = pytest.MonkeyPatch()
    real_make_pair = ref_synthetic.make_pair

    def make_pair(**kw):
        trials.append({"hw": (kw["height"], kw["width"]), "cfg": None})
        return real_make_pair(**kw)

    def match_pair(left, right, cfg):
        if trials[-1]["cfg"] is None:
            trials[-1]["cfg"] = cfg
        return jax.numpy.zeros(left.shape[:2], jax.numpy.float32)

    zeros = lambda left, right, cfg, device_mesh: jax.numpy.zeros(  # noqa: E731
        left.shape[:2], jax.numpy.float32)
    try:
        mp.setattr(ref_synthetic, "make_pair", make_pair)
        mp.setattr(ref_pipeline, "match_pair", match_pair)
        mp.setattr(ref_pipeline, "match_batch",
                   lambda l, r, cfg: jax.numpy.zeros(l.shape[:3], jax.numpy.float32))
        mp.setattr(ref_tiling, "match_pair_tiled", zeros)
        mp.setattr(ref_dshard, "match_pair_dsharded", zeros)
        mp.setattr(jax, "jit", lambda fn, **kw: fn)
        mp.setattr(jax.config, "update", lambda *a: None)
        mp.setattr(sys, "argv", ["fuzz_pipeline.py", "--trials", "12", "--seed0", "1000"])
        assert mod.main() == 0
    finally:
        mp.undo()
    assert len(trials) == 12
    for t, rec in enumerate(trials):
        cfg, hw, _ = fuzz_pipeline.draw_trial(1000 + t)
        assert fields(cfg) == fields(convert.from_reference(fields(rec["cfg"]))), t
        assert hw == rec["hw"], t


@pytest.fixture
def kernel_calls(monkeypatch):
    """Every kernel-route call of the pipeline (``_kernel_wta``), by the
    kernel that served it."""
    calls = []
    real = pipeline._kernel_wta

    def spy(left, right, cfg):
        calls.append(pipeline.kernel_for(cfg))
        return real(left, right, cfg)

    monkeypatch.setattr(pipeline, "_kernel_wta", spy)
    return calls


@pytest.mark.parametrize("seed,kernel", [(5001, "K2"), (5004, "K3"), (5003, "K1")])
def test_card_fuzz_trial_on_cpu(seed, kernel, kernel_calls):
    """A trial of the tool's default draws on the CPU: the kernel route
    (its wrapper's plain version) against the eager path, no launches."""
    with common.kernel_route("cpu"):
        row = card_fuzz.run_trial(seed, "cpu")
    assert row["status"] == "ok", row["line"]
    assert row["kernel"] == kernel
    assert kernel_calls == [common.KERNELS[kernel]]
    assert row["agree"] > 0.99 and row["gross"] < 0.005
    assert row["launches"] == row["predicted_launches"] == dict.fromkeys(common.KERNELS, 0)


def test_card_fuzz_run_on_cpu():
    """``run`` with one general and one d-window trial: the record's
    fields and no failures."""
    rec = card_fuzz.run("cpu", trials=1, dwindow_trials=1, seed0=5003,
                        progress=lambda *a: None)
    assert rec["failures"] == 0 and rec["ok"] == 2
    dw = rec["rows"][1]
    assert dw["agree"] > 0.995 and dw["ragree"] > 0.995 and dw["cerr"] < 1e-2
    assert {"trials_requested", "dwindow_trials", "failures", "wall_s", "lines", "device",
            "power_limit", "torch", "cuda"} <= set(rec)


@pytest.mark.parametrize("t,seed,checks", [
    (0, 1000, ["kernel~eager", "y2", "batch", "d4"]),
    (1, 1001, ["kernel~eager", "y2", "d4"]),
])
def test_fuzz_pipeline_trial_on_cpu(t, seed, checks, kernel_calls):
    with common.kernel_route("cpu"):
        row = fuzz_pipeline.run_trial(t, seed, "cpu")
    assert row["status"] == "ok", row["line"]
    assert row["checks"] == checks
    assert kernel_calls, "the kernel route did not run"


_CFG = StereoConfig(max_disparity=16, window_radius=4)
LAUNCH_CASES = [
    (_CFG, "K1"),
    (_CFG.replace(aggregation="box"), "K1"),
    (_CFG.replace(aggregation="box", max_disparity=128), "K3"),
    (_CFG.replace(asw_symmetric=False), "K3"),
    (_CFG.replace(kernel_layout="dlanes"), "K4"),
    (_CFG.replace(asw_separable=True), "K2"),
    (_CFG.replace(aggregation="sgm"), "SGM"),
    (_CFG.replace(backend="eager"), None),
    (_CFG.replace(aggregation="none"), None),
    (_CFG.replace(asw_separable=True, kernel_layout="xlanes"), None),
]


@pytest.mark.parametrize("cfg,name", LAUNCH_CASES)
def test_predicted_launches_follow_kernel_for(cfg, name):
    """On the card one match_pair launches the kernel kernel_for names
    (SGM's scan kernel on the eager path), once; off the card none."""
    card = torch.device("cuda", 0)
    want = {k: int(k == name) for k in common.KERNELS}
    assert common.predicted_launches(cfg, card) == want
    assert common.predicted_launches(cfg, card, calls=3) == {k: 3 * v for k, v in want.items()}
    if name not in (None, "SGM"):
        assert common.KERNELS[name] is pipeline.kernel_for(cfg)
    assert common.predicted_launches(cfg, "cpu") == dict.fromkeys(common.KERNELS, 0)


@pytest.mark.parametrize("name", TOOLS)
def test_main_raises_without_cuda(name, tmp_path, monkeypatch):
    """No tool carries on on the CPU unless asked: ``--device cuda`` (the
    default) raises where no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"aswstereomatch_torch.tools.{name}")
    argv = ["--out", str(tmp_path / "r.json")] + (["--no-cv2"] if name in (
        "compare_opencv", "refuse_curve") else [])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mod.main(argv)
    assert not (tmp_path / "r.json").exists()


def test_tools_import_neither_jax_nor_cv2():
    """Importing every tool loads neither jax, the reference package, the
    repository's tools/ nor cv2."""
    code = (
        "import importlib, sys\n"
        f"for name in {TOOLS + ['common']!r}:\n"
        "    importlib.import_module('aswstereomatch_torch.tools.' + name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'aswstereomatch_tpu', 'cv2', 'tools')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
