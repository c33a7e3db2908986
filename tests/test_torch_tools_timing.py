"""The port's timing tools (``aswstereomatch_torch/tools/profile_stages.py``,
``bench_separable.py``, ``headline_variance.py``,
``warm_on_compute_change.py``) on the CPU at small sizes, against the
reference.

Every rung of profile_stages and every variant of bench_separable must
agree with the reference's jnp ``match_pair`` on the same numpy pair at
the pipeline bar of tests/test_oracle_parity.py:141-143 (|d - d_ref| <=
0.51 on more than 99.5% of pixels, > 2 on fewer than 0.2%); each record
must carry every field of the reference tool's committed record in
``bench_results/``.  profile_stages must fail when a rung does not launch
the kernel it is routed to (the card's routing and launch counting stood
in for by monkeypatching); the warm hook's predicate must be the build's
own, and in a temporary git repository it must spawn one child for a
commit that touches a kernel source and none for a docs commit.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.ops.cuda import build
from aswstereomatch_torch.tools import (bench_separable, common, headline_variance,
                                        profile_stages, warm_on_compute_change as warm)

REPO = Path(__file__).resolve().parents[1]
QUIET = lambda *a, **k: None  # noqa: E731
ENV_KEYS = {"device", "power_limit", "torch", "cuda"}
# profile_stages' "tiny" geometry; bench_separable runs at the same size so
# that the reference's compiled pipelines serve both
H, W, D, R = 48, 64, 8, 4


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread per pytest worker (six workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _ref_fn(cfg: RefConfig):
    return jax.jit(functools.partial(ref_pipeline.match_pair, cfg=cfg.replace(backend="jnp")))


def ref_map(pair, cfg: RefConfig) -> np.ndarray:
    return np.asarray(_ref_fn(cfg)(jnp.asarray(pair["left"]), jnp.asarray(pair["right"])))


def hold(ours: np.ndarray, want: np.ndarray) -> None:
    assert np.mean(np.abs(ours - want) <= 0.51) > 0.995
    assert np.mean(np.abs(ours - want) > 2.0) < 0.002


def committed(name: str):
    with open(REPO / "bench_results" / name) as f:
        return json.load(f)


def _single_thread(fn, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        maps = {}
        return fn(maps=maps, **kw), maps
    finally:
        torch.set_num_threads(threads)


MODES = {"symmetric": {}, "left_only": dict(left_only=True), "box": dict(box=True),
         "symmetric+separable": dict(separable=True)}


@pytest.fixture(scope="module", params=sorted(MODES))
def ladder(request):
    return request.param, _single_thread(profile_stages.run, device="cpu", geometry="tiny",
                                         queue=1, progress=QUIET, **MODES[request.param])


def _ref_config(base: dict, over: dict) -> RefConfig:
    return RefConfig(**base, **over)


def _rungs(mode):
    # every rung of the symmetric ladder; the default rung (+median) of the others
    return [n for n, _ in profile_stages.LADDER] if mode == "symmetric" else ["+median"]


def test_profile_stages_rungs_match_reference(ladder):
    mode, (rec, maps) = ladder
    assert rec["mode"] == mode and rec["geometry"] == "tiny"
    base = profile_stages.base_config("tiny", **MODES[mode])
    pair = ref_synthetic.make_pair(height=H, width=W, max_disparity=D, seed=0)
    over = dict(profile_stages.LADDER)
    for rung in _rungs(mode):
        hold(maps[rung], ref_map(pair, _ref_config(base, over[rung])))


def test_profile_stages_record_fields(ladder):
    _, (rec, _) = ladder
    ref = committed("profile_stages_kitti.json")
    assert [r["rung"] for r in rec["rows"]] == [r["rung"] for r in ref["exact_symmetric"]]
    for row in rec["rows"]:
        assert set().union(*(r.keys() for r in ref["exact_symmetric"])) <= set(row)
        assert row["s_per_pair"] > 0 and row["launches"] == {}  # nothing launches on the CPU
    # the reference's summary line
    assert {"geometry", "mode", "epilogue_share_pct", "pairs_per_s_full"} <= set(rec)
    assert ENV_KEYS <= set(rec) and rec["ok"] and rec["launch_problems"] == []


def test_profile_stages_refuses_box_with_separable():
    with pytest.raises(ValueError, match="separable"):
        profile_stages.run("cpu", "tiny", box=True, separable=True, progress=QUIET)
    with pytest.raises(SystemExit):
        profile_stages.main(["--device", "cpu", "--geometry", "tiny", "--box", "--separable"])


@pytest.fixture
def card_counting(monkeypatch):
    """The card's routing and launch counting on the CPU: routed_kernels
    answers as on the card (kernel_for's kernel), and each kernel wrapper
    counts a launch when the pipeline calls it."""
    kernel_for = pipeline.kernel_for

    def routed(cfg, device):
        k = kernel_for(cfg)
        return [n for n, m in common.KERNELS.items() if m is k]

    monkeypatch.setattr(common, "routed_kernels", routed)
    for name, m in common.KERNELS.items():
        if name == "SGM":
            continue

        def counted(*a, _m=m, _orig=m.wta_outputs, **k):
            _m.launches += 1
            return _orig(*a, **k)

        monkeypatch.setattr(m, "wta_outputs", counted)
    return kernel_for


@pytest.mark.parametrize("mode,kernel", [("symmetric+separable", "K2"), ("box", "K1")])
def test_profile_stages_counts_each_rungs_launches(card_counting, mode, kernel):
    rec = profile_stages.run("cpu", "tiny", queue=3, progress=QUIET, **MODES[mode])
    assert rec["ok"], rec["launch_problems"]
    assert [r["launches"] for r in rec["rows"]] == [{kernel: 3}] * len(profile_stages.LADDER)
    assert {r["compile_source"] for r in rec["rows"]} == {kernel}


def test_profile_stages_fails_when_a_rung_leaves_its_kernel(card_counting, monkeypatch):
    """A rung the pipeline sends to the eager path (here: every median rung)
    while its route names K2 must fail the tool, not be timed as stage cost."""
    kernel_for = card_counting
    monkeypatch.setattr(pipeline, "kernel_for",
                        lambda cfg: None if cfg.median_filter else kernel_for(cfg))
    rec = profile_stages.run("cpu", "tiny", separable=True, queue=2, progress=QUIET)
    assert not rec["ok"]
    assert [p.split(":")[0] for p in rec["launch_problems"]] == ["+median", "+wmedian"]
    assert all("K2 0 (want 2)" in p for p in rec["launch_problems"])
    assert [r["launches"] for r in rec["rows"]][:3] == [{"K2": 2}] * 3


@pytest.fixture(scope="module")
def separable():
    return _single_thread(bench_separable.run, device="cpu", geoms=("kitti",), queue=1,
                          shape=(H, W, D), radius=R, progress=QUIET)


@pytest.mark.parametrize("variant", [v for v, _ in bench_separable.VARIANTS])
def test_bench_separable_variant_matches_reference(separable, variant):
    rec, maps = separable
    over = dict(bench_separable.VARIANTS)[variant]
    sem = {k: v for k, v in over.items() if k in ("asw_symmetric", "asw_separable")}
    cfg = RefConfig(max_disparity=D, cost="tad_grad", aggregation="asw", window_radius=R,
                    lr_check=True, fill_holes=True, subpixel=True, median_filter=True, **sem)
    seed = 3 + ref_synthetic._SCENE_SEED_OFFSET.get("kitti", 0)
    pair = ref_synthetic.make_pair(height=H, width=W, max_disparity=D, seed=seed)
    hold(maps[("kitti", variant)], ref_map(pair, cfg))
    row = next(r for r in rec["rows"] if r["variant"] == variant)
    assert row["reference_variant"] == bench_separable.REFERENCE_NAMES.get(variant, variant)


def test_bench_separable_record_fields(separable):
    rec, maps = separable
    ref = committed("separable_ab.json")
    timed = set().union(*(r.keys() for r in ref if "bad_2" in r))
    vs = set().union(*(r.keys() for r in ref if "agree_sixteenth_px" in r))
    rows = rec["rows"]
    assert [r["variant"] for r in rows] == [v for v, _ in bench_separable.VARIANTS] + [
        "sep_sym_kernel_vs_eager", "sep_lo_kernel_vs_eager"]
    for row in rows[:6]:
        assert timed <= set(row)
    for row in rows[6:]:
        assert vs <= set(row)
        # the kernel route's plain version against the eager path on the CPU
        mode = row["variant"].split("_")[1]
        a, b = maps[("kitti", f"sep_{mode}_kernel")], maps[("kitti", f"sep_{mode}_eager")]
        assert row["max_abs_delta"] == round(float(np.abs(a - b).max()), 6)
        assert row["agree_sixteenth_px"] > 0.995
    assert ENV_KEYS <= set(rec) and rec["checks"] == [] and not rec["held_to_records"]


def test_bench_separable_holds_full_rows_to_the_record():
    """The hold at full size: the reference's own rows pass, a row 0.01 off
    in bad-2.0 does not."""
    ref = [r for r in committed("separable_ab.json") if "bad_2" in r]
    ours = [dict(r, variant=v, reference_variant=r["variant"])
            for r in ref for v in [next((k for k, n in bench_separable.REFERENCE_NAMES.items()
                                         if n == r["variant"]), r["variant"])]]
    key = lambda x: (x["geometry"], x.get("reference_variant", x["variant"]))  # noqa: E731
    checks = common.hold(ours, ref, key, bench_separable.BARS, "separable_ab.json")
    assert len(checks) == 2 * len(ref) and all(c["ok"] for c in checks)
    ours[0] = dict(ours[0], bad_2=ours[0]["bad_2"] + 0.01)
    assert not all(c["ok"] for c in common.hold(ours, ref, key, bench_separable.BARS, "x"))


@pytest.fixture(scope="module")
def variance():
    """Two CLI sessions at the smallest scene geometry, each child on one
    thread (six pytest workers share the cores)."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rec, _ = _single_thread(
            lambda maps: headline_variance.run("cpu", sessions=2, chain=1, dataset="tsukuba",
                                               max_disparity=D, radius=2, iters=1,
                                               progress=QUIET))
        return rec
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def test_headline_variance_record_fields(variance):
    rec = variance
    ref = committed("headline_variance.json")
    assert set(ref) <= set(rec) and ENV_KEYS <= set(rec)
    assert set(ref["device_time"]) <= set(rec["device_time"])
    for row in rec["sessions"]:
        assert set(ref["sessions"][0]) <= set(row)
        assert row["device"] == "cpu" and 0 < row["best_s"] <= row["mean_s"]
    assert rec["device_time"]["chain"] == 2


def test_headline_variance_cpu_has_no_device_time(variance):
    """No card, no device time: the CPU run says so instead of a number."""
    rec = variance
    assert rec["device_time"]["device_s_per_pair"] is None
    assert rec["dispatch_overhead_s_per_pair"] is None
    lo, hi = rec["mean_spread_s"]
    assert lo <= rec["median_mean_s"] <= hi and rec["device_time"]["wall_s_per_pair"] > 0


def test_headline_variance_chain_is_the_pipeline():
    """Each pair of the chain computes match_pair's map (the epsilon is zero)."""
    pair = ref_synthetic.make_pair(height=H, width=W, max_disparity=D, seed=0)
    l, r = common.to_device(pair, "cpu")
    cfg = headline_variance._config(D, 2)
    want = pipeline.match_pair(l, r, cfg)
    assert torch.equal(headline_variance._chain(l, r, cfg, 2), want)


@pytest.mark.parametrize("tool", [profile_stages, bench_separable, headline_variance])
def test_timing_tools_refuse_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


def test_warm_predicate_is_the_builds():
    """Over every file of the tree, the hook warms exactly for the files
    whose bytes make the build key, and for build.py (its flags)."""
    tree = list(REPO.glob("*")) + list((REPO / "aswstereomatch_torch").rglob("*"))
    files = [str(p.relative_to(REPO)) for p in tree if p.is_file()]
    keyed = {str(p.relative_to(REPO)) for p in build.keyed_files()}
    assert {str(p.relative_to(REPO)) for p in build._sources()} <= keyed
    assert {f for f in files if warm.changes_build(f)} == keyed | {
        "aswstereomatch_torch/ops/cuda/build.py"}
    # a deleted source changes the library too
    assert warm.changes_build("aswstereomatch_torch/ops/cuda/gone_kernel.cu")
    assert not warm.changes_build("aswstereomatch_torch/ops/cuda/asw_kernel.py")


def _git(repo, *args):
    subprocess.run(["git", *args], cwd=repo, check=True, capture_output=True, timeout=60)


def test_warm_hook_spawns_for_a_kernel_commit_only(tmp_path, monkeypatch):
    repo = tmp_path / "repo"
    src = repo / "aswstereomatch_torch" / "ops" / "cuda"
    src.mkdir(parents=True)
    _git(repo, "init", "-q")
    _git(repo, "config", "user.email", "t@example.com")
    _git(repo, "config", "user.name", "t")
    (src / "asw_kernel.cu").write_text("// v1\n")
    (repo / "README.md").write_text("v1\n")
    _git(repo, "add", "-A")
    _git(repo, "commit", "-q", "-m", "one")
    spawned = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            spawned.append(cmd)
            self.pid = 4242

    def hook_on_head():
        paths = warm.changed_paths(repo)
        with monkeypatch.context() as m:  # git itself runs through the real Popen
            m.setattr(warm.subprocess, "Popen", FakePopen)
            return paths, warm.hook(paths, results)

    results = tmp_path / "results"
    (repo / "README.md").write_text("v2\n")
    _git(repo, "commit", "-q", "-am", "docs")
    paths, child = hook_on_head()
    assert paths == ["README.md"] and child is None and spawned == []
    (src / "asw_kernel.cu").write_text("// v2\n")
    _git(repo, "commit", "-q", "-am", "kernel")
    paths, child = hook_on_head()
    assert paths == ["aswstereomatch_torch/ops/cuda/asw_kernel.cu"]
    assert child is not None and len(spawned) == 1
    assert spawned[0][1:] == ["-m", warm.MODULE, "--build"]
    assert (results / "warm_cache.pid").read_text() == "4242"
    log = (results / "warm_hook.log").read_text().splitlines()
    assert "no warm needed" in log[0] and "spawned warm child pid 4242" in log[1]


def test_warm_hook_starts_no_second_child(tmp_path, monkeypatch):
    """While the pid file names a live warm child, the hook spawns none."""
    spawned = []
    live = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)", warm.MODULE])
    try:
        (tmp_path / "warm_cache.pid").write_text(str(live.pid))
        with monkeypatch.context() as m:
            m.setattr(warm.subprocess, "Popen", lambda cmd, **kw: spawned.append(cmd))
            assert warm.hook(["aswstereomatch_torch/ops/cuda/asw_kernel.cu"], tmp_path) is None
    finally:
        live.kill()
        live.wait(timeout=30)
    assert spawned == []
    assert "already live" in (tmp_path / "warm_hook.log").read_text()


def test_warm_child_reports_the_builds_error(monkeypatch, capsys):
    """Without nvcc the child prints the build's own error and exits 1."""
    def fail():
        raise build.BuildError("compiler not found: nvcc")

    monkeypatch.setattr(build, "load", fail)
    assert warm.main(["--build"]) == 1
    assert "build failed: compiler not found: nvcc" in capsys.readouterr().out


def test_warm_install_writes_an_executable_hook(tmp_path):
    path = warm.install(tmp_path)
    assert path == tmp_path / ".git" / "hooks" / "post-commit"
    assert path.stat().st_mode & 0o111 and warm.MODULE in path.read_text()
