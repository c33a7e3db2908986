"""The port's host data path held against the reference's, on the CPU.

``aswstereomatch_torch.utils`` io / native / manifest / devlock / synthetic /
profiling against ``aswstereomatch_tpu.utils``: written bytes identical,
read arrays equal, the same resume and lock semantics.  The native-codec
tests skip only where the port cannot build its codec (no g++ or zlib).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from aswstereomatch_tpu.utils import devlock as ref_devlock
from aswstereomatch_tpu.utils import evaluate as ref_evaluate
from aswstereomatch_tpu.utils import io as ref_io
from aswstereomatch_tpu.utils import manifest as ref_manifest
from aswstereomatch_tpu.utils import native as ref_native
from aswstereomatch_tpu.utils import synthetic as ref_synthetic

from aswstereomatch_torch.utils import devlock, io, manifest, native, profiling, synthetic


def _need_native():
    if not native.available():
        pytest.skip(f"the port's native codec did not build: {native.build_error()}")
    if not ref_native.available():
        pytest.skip("the reference's native codec did not build")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _gray(seed, shape=(13, 17), hi=255):
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(0, hi, shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# io: PNM, PFM, GT scalings, the front door, the disparity writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_pgm_write_and_read_match_reference(tmp_path, seed):
    img = _gray(seed) + np.float32(0.4)  # write_pgm rounds and clips
    img[0, 0], img[0, 1] = -5.0, 300.0
    a, b = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    io.write_pgm(a, img)
    ref_io.write_pgm(b, img)
    assert _bytes(a) == _bytes(b)
    np.testing.assert_array_equal(io.read_pnm(a), ref_io.read_pnm(b))


def test_ppm_with_comment_matches_reference(tmp_path):
    img = _gray(2, (9, 11, 3)).astype(np.uint8)
    p = str(tmp_path / "c.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# comment\n11 9\n255\n" + img.tobytes())
    got = io.read_pnm(p)
    np.testing.assert_array_equal(got, ref_io.read_pnm(p))
    assert got.shape == (9, 11, 3) and got.dtype == np.float32


def test_pnm_16bit_and_bad_magic_match_reference(tmp_path):
    arr = (np.arange(12) * 1000).astype(">u2").reshape(3, 4)
    p = str(tmp_path / "x.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n4 3\n65535\n" + arr.tobytes())
    np.testing.assert_array_equal(io.read_pnm(p), ref_io.read_pnm(p))
    assert io.read_pnm(p).max() == 11000.0
    bad = str(tmp_path / "bad.pgm")
    with open(bad, "wb") as f:
        f.write(b"P2\n1 1\n255\n0")
    for mod in (io, ref_io):
        with pytest.raises(ValueError, match="unsupported PNM magic"):
            mod.read_pnm(bad)


@pytest.mark.parametrize("shape", [(21, 34), (5, 7, 3)])
def test_pfm_write_and_read_match_reference(tmp_path, shape):
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 64, shape).astype(np.float32)
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    io.write_pfm(a, img)
    ref_io.write_pfm(b, img)
    assert _bytes(a) == _bytes(b)
    np.testing.assert_array_equal(io.read_pfm(a), img)
    np.testing.assert_array_equal(io.read_pfm(a), ref_io.read_pfm(b))


def test_pfm_big_endian_and_bad_magic(tmp_path):
    img = np.arange(6, dtype=np.float32).reshape(2, 3)
    p = str(tmp_path / "be.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\n3 2\n1.0\n" + img[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(io.read_pfm(p), ref_io.read_pfm(p))
    np.testing.assert_array_equal(io.read_pfm(p), img)
    with open(p, "wb") as f:
        f.write(b"P5\n")
    with pytest.raises(ValueError, match="not a PFM"):
        io.read_pfm(p)


@pytest.mark.parametrize("dataset", sorted(io.GT_SCALES))
def test_gt_scalings_match_reference(tmp_path, dataset):
    assert io.GT_SCALES == ref_io.GT_SCALES
    disp = np.array([[1.0, 2.5], [0.0, 4.0]], np.float32)
    p = str(tmp_path / "gt.pfm")
    io.write_pfm(p, disp * io.GT_SCALES[dataset])
    got, valid = io.read_gt_disparity(p, dataset)
    want, want_valid = ref_io.read_gt_disparity(p, dataset)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(got, disp, atol=1e-6)
    if dataset == "kitti":
        assert valid.tolist() == [[True, True], [False, True]]
    else:
        assert valid.all()


def test_gt_scaling_unknown_dataset_and_missing_file(tmp_path):
    p = str(tmp_path / "gt.pfm")
    io.write_pfm(p, np.ones((2, 2), np.float32))
    with pytest.raises(KeyError, match="unknown dataset"):
        io.read_gt_disparity(p, "nonsense")
    with pytest.raises(FileNotFoundError):
        io.read_image(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("ext", [".pgm", ".png"])
def test_save_disparity_png_matches_reference(tmp_path, ext):
    if ext == ".png":
        _need_native()
    rng = np.random.default_rng(4)
    disp = rng.uniform(-1, 20, (19, 23)).astype(np.float32)
    a, b = tmp_path / "port", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    io.save_disparity_png(str(a / f"d{ext}"), disp, 16)
    ref_io.save_disparity_png(str(b / f"d{ext}"), disp, 16)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [f"d{ext}"]
    assert _bytes(a / f"d{ext}") == _bytes(b / f"d{ext}")
    np.testing.assert_array_equal(io.read_image(str(a / f"d{ext}")),
                                  ref_io.read_image(str(b / f"d{ext}")))


def test_save_disparity_gt_png_matches_reference(tmp_path):
    _need_native()
    rng = np.random.default_rng(5)
    disp = np.round(rng.uniform(0, 100, (11, 29)) * 256) / 256
    disp[3, :5] = 0.0  # invalid
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    io.save_disparity_gt_png(a, disp)
    ref_io.save_disparity_gt_png(b, disp)
    assert _bytes(a) == _bytes(b)
    got, valid = io.read_gt_disparity(a, "kitti")
    np.testing.assert_array_equal(got, disp.astype(np.float32))
    np.testing.assert_array_equal(valid, disp > 0)


# ---------------------------------------------------------------------------
# native: the port's own build of native/stereoio.cpp vs the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["gray8", "rgb8", "gray16"])
def test_native_png_matches_reference(tmp_path, case):
    _need_native()
    shape, hi, depth = {"gray8": ((13, 17), 255, 8), "rgb8": ((9, 14, 3), 255, 8),
                        "gray16": ((12, 10), 65535, 16)}[case]
    img = _gray(6, shape, hi)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    native.write_png(a, img, bit_depth=depth)
    ref_native.write_png(b, img, bit_depth=depth)
    assert _bytes(a) == _bytes(b)
    np.testing.assert_array_equal(native.read_png(a), img)
    np.testing.assert_array_equal(native.read_png(a), ref_native.read_png(b))


def test_native_png_rejects_what_the_reference_rejects(tmp_path):
    _need_native()
    with pytest.raises(ValueError, match="bit_depth=8"):
        native.write_png(str(tmp_path / "x.png"), _gray(0, (4, 4, 3)), bit_depth=16)
    with pytest.raises(ValueError, match="unsupported image shape"):
        native.write_png(str(tmp_path / "x.png"), _gray(0, (4, 4, 2)))
    with pytest.raises(IOError):
        native.read_png(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("shape", [(13, 17), (9, 11, 3)])
def test_native_pnm_and_pfm_match_reference(tmp_path, shape):
    _need_native()
    img = _gray(7, shape)
    p = str(tmp_path / ("x.pgm" if len(shape) == 2 else "x.ppm"))
    arr = img.astype(np.uint8)
    with open(p, "wb") as f:
        f.write(b"%s\n%d %d\n255\n" % (b"P5" if len(shape) == 2 else b"P6", shape[1], shape[0]))
        f.write(arr.tobytes())
    np.testing.assert_array_equal(native.read_pnm(p), ref_native.read_pnm(p))
    np.testing.assert_array_equal(native.read_pnm(p), io.read_pnm(p))
    pf = str(tmp_path / "x.pfm")
    io.write_pfm(pf, img / 7.0)
    np.testing.assert_array_equal(native.read_pfm(pf), ref_native.read_pfm(pf))
    np.testing.assert_array_equal(native.read_pfm(pf), io.read_pfm(pf))


def test_native_write_pgm_matches_reference(tmp_path):
    _need_native()
    img = _gray(8)
    a, b = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    native.write_pgm(a, img)
    ref_native.write_pgm(b, img)
    assert _bytes(a) == _bytes(b)
    np.testing.assert_array_equal(io.read_pnm(a), img)


@pytest.mark.parametrize("masked", [False, True])
def test_native_bad_delta_and_epe_match_reference(masked):
    _need_native()
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 32, (40, 50)).astype(np.float32)
    b = a + rng.normal(0, 2, a.shape).astype(np.float32)
    valid = rng.random(a.shape) > 0.3 if masked else None
    for delta in (0.5, 1.0, 2.0):
        assert native.bad_delta(a, b, delta, valid) == ref_native.bad_delta(a, b, delta, valid)
        assert abs(native.bad_delta(a, b, delta, valid)
                   - ref_evaluate.bad_delta(a, b, delta, valid)) < 1e-9
    assert native.epe(a, b, valid) == ref_native.epe(a, b, valid)
    with pytest.raises(ValueError, match="size mismatch"):
        native.epe(a, b[:3])


def test_native_builds_once_across_threads(tmp_path, monkeypatch):
    """Concurrent first users publish one build by atomic rename; a missing
    compiler makes the codec unavailable with the reason kept."""
    if native.build_error() is not None and "No such file" in native.build_error():
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.library_path())
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(paths)) == 1 and paths[0].exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].parent.name]

    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "nocompiler")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    assert "no-such-compiler" in native.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.read_pnm("x.pgm")


# ---------------------------------------------------------------------------
# manifest: resume, flush before raise, the submit-ahead window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [manifest, ref_manifest], ids=["port", "reference"])
def test_manifest_resume_and_flush_on_raise(tmp_path, mod):
    path = str(tmp_path / "sweep.json")
    calls = []

    def work(pid):
        calls.append(pid)
        if pid == "c" and len(calls) <= 3:
            raise RuntimeError("simulated failure")
        return {"bad_2": 0.01}

    with pytest.raises(RuntimeError):
        mod.run_sweep(["a", "b", "c", "d"], work, path, "cfg1")
    assert calls == ["a", "b", "c"]
    # flushed before the raise: a and b are on disk
    with open(path) as f:
        assert sorted(json.load(f)["done"]) == ["a", "b"]
    results = mod.run_sweep(["a", "b", "c", "d"], work, path, "cfg1")
    assert calls == ["a", "b", "c", "c", "d"]
    assert set(results) == {"a", "b", "c", "d"}
    m2 = mod.SweepManifest(path, "cfg2")  # another config starts afresh
    assert m2.pending(["a", "b"]) == ["a", "b"]


def test_manifest_files_equal_reference(tmp_path):
    work = lambda pid: {"id": pid, "bad_2": 0.5}  # noqa: E731
    ids = ["p0", "p1", "p2"]
    manifest.run_sweep(ids, work, str(tmp_path / "a.json"), "h", flush_every=2)
    ref_manifest.run_sweep(ids, work, str(tmp_path / "b.json"), "h", flush_every=2)
    assert _bytes(tmp_path / "a.json") == _bytes(tmp_path / "b.json")
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


@pytest.mark.parametrize("pass_next", [True, 2, 4])
def test_manifest_pass_next_window_matches_reference(tmp_path, pass_next):
    ids = [f"p{i}" for i in range(6)]
    seen = {}
    for mod in (manifest, ref_manifest):
        got = []

        def work(pid, next_pids=()):
            got.append((pid, tuple(next_pids)))
            return {}

        mod.run_sweep(ids, work, str(tmp_path / f"{mod.__name__}.json"), "h",
                      pass_next=pass_next)
        seen[mod] = got
    assert seen[manifest] == seen[ref_manifest]
    depth = int(pass_next)
    assert seen[manifest][0] == ("p0", tuple(ids[1:1 + depth]))
    assert seen[manifest][-1] == ("p5", ())


# ---------------------------------------------------------------------------
# devlock
# ---------------------------------------------------------------------------

def test_device_lock_exclusion_and_holder(tmp_path, monkeypatch):
    monkeypatch.setenv("ASW_DEVICE_LOCK", str(tmp_path / "dev.lock"))
    with devlock.device_lock("first"):
        info = devlock.holder_info()
        assert info["pid"] == os.getpid() and info["label"] == "first"
        # the reference's reader sees the same holder in the same file
        assert ref_devlock.holder_info() == info
        # flock is per open file: a second acquire in this process contends
        # like another process would, and the error names the holder
        with pytest.raises(TimeoutError, match="first"):
            with devlock.device_lock("second", timeout_s=0.2, poll_s=0.05):
                pass
        with pytest.raises(TimeoutError, match="CUDA device held by"):
            with devlock.device_lock("third", timeout_s=0):
                pass
    with devlock.device_lock("fourth", timeout_s=0):
        assert devlock.holder_info()["label"] == "fourth"


def test_device_lock_stale_holder_pid(tmp_path, monkeypatch):
    lock = tmp_path / "dev.lock"
    monkeypatch.setenv("ASW_DEVICE_LOCK", str(lock))
    # a dead holder leaves contents but no flock: acquire at once, and
    # holder_info reports nobody
    lock.write_text(json.dumps({"pid": 2 ** 22 + 1234, "label": "ghost"}))
    assert devlock.holder_info() is None
    with devlock.device_lock("taker", timeout_s=0):
        assert devlock.holder_info()["label"] == "taker"


def test_device_lock_default_path_names_the_card(tmp_path, monkeypatch):
    monkeypatch.delenv("ASW_DEVICE_LOCK", raising=False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    assert devlock.lock_path() == str(tmp_path / "asw_cuda_device.lock")
    assert "tpu" not in devlock.lock_path()


# ---------------------------------------------------------------------------
# synthetic geometries
# ---------------------------------------------------------------------------

def test_geometries_match_reference():
    assert synthetic.GEOMETRIES == ref_synthetic.GEOMETRIES
    assert synthetic._SCENE_SEED_OFFSET == ref_synthetic._SCENE_SEED_OFFSET


def _assert_pairs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name,seed", [("tsukuba", 0), ("teddy", 3), ("cones", 3),
                                       ("venus", 7)])
def test_make_dataset_pair_matches_reference(name, seed):
    _assert_pairs_equal(synthetic.make_dataset_pair(name, seed=seed),
                        ref_synthetic.make_dataset_pair(name, seed=seed))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_make_slanted_pair_matches_reference(seed):
    kw = dict(height=40, width=56, max_disparity=12, seed=seed)
    _assert_pairs_equal(synthetic.make_slanted_pair(**kw),
                        ref_synthetic.make_slanted_pair(**kw))


# ---------------------------------------------------------------------------
# profiling helpers
# ---------------------------------------------------------------------------

def test_profiler_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        x = torch.ones((8, 8)) * 2
    profiling.force_sync({"a": x, "b": (x, [x])})
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with profiling.trace(None):  # no-op mode
        pass


def test_time_fn_returns_best_mean_and_output():
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2 + 1

    best, mean, out = profiling.time_fn(fn, torch.ones((16, 16)), iters=3, warmup=1)
    assert 0 < best <= mean and len(calls) == 4
    assert torch.equal(out, torch.full((16, 16), 3.0))
