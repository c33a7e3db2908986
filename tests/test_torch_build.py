"""``ops/cuda/build.py::load`` on the CPU: threads that call it together
(a daemon's first requests) build and load the kernels' library once."""

import sys
import threading
import time

from aswstereomatch_torch.ops.cuda import build


def test_concurrent_first_loads_build_once(tmp_path, monkeypatch):
    builds, loads = [], []

    def fake_library_path():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a build is slow: let the other threads arrive
        return tmp_path / build.LIB_NAME

    monkeypatch.setattr(build, "_loaded", None)
    monkeypatch.setattr(build, "library_path", fake_library_path)
    monkeypatch.setattr(build.torch.ops, "load_library", loads.append)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got = []
    try:
        start = threading.Barrier(8)

        def first_request():
            start.wait(timeout=30)
            got.append(build.load())

        threads = [threading.Thread(target=first_request) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loads == [str(tmp_path / build.LIB_NAME)]
    assert got == [tmp_path / build.LIB_NAME] * 8
    assert build.load() == tmp_path / build.LIB_NAME and len(builds) == 1
