"""Build the port's CUDA kernels from the sources in this directory.

``load()`` compiles ``*.cu`` with ``nvcc`` for ``sm_90a`` (Hopper) and
``*.cpp`` with the host C++ compiler against PyTorch's headers, one process
per source, all started together; then it links one shared library and
loads it with ``torch.ops.load_library``, which registers
``torch.ops.asw_torch.*``.  The library is kept under ``_build/`` (listed in
.gitignore), keyed by a hash of the sources and headers (``*.cuh``), the
PyTorch version and the flags, so editing a source rebuilds it and a second
process reuses it.  The kernel sources carry a plain C interface and do not
include PyTorch's headers, so nvcc takes seconds; only the small binding
file includes them.

A build or load failure raises ``BuildError`` with the compiler's output.
Nothing catches it to carry on without the kernel.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_ROOT = SRC_DIR / "_build"
LIB_NAME = "libasw_torch.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC"]


class BuildError(RuntimeError):
    pass


# What the build compiles and what it includes; both are hashed into the key.
SOURCE_GLOBS = ("*.cu", "*.cpp")
HEADER_GLOBS = ("*.cuh",)


def _glob(patterns) -> list[Path]:
    return [p for pattern in patterns for p in sorted(SRC_DIR.glob(pattern))]


def _sources() -> list[Path]:
    return _glob(SOURCE_GLOBS)


def keyed_files() -> list[Path]:
    """The files whose bytes make the build key: the sources and headers."""
    return _glob(SOURCE_GLOBS + HEADER_GLOBS)


def changes_build(path) -> bool:
    """Whether a change to ``path`` (present or deleted) changes the built
    library: a file of this directory that ``keyed_files`` would take, or
    this module, which holds the flags."""
    path = Path(path).resolve()
    if path == Path(__file__).resolve():
        return True
    return path.parent == SRC_DIR and any(path.match(g) for g in SOURCE_GLOBS + HEADER_GLOBS)


def _cuda_home() -> Path:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            return Path(os.environ[var])
    nvcc = shutil.which("nvcc")
    if nvcc:
        return Path(nvcc).resolve().parent.parent
    return Path("/usr/local/cuda")


def _build_key() -> str:
    h = hashlib.sha256()
    for src in keyed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(torch.__version__.encode())
    h.update(" ".join(NVCC_FLAGS + CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]], log: list[str]) -> None:
    """Run the commands concurrently; raise on the first that failed, after
    every one has ended."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    except FileNotFoundError as e:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise BuildError(f"compiler not found: {e}") from e
    failed = None
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append("$ " + " ".join(cmd))
        log.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"command failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
    if failed is not None:
        raise BuildError(failed)


def _compile(out: Path) -> list[str]:
    """Compile and link every source into ``out``; returns the build log."""
    cuda = _cuda_home()
    nvcc = str(cuda / "bin" / "nvcc")
    cxx = os.environ.get("CXX", "c++")
    torch_dir = Path(torch.__file__).resolve().parent
    includes = [
        "-I", str(torch_dir / "include"),
        "-I", str(torch_dir / "include" / "torch" / "csrc" / "api" / "include"),
        "-I", str(cuda / "include"),
    ]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    log: list[str] = []
    objs, cmds = [], []
    for src in _sources():
        obj = str(out.parent / (src.name + ".o"))
        if src.suffix == ".cu":
            cmds.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj])
        else:
            cmds.append([cxx, *CXX_FLAGS, abi, *includes, "-c", str(src), "-o", obj])
        objs.append(obj)
    _run_all(cmds, log)
    torch_lib = str(torch_dir / "lib")
    _run_all(
        [[nvcc, "-shared", "-cudart", "shared", *objs, "-o", str(out),
          "-L", torch_lib, "-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch",
          "-L", str(cuda / "lib64"),
          "-Xlinker", f"-rpath,{torch_lib}",
          "-Xlinker", f"-rpath,{cuda / 'lib64'}"]],
        log,
    )
    return log


def library_path() -> Path:
    """Path of the built library for the current sources, building it first
    if needed.  Concurrent builders each build in a private directory and
    the first to finish publishes with an atomic rename."""
    final = BUILD_ROOT / _build_key()
    lib = final / LIB_NAME
    if lib.exists():
        return lib
    tmp = BUILD_ROOT / f".tmp-{os.getpid()}-{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    try:
        log = _compile(tmp / LIB_NAME)
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, final)
        except OSError:
            if not lib.exists():  # not a lost race with another builder
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


_loaded: Path | None = None
_load_lock = threading.Lock()


def load() -> Path:
    """Build (if needed) and load the kernels' library once per process.
    Threads that call it together (a daemon's first requests) wait for one
    build instead of each compiling the library."""
    global _loaded
    with _load_lock:
        if _loaded is None:
            lib = library_path()
            try:
                torch.ops.load_library(str(lib))
            except OSError as e:
                raise BuildError(f"loading {lib} failed: {e}") from e
            _loaded = lib
        return _loaded


def build_log() -> str:
    """The compiler output of the loaded build (ptxas register/spill lines)."""
    return (load().parent / "build.log").read_text()
