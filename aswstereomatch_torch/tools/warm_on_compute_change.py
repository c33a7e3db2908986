"""Post-commit build warmer: prebuild the kernels' library after a commit
that changes it.

The counterpart of the repository's ``tools/warm_on_compute_change.py``.
Installed as ``.git/hooks/post-commit`` (``--install``), it looks at the
files ``HEAD`` touched; when one of them changes the library that
``ops/cuda/build.py`` builds (``build.changes_build``: a source or header
that ``build.keyed_files`` hashes into the build key, or ``build.py``
itself, which holds the flags), it spawns one detached child that runs
``build.load()``, so the next process finds the library under its new key
instead of compiling it.  The commit returns at once.  A pid file
(``results_torch/warm_cache.pid``) keeps a second child from starting while
one is alive.  The decision is logged to ``results_torch/warm_hook.log``,
the child's output (the library's path, or the build's own error and a
non-zero exit where ``nvcc`` is missing) to ``results_torch/warm_cache.log``.
Nothing falls back.

    python -m aswstereomatch_torch.tools.warm_on_compute_change            # hook body
    python -m aswstereomatch_torch.tools.warm_on_compute_change --install  # write the hook
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

from ..ops.cuda import build
from . import common

HOOK_BODY = """#!/bin/sh
# installed by python -m aswstereomatch_torch.tools.warm_on_compute_change --install
cd "$(git rev-parse --show-toplevel)" && \\
    exec python -m aswstereomatch_torch.tools.warm_on_compute_change
"""
MODULE = "aswstereomatch_torch.tools.warm_on_compute_change"


def changes_build(path: str) -> bool:
    """Whether a repository-relative path is one the built library depends on."""
    return build.changes_build(common.REPO / path)


def changed_paths(repo: Path = common.REPO) -> list:
    """The files ``HEAD`` touched, relative to the repository."""
    out = subprocess.run(
        ["git", "diff-tree", "--no-commit-id", "--name-only", "-r", "--root", "HEAD"],
        cwd=repo, capture_output=True, text=True, timeout=60, check=True).stdout
    return out.splitlines()


def _log(results: Path, msg: str) -> None:
    with open(results / "warm_hook.log", "a") as f:
        f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}\n")


def _child_alive(pid_file: Path) -> bool:
    """Whether the pid file names a live warm child."""
    try:
        pid = int(pid_file.read_text().strip())
        cmdline = Path(f"/proc/{pid}/cmdline").read_bytes()
    except (OSError, ValueError):
        return False
    return MODULE.encode() in cmdline


def hook(paths: list, results: Path = common.REPO / common.RESULTS_DIR):
    """The hook's body on a list of changed paths: the spawned child
    (``subprocess.Popen``) or None."""
    results.mkdir(parents=True, exist_ok=True)
    compute = [p for p in paths if changes_build(p)]
    if not compute:
        _log(results, "HEAD touched nothing the kernels' library is built from; no warm needed")
        return None
    pid_file = results / "warm_cache.pid"
    if _child_alive(pid_file):
        _log(results, f"build input changed ({compute[0]}...) but a warm child is already live")
        return None
    with open(results / "warm_cache.log", "ab") as log:
        child = subprocess.Popen([sys.executable, "-m", MODULE, "--build"], stdout=log,
                                 stderr=log, start_new_session=True, cwd=str(common.REPO),
                                 env=common.child_env())
    pid_file.write_text(str(child.pid))
    _log(results, f"build input changed in {len(compute)} file(s) ({compute[0]}...): "
                  f"spawned warm child pid {child.pid}")
    return child


def warm() -> int:
    """The child: build and load the library; its path, or the build's error."""
    t0 = time.perf_counter()
    try:
        lib = build.load()
    except build.BuildError as e:
        print(f"{time.strftime('%Y-%m-%d %H:%M:%S')} build failed: {e}", flush=True)
        return 1
    print(f"{time.strftime('%Y-%m-%d %H:%M:%S')} library {lib} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


def install(repo: Path = common.REPO) -> Path:
    path = repo / ".git" / "hooks" / "post-commit"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(HOOK_BODY)
    path.chmod(0o755)
    return path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--install" in argv:
        print(f"installed {install()}")
        return 0
    if "--build" in argv:
        return warm()
    hook(changed_paths())
    return 0


if __name__ == "__main__":
    sys.exit(main())
