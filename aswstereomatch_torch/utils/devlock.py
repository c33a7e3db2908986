"""Advisory exclusive lock for the card, shared by the port's tools.

A copy of ``aswstereomatch_tpu.utils.devlock`` (that package cannot be
imported without jax).  Two long-lived owners of one card (the serving
daemon, a dataset sweep) would share its memory and its time unseen, and a
measurement taken beside another owner is corrupted, so the tools arbitrate
among themselves with an advisory ``flock``:

- ``aswstereomatch_torch.tools.serve`` holds it for the daemon's life,
- ``aswstereomatch_torch.tools.sweep`` for the sweep's.

``flock`` is released by the kernel on process death, so a crashed holder
can never wedge the lock.  The lock file carries ``{pid, label, since}`` so
a blocked acquirer can say WHO holds the device.  The path is
``$ASW_DEVICE_LOCK`` when set, else ``asw_cuda_device.lock`` in the
temporary directory (``$TMPDIR``).  Purely host-side.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import time


def lock_path() -> str:
    return os.environ.get("ASW_DEVICE_LOCK",
                          os.path.join(tempfile.gettempdir(), "asw_cuda_device.lock"))


def holder_info() -> dict | None:
    """Best-effort read of the current holder's {pid, label, since}."""
    try:
        with open(lock_path()) as f:
            info = json.load(f)
        # flock dies with its process; stale contents mean no holder.
        os.kill(int(info["pid"]), 0)
        return info
    except (OSError, ValueError, KeyError):
        return None


@contextlib.contextmanager
def device_lock(label: str, timeout_s: float = 300.0, poll_s: float = 1.0):
    """Hold the advisory device lock for the duration of the context.

    Blocks up to ``timeout_s`` waiting for the current holder, then raises
    ``TimeoutError`` naming it.  ``timeout_s=0`` is fail-fast.
    """
    fd = os.open(lock_path(), os.O_RDWR | os.O_CREAT, 0o666)
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    who = holder_info()
                    held = (
                        f"pid {who['pid']} ({who.get('label', '?')}, since "
                        f"{who.get('since', '?')})" if who else "unknown holder"
                    )
                    # Holder first: callers truncate this message into
                    # one-line diagnostics, and WHO is the useful part.
                    raise TimeoutError(
                        f"CUDA device held by {held}; waited "
                        f"{timeout_s:.0f}s on lock {lock_path()}"
                    ) from None
                time.sleep(min(poll_s, max(0.01, deadline - time.monotonic())))
        os.ftruncate(fd, 0)
        os.write(fd, json.dumps({
            "pid": os.getpid(),
            "label": label,
            "since": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }).encode())
        os.fsync(fd)
        yield
    finally:
        # Closing drops the flock; leave contents for post-mortem reads
        # (holder_info() cross-checks liveness via the recorded pid).
        os.close(fd)
