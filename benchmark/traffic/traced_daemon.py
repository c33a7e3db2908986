"""The program's serving daemon under the profiler, for a traced run.

    python benchmark/traffic/traced_daemon.py --summary PATH [serve's arguments]

Runs ``aswstereomatch_torch.tools.serve.main`` with its own arguments.  On
SIGUSR1 a control thread starts profiling the card (every kernel and copy
of the process); on SIGUSR2 it stops and writes the trace's summary (device
intervals, busy time, the window's length) to PATH as JSON.  The profiler
is started and stopped once before the daemon serves, so that its first
start stays out of the window.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from aswstereomatch_torch.tools import serve  # noqa: E402
from benchmark import tracing  # noqa: E402


def _profiler():
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CUDA if torch.cuda.is_available() else act.CPU])


def _control(commands: queue.Queue, summary: str) -> None:
    """Start and stop the profiler in the order the signals came."""
    while True:
        commands.get()
        prof = _profiler()
        prof.start()
        t0 = time.perf_counter()
        commands.get()
        window_s = time.perf_counter() - t0
        prof.stop()
        trace = tracing.from_profiler(prof, window_s)
        tmp = summary + ".part"
        with open(tmp, "w") as f:
            json.dump(trace.summary(), f)
        os.replace(tmp, summary)


def main(argv) -> int:
    i = argv.index("--summary")
    summary = argv[i + 1]
    commands: queue.Queue = queue.Queue()
    with _profiler():
        torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
    threading.Thread(target=_control, args=(commands, summary), daemon=True).start()
    signal.signal(signal.SIGUSR1, lambda signum, frame: commands.put("start"))
    signal.signal(signal.SIGUSR2, lambda signum, frame: commands.put("stop"))
    return serve.main(argv[:i] + argv[i + 2:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
