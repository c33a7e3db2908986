"""Runner of the "serve" traffic kind: the program's serving daemon, driven
over its socket by closed-loop clients in the benchmark's process.

Set-up spawns ``python -m aswstereomatch_torch.tools.serve --port 0`` (its
log in the temporary directory), waits for its port and for the answer to
one warm-up pair of the cell's shape, opens one connection per client and
sends ``warmup`` pairs on each.
In the window each client thread sends the pool's uint8 pairs in turn,
starting at its own index, and waits for each answer before it sends the
next: a stereo rig whose perception loop needs each map.  A pair's latency
is the client's round trip; ``elapsed_ms`` is the daemon's own time of the
request.  The daemon is stopped after the window, before the reference runs
on the card, so that one process at a time uses it.

In a traced run the daemon runs under ``traced_daemon.py``, which profiles
the card from the window's start to its end (signals SIGUSR1 and SIGUSR2)
and writes the trace's summary for the harness.

Mix file keys: ``kind`` ("serve"), ``pool``, ``clients``, ``warmup``,
``request_dtype`` and ``response_dtype`` (the wire formats).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

from .. import correctness, tracing
from ..harness import BENCH_DIR, REPO, Observed, Request
from . import wire

TIMEOUT_S = 300.0


def daemon_command(device: str, summary_path: str | None) -> list:
    """The daemon's command line; under the profiler where ``summary_path``
    names where its trace's summary goes."""
    if summary_path is not None:
        return [sys.executable, str(BENCH_DIR / "traffic" / "traced_daemon.py"),
                "--summary", summary_path, "--port", "0", "--device", device]
    return [sys.executable, "-m", "aswstereomatch_torch.tools.serve", "--port", "0",
            "--device", device]


def card_memory_bytes() -> int:
    """Memory in use on the first card, as nvidia-smi reads it; 0 without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return 0
    return int(float(out[0]) * 2**20) if out else 0


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _client(sock, client, pool, req_cfg, mix, barrier, window, sample, requests):
    key = client
    draw = sample.drawer(client)
    for j in range(mix["warmup"]):  # set-up: this connection's handler and its buffers
        k = (client + j) % len(pool)
        wire.send_request(sock, pool[k]["left"], pool[k]["right"], req_cfg,
                          dtype=mix["request_dtype"], response_dtype=mix["response_dtype"])
    barrier.wait()
    while True:
        t0 = time.perf_counter()
        if t0 >= window["end"]:
            return
        k = key % len(pool)
        try:
            disp, header = wire.send_request(
                sock, pool[k]["left"], pool[k]["right"], req_cfg,
                dtype=mix["request_dtype"], response_dtype=mix["response_dtype"])
        except (OSError, RuntimeError, ValueError) as e:  # recorded as a failed request
            requests.append(Request(k, t0, time.perf_counter(), error=f"{type(e).__name__}: {e}"))
            return
        request = Request(k, t0, time.perf_counter(), elapsed_ms=float(header["elapsed_ms"]))
        requests.append(request)
        if draw():
            sample.keep(request, disp)
        key += 1


def run(ctx) -> Observed:
    mix, conf = ctx.traffic, ctx.config
    req_cfg = {"preset": conf["preset"], **conf["overrides"]}
    tmp = tempfile.gettempdir()
    log_path = os.path.join(tmp, "asw_benchmark_daemon.log")
    summary_path = os.path.join(tmp, "asw_benchmark_daemon_trace.json") if ctx.trace else None
    if summary_path is not None and os.path.exists(summary_path):
        os.remove(summary_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    pool = ctx.pool
    sample = correctness.Sample(ctx.seed)
    requests: list = []
    window: dict = {}
    socks: list = []
    with open(log_path, "w") as log:
        proc = subprocess.Popen(daemon_command(ctx.device, summary_path), stdout=log,
                                stderr=subprocess.STDOUT, env=env, cwd=str(REPO))
        try:
            port = wire.wait_for_port(log_path, proc, timeout_s=TIMEOUT_S)
            with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S) as s:
                wire.send_request(s, pool[0]["left"], pool[0]["right"], req_cfg,
                                  dtype=mix["request_dtype"], response_dtype=mix["response_dtype"])
            socks = [socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S)
                     for _ in range(mix["clients"])]

            def open_window():
                if summary_path is not None:
                    proc.send_signal(signal.SIGUSR1)
                window["start"] = time.perf_counter()
                window["end"] = window["start"] + ctx.seconds

            barrier = threading.Barrier(len(socks), action=open_window)
            threads = [threading.Thread(target=_client, daemon=True, args=(
                s, i, pool, req_cfg, mix, barrier, window, sample, requests))
                for i, s in enumerate(socks)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(ctx.seconds + TIMEOUT_S)
            if any(t.is_alive() for t in threads):
                raise TimeoutError("a client did not finish its last request")
            window_s = max(r.t1 for r in requests) - window["start"]
            trace = None
            if summary_path is not None:
                proc.send_signal(signal.SIGUSR2)
                trace = tracing.Trace.from_summary(_wait_for(summary_path, proc))
            memory = card_memory_bytes()
        except BaseException:
            log.flush()
            with open(log_path, errors="replace") as f:
                print(f"the daemon's log ends:\n{f.read()[-4000:]}", file=sys.stderr)
            raise
        finally:
            for s in socks:
                s.close()
            _stop(proc)
    return Observed(
        requests=sorted(requests, key=lambda r: r.t0), window_start=window["start"],
        window_s=window_s, sample=sample, answer_form=mix["response_dtype"],
        memory_peak_bytes=memory, trace=trace)


def _wait_for(path: str, proc) -> dict:
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        if proc.poll() is not None:
            raise RuntimeError(f"the traced daemon exited with {proc.returncode}")
        time.sleep(0.1)
    raise TimeoutError("the traced daemon wrote no trace")
