"""Serving soak of the port's daemon under a live supervisor loop.

The counterpart of the repository's ``tools/serve_soak.py``.  Clients on
their own connections drive ``python -m aswstereomatch_torch.tools.serve``
with a mix of presets (``kitti_sep`` at 1242x375 D=128, K2 on the card;
``middlebury_asw_full`` at 450x375 D=64, K1) over the three wire
combinations (uint8->uint16_x256, uint8->float32, float32->float32, drawn
per request), reconnecting and retrying when the daemon goes away.  A
supervisor thread runs the daemon as the documented production loop does:
it restarts it when it exits with ``Server.RSS_EXIT_CODE`` (42, past
``--max-rss-mb`` of host memory) and records each generation's RSS curve,
the seconds from its spawn to its listener (a torch import and the bind)
and to its first answer (CUDA context, ``build.load()`` of the built
library, the first launches).  Every answer must equal, bit for bit, the
first answer of its (preset, wire) for the whole run, restarts included,
and that first answer the same request run in this process through
``StereoMatcher``.

Two soaks, as the reference's two records:

- the recycle soak (``--out``, default ``results_torch/serve_soak_2k.json``):
  ``--recycle-requests`` requests from ``--recycle-clients`` clients with
  ``--max-rss-mb`` set below the daemon's RSS after its first answer, so
  that every generation recycles after it.  The limit is measured first,
  from a probe generation's RSS when listening and after one answer (their
  midpoint).  A generation past its limit still answers the requests that
  reach it until its listener has shut down (up to the listener's 0.5 s
  poll), so the soak needs enough requests to outlast that: 48 by default.
  It must show at least one restart on 42, no unstable answer and no
  server error;
- the steady soak (the same path with ``_steady``): ``--requests`` from
  ``--clients`` clients at ``--max-rss-mb`` (8192 by default); no unstable
  answer and no server error.

    python -m aswstereomatch_torch.tools.serve_soak [--requests 2000] [--clients 4]
    python -m aswstereomatch_torch.tools.serve_soak --device cpu --shape 48 64 8 --radius 2 \\
        --requests 8 --clients 2
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..utils import synthetic
from . import common, serve, serve_bench
from .soak_runner import rss_mb

WIRES = (("uint8", "uint16_x256"), ("uint8", "float32"), ("float32", "float32"))
# (preset, (H, W, D), make_pair seed): the mix of the reference's soak
PRESETS = (("kitti_sep", (375, 1242, 128), 0), ("middlebury_asw_full", (375, 450, 64), 1))
TICK_S = 0.1       # how often the supervisor looks at its daemon
SAMPLE_S = 0.5     # how often it reads the daemon's RSS


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _listening(log_path: str) -> bool:
    with open(log_path) as f:
        return "serving on " in f.read()


def serve_command(device: str, port: int, max_rss_mb: float) -> list:
    return [sys.executable, "-m", "aswstereomatch_torch.tools.serve", "--device", device,
            "--port", str(port), "--max-rss-mb", str(max_rss_mb)]


class Supervisor(threading.Thread):
    """The production loop: restart the stateless daemon on the RSS
    self-recycle code; record each generation's pid, RSS curve and the
    times from its spawn to its listener (``up_s``) and to its end."""

    def __init__(self, device: str, port: int, max_rss_mb: float, log_dir: str):
        super().__init__(daemon=True)
        self.device = device
        self.port = port
        self.max_rss_mb = max_rss_mb
        self.log_dir = log_dir
        self.generations = []
        self.restarts = 0
        self.stop_flag = threading.Event()
        self.ended = threading.Event()  # no generation will come any more
        self.proc = None

    def run(self):
        try:
            while not self.stop_flag.is_set():
                log_path = os.path.join(self.log_dir, f"generation{len(self.generations)}.log")
                with open(log_path, "w") as log:
                    self.proc = subprocess.Popen(
                        serve_command(self.device, self.port, self.max_rss_mb), stdout=log,
                        stderr=subprocess.STDOUT, env=common.child_env(), cwd=str(common.REPO))
                    gen = {"pid": self.proc.pid, "started": time.time(), "rss_curve": [],
                           "log": log_path}
                    self.generations.append(gen)
                    sampled = 0.0
                    while self.proc.poll() is None:
                        if self.stop_flag.is_set():
                            common.stop(self.proc)
                            break
                        now = time.time()
                        if "up" not in gen and _listening(log_path):
                            gen["up"] = now
                        if now - sampled >= SAMPLE_S:
                            m = rss_mb(self.proc.pid)
                            if m:  # 0 while the daemon's memory is torn down at its exit
                                gen["rss_curve"].append(round(m, 1))
                            sampled = now
                        time.sleep(TICK_S)
                    gen["ended"] = time.time()
                    gen["rc"] = self.proc.returncode
                if self.stop_flag.is_set() or self.proc.returncode != serve.Server.RSS_EXIT_CODE:
                    break  # stopped, or any other exit ends the soak's daemon
                self.restarts += 1
        finally:
            self.ended.set()

    def shutdown(self):
        self.stop_flag.set()
        if self.proc is not None:
            common.stop(self.proc)
        self.join(timeout=60)


def _connect(port: int, sup: Supervisor, deadline: float):
    while time.monotonic() < deadline:
        if sup.ended.is_set():
            raise RuntimeError(f"the daemon ended for good (exit {sup.generations[-1].get('rc')})")
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.settimeout(max(1.0, deadline - time.monotonic()))
            return s
        except OSError:
            time.sleep(0.2)
    raise TimeoutError("the daemon never came (back) up")


def _client(cid, port, n_req, spec, sup, deadline, state):
    """One connection per generation; when the daemon goes away, reconnect
    and send the same request again (requests are stateless)."""
    name, left, right, config = spec
    rng = np.random.default_rng(1000 + cid)
    sock = None
    try:
        sock = _connect(port, sup, deadline)
        done = 0
        wire = None
        while done < n_req:
            if time.monotonic() > deadline:
                raise TimeoutError(f"client {cid}: past the soak's deadline")
            if wire is None:
                wire = WIRES[int(rng.integers(len(WIRES)))]
            dtype, rdtype = wire
            images = (left.astype(np.uint8), right.astype(np.uint8)) if dtype == "uint8" \
                else (left, right)
            t0 = time.perf_counter()
            try:
                disp, hdr = serve.send_request(sock, *images, config, dtype=dtype,
                                               response_dtype=rdtype)
            except RuntimeError as e:  # the daemon answered with an error
                state["results"].append((cid, name, dtype, rdtype, None,
                                         f"server-error: {e}", None, time.time()))
                done, wire = done + 1, None
                continue
            except OSError:  # ConnectionError too: the daemon went away
                sock.close()
                state["reconnects"].append((cid, time.time()))
                sock = _connect(port, sup, deadline)
                continue
            dt = time.perf_counter() - t0
            key = (name, dtype, rdtype)
            with state["lock"]:
                if key not in state["refs"]:
                    state["refs"][key] = disp
                    stable = True
                else:
                    stable = bool(np.array_equal(disp, state["refs"][key]))
            state["results"].append((cid, name, dtype, rdtype, dt,
                                     "ok" if stable else "UNSTABLE", hdr["elapsed_ms"],
                                     time.time()))
            done, wire = done + 1, None
    except Exception as e:  # noqa: BLE001 - the soak reports it and fails
        state["client_errors"].append(f"client {cid}: {type(e).__name__}: {e}")
    finally:
        if sock is not None:
            sock.close()


def specs(shape=None, radius=None) -> list:
    """(name, left, right, request config) of each preset of the mix."""
    out = []
    for preset, geom, seed in PRESETS:
        h, w, d = shape if shape is not None else geom
        pair = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=seed)
        out.append((preset, np.asarray(pair["left"], np.float32),
                    np.asarray(pair["right"], np.float32),
                    serve_bench.request_config(preset, shape, radius)))
    return out


def expected_answers(spec_list, device) -> dict:
    """Each (preset, wire)'s answer, run in this process."""
    want = {}
    for name, left, right, config in spec_list:
        cfg = serve_bench.config_of(config)
        for dtype, rdtype in WIRES:
            images = serve_bench.wire_images({"left": left, "right": right}, dtype)
            want[(name, dtype, rdtype)] = serve_bench.expected_answer(cfg, *images, rdtype,
                                                                      device)
    return want


def probe_limit(device: str, spec, log_dir: str, timeout_s: float = 300.0) -> dict:
    """A probe generation's RSS when listening and after its first answer;
    the recycle limit is their midpoint."""
    log_path = os.path.join(log_dir, "probe.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(serve_command(device, 0, 8192), stdout=log,
                                stderr=subprocess.STDOUT, env=common.child_env(),
                                cwd=str(common.REPO))
    try:
        port = serve.wait_for_port(log_path, proc, timeout_s=timeout_s)
        listening = rss_mb(proc.pid)
        name, left, right, config = spec
        with socket.create_connection(("127.0.0.1", port), timeout=timeout_s) as sock:
            serve.send_request(sock, left.astype(np.uint8), right.astype(np.uint8), config,
                               dtype="uint8")
        answered = rss_mb(proc.pid)
    except Exception:
        print("serve_soak: the probe daemon's log ends:\n" + common.log_tail(log_path),
              file=sys.stderr)
        raise
    finally:
        common.stop(proc)
    if not answered > listening + 1.0:
        raise RuntimeError(f"the daemon's RSS does not rise with its first answer "
                           f"({listening:.1f} -> {answered:.1f} MiB): no limit forces a recycle")
    return {"rss_mb_listening": round(listening, 1),
            "rss_mb_after_first_answer": round(answered, 1),
            "preset": name, "max_rss_mb_limit": round((listening + answered) / 2, 1)}


def soak(device: str, spec_list, want: dict, requests: int, clients: int, max_rss_mb: float,
         log_dir: str, deadline_s: float = 3600.0, pins=None) -> dict:
    """One soak under a supervisor; the record in the reference's fields.
    ``pins``, where given, receives each (preset, dtype, response dtype)'s
    pinned answer that it does not hold yet."""
    os.makedirs(log_dir, exist_ok=True)
    port = free_port()
    sup = Supervisor(device, port, max_rss_mb, log_dir)
    state = {"results": [], "reconnects": [], "client_errors": [], "refs": {},
             "lock": threading.Lock()}
    per = max(1, requests // clients)
    deadline = time.monotonic() + deadline_s
    t0 = time.time()
    sup.start()
    threads = [threading.Thread(target=_client, daemon=True,
                                args=(i, port, per, spec_list[i % len(spec_list)], sup, deadline,
                                      state))
               for i in range(clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()) + 30)
        wall = time.time() - t0
    finally:
        sup.shutdown()
    if any(t.is_alive() for t in threads):
        state["client_errors"].append("a client did not finish by the deadline")
    results = state["results"]
    ok = [r for r in results if r[5] == "ok"]
    unstable = [r for r in results if r[5] == "UNSTABLE"]
    errors = [r for r in results if r[5].startswith("server-error")]
    by_class = {}
    for _, name, dtype, rdtype, dt, _, _, _ in ok:
        by_class.setdefault(f"{name}:{dtype}->{rdtype}", []).append(dt * 1e3)
    for key, disp in state["refs"].items():
        if pins is not None:
            pins.setdefault(key, disp)
    pins_differ = sorted(f"{k[0]}:{k[1]}->{k[2]}" for k, v in state["refs"].items()
                         if not np.array_equal(v, want[k]))
    rec = {
        "requests_completed": len(ok) + len(errors),
        "requests_bit_stable": len(ok),
        "unstable": len(unstable),
        "server_errors": len(errors),
        "client_reconnects": len(state["reconnects"]),
        "supervisor_restarts_on_42": sup.restarts,
        "generations": [_generation(g, results) for g in sup.generations],
        "max_rss_mb_limit": max_rss_mb,
        "wall_s": round(wall, 1),
        "aggregate_pairs_per_s": round((len(ok) + len(errors)) / wall, 2),
        "latency_by_class": {
            k: {"n": len(v), "p50_ms": round(float(np.percentile(v, 50)), 3),
                "p99_ms": round(float(np.percentile(v, 99)), 3)}
            for k, v in sorted(by_class.items())},
        "pins_equal_in_process": not pins_differ,
        "pins_differing": pins_differ,
        "client_errors": state["client_errors"],
        "requests_asked": per * clients,
        "clients": clients,
    }
    if state["client_errors"] or unstable or errors or pins_differ:
        print(f"serve_soak: the last generation's log ({sup.generations[-1]['log']}) ends:\n"
              + common.log_tail(sup.generations[-1]["log"]), file=sys.stderr)
    return rec


def _generation(g: dict, results: list) -> dict:
    """A generation's record: its RSS curve, the seconds from its spawn to
    its listener and to its first answer, and that answer's elapsed_ms."""
    ended = g.get("ended", time.time())
    mine = sorted((r for r in results if g["started"] <= r[7] <= ended and r[6] is not None),
                  key=lambda r: r[7])
    curve = g["rss_curve"]
    return {
        "pid": g["pid"], "rc": g.get("rc"),
        "alive_s": round(ended - g["started"], 1),
        "rss_mb_first": curve[0] if curve else None,
        "rss_mb_last": curve[-1] if curve else None,
        "rss_mb_peak": max(curve) if curve else None,
        "rss_curve_mb": curve,
        "up_s": round(g["up"] - g["started"], 2) if "up" in g else None,
        "first_answer_s": round(mine[0][7] - g["started"], 2) if mine else None,
        "first_answer_elapsed_ms": mine[0][6] if mine else None,
        "answers": len(mine),
    }


def run(device, requests: int = 2000, clients: int = 4, max_rss_mb: float = 8192,
        recycle_requests: int = 48, recycle_clients: int = 2, shape=None, radius=None,
        log_dir: str | None = None, deadline_s: float = 3600.0, pins=None,
        progress=print) -> dict:
    """Both soaks: ``{"recycle": record, "steady": record}``; ``pins``, where
    given, receives the pinned answers (``soak``)."""
    device = torch.device(device)
    log_dir = log_dir or os.path.join(common.RESULTS_DIR, "serve_soak_logs")
    os.makedirs(log_dir, exist_ok=True)
    spec_list = specs(shape, radius)
    want = expected_answers(spec_list, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    env = common.environment(device)
    probe = probe_limit(device.type, spec_list[0], log_dir, min(300.0, deadline_s))
    progress(f"serve_soak probe: RSS {probe['rss_mb_listening']} MiB listening, "
             f"{probe['rss_mb_after_first_answer']} MiB after its first answer; recycle "
             f"limit {probe['max_rss_mb_limit']} MiB")
    recycle = soak(device.type, spec_list, want, recycle_requests, recycle_clients,
                   probe["max_rss_mb_limit"], os.path.join(log_dir, "recycle"), deadline_s,
                   pins)
    recycle.update(probe=probe, **env)
    recycle["checks"] = {
        "restarted_on_42": recycle["supervisor_restarts_on_42"] >= 1,
        "stable": recycle["unstable"] == 0, "no_server_errors": recycle["server_errors"] == 0,
        "no_client_errors": not recycle["client_errors"],
        "pins_equal_in_process": recycle["pins_equal_in_process"]}
    recycle["note"] = ("recycle soak: the RSS limit is the midpoint of a probe generation's "
                       "RSS when listening and after its first answer, so every generation "
                       "recycles (exit 42) after answering; bit-stability pinned per (preset, "
                       "wire) across every restart")
    progress(_line("recycle", recycle))
    steady = soak(device.type, spec_list, want, requests, clients, max_rss_mb,
                  os.path.join(log_dir, "steady"), deadline_s, pins)
    steady.update(env)
    steady["checks"] = {
        "stable": steady["unstable"] == 0, "no_server_errors": steady["server_errors"] == 0,
        "no_client_errors": not steady["client_errors"],
        "pins_equal_in_process": steady["pins_equal_in_process"]}
    steady["note"] = ("steady soak at the given RSS limit; mixed-preset mixed-wire, "
                      "bit-stability pinned per (preset, wire) for the whole run")
    progress(_line("steady", steady))
    for rec in (recycle, steady):
        rec["ok"] = all(rec["checks"].values())
    return {"recycle": recycle, "steady": steady}


def _line(kind: str, rec: dict) -> str:
    gens = "; ".join(
        f"gen {i}: rc {g['rc']}, up {g['up_s']} s, first answer {g['first_answer_s']} s "
        f"(elapsed_ms {g['first_answer_elapsed_ms']}), RSS {g['rss_mb_first']} -> "
        f"{g['rss_mb_peak']} peak -> {g['rss_mb_last']} MiB, {g['answers']} answers"
        for i, g in enumerate(rec["generations"]))
    return (f"serve_soak {kind}: {rec['requests_completed']} requests, {rec['unstable']} "
            f"unstable, {rec['server_errors']} server errors, {rec['client_reconnects']} "
            f"reconnects, {rec['supervisor_restarts_on_42']} restarts on 42, "
            f"{rec['aggregate_pairs_per_s']} pairs/s in {rec['wall_s']} s; {gens}")


def steady_path(out: str) -> str:
    root, ext = os.path.splitext(out)
    return f"{root}_steady{ext}"


def main(argv=None) -> int:
    ap = common.parser("serve_soak_2k", __doc__)
    ap.add_argument("--requests", type=int, default=2000, help="the steady soak's requests")
    ap.add_argument("--clients", type=int, default=4, help="the steady soak's clients")
    ap.add_argument("--max-rss-mb", type=float, default=8192,
                    help="the steady soak's daemon RSS limit")
    ap.add_argument("--recycle-requests", type=int, default=48)
    ap.add_argument("--recycle-clients", type=int, default=2)
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    recs = run(device, args.requests, args.clients, args.max_rss_mb, args.recycle_requests,
               args.recycle_clients, args.shape, args.radius)
    common.write_record(args.out, recs["recycle"])
    common.write_record(steady_path(args.out), recs["steady"])
    ok = recs["recycle"]["ok"] and recs["steady"]["ok"]
    print(f"serve_soak: {'ok' if ok else 'FAILED'}; records {args.out}, "
          f"{steady_path(args.out)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
