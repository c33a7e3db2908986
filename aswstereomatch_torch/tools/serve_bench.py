"""Load test of the port's serving daemon: request-latency percentiles.

The counterpart of the repository's ``tools/serve_bench.py``.  It spawns
``python -m aswstereomatch_torch.tools.serve --device <device> --port 0``
(or targets a running daemon with ``--port``) and drives it with
``--clients`` threads, each on its own connection, sending one KITTI-geometry
pair (1242x375, D=128, ``synthetic.make_pair(seed=0)``) at ``--preset``
(``kitti_sep`` by default, ``kitti_sgm`` too).  For each wire combination
(request dtype -> response dtype: float32->float32, uint8->float32,
uint8->uint16_x256) it records the round trip's p50 / p90 / p99 / max, the
daemon's own ``elapsed_ms`` (host-to-device copy, pipeline, device-to-host
copy) at p50, the p50 of each request's round trip past its ``elapsed_ms``
(``client_past_server_p50_ms``: the wire both ways, the daemon's request
parse and response assembly), and the pairs/s of all clients over the
measured span.

Each client sends one untimed warm-up request, then waits at a barrier, so
that the first request's build or load stays out of the span.  The first
answer of each wire must equal, bit for bit, the same request run in this
process through ``StereoMatcher``.  A client that fails breaks the barrier
for the others; the daemon's output goes to a log whose tail is printed on
failure, and a spawned daemon is always stopped.  The tool takes no device
lock: the daemon holds it for its life.  The record goes to
``results_torch/serve_bench.json`` (``serve_bench_<preset>.json`` for
another preset).

    python -m aswstereomatch_torch.tools.serve_bench [--requests 100] [--clients 4]
        [--preset kitti_sep]
    python -m aswstereomatch_torch.tools.serve_bench --device cpu --shape 48 64 8 \\
        --radius 2 --requests 8 --clients 2
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

from ..config import get_preset
from ..models import pipeline
from ..utils import synthetic
from . import common, serve

GEOMETRY = (375, 1242, 128)  # H, W, D of the pair every request carries
WIRES = (("float32", "float32"), ("uint8", "float32"), ("uint8", "uint16_x256"))


def request_config(preset: str, shape=None, radius=None) -> dict:
    """The request's "config": the preset, cut down where asked."""
    cfg = {"preset": preset}
    if shape is not None:
        cfg["max_disparity"] = int(shape[2])
    if radius is not None:
        cfg["window_radius"] = int(radius)
    return cfg


def config_of(request_cfg: dict):
    """The ``StereoConfig`` the daemon makes of a request's "config"."""
    rest = dict(request_cfg)
    return get_preset(rest.pop("preset")).replace(**rest)


def wire_images(pair: dict, dtype: str) -> tuple:
    """The pair as a client ships it: uint8 (truncated) or float32."""
    return tuple(np.ascontiguousarray(pair[s], np.dtype(dtype)) for s in ("left", "right"))


def expected_answer(cfg, left: np.ndarray, right: np.ndarray, response_dtype: str,
                    device) -> np.ndarray:
    """What the daemon must answer, as ``send_request`` decodes it: the same
    request run here through ``StereoMatcher`` (and the same u16 encoding)."""
    disp = pipeline.StereoMatcher(cfg, device=device)(left, right)
    if response_dtype == "uint16_x256":
        return serve.encode_u16(disp).cpu().numpy().astype(np.float32) / 256.0
    return disp.cpu().numpy()


def _client(port, images, req_cfg, dtype, rdtype, n_req, barrier, timeout_s, out):
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=timeout_s) as sock:
            disp, _ = serve.send_request(sock, *images, req_cfg, dtype=dtype,
                                         response_dtype=rdtype)
            out["first"].append(disp)
            barrier.wait()
            start = time.perf_counter()
            for _ in range(n_req):
                t0 = time.perf_counter()
                _, hdr = serve.send_request(sock, *images, req_cfg, dtype=dtype,
                                            response_dtype=rdtype)
                out["rounds"].append((time.perf_counter() - t0, hdr["elapsed_ms"]))
            out["spans"].append((start, time.perf_counter()))
    except threading.BrokenBarrierError:
        out["errors"].append("barrier broken by another client")
    except Exception as e:  # noqa: BLE001 - reported, and the others released
        out["errors"].append(f"{type(e).__name__}: {e}")
        barrier.abort()


def drive(port: int, images: tuple, req_cfg: dict, dtype: str, rdtype: str, clients: int,
          per_client: int, timeout_s: float) -> dict:
    """One wire: ``clients`` threads of ``per_client`` timed requests each;
    ``{"first", "rounds", "spans", "errors"}``."""
    out = {"first": [], "rounds": [], "spans": [], "errors": []}
    barrier = threading.Barrier(clients, timeout=timeout_s)
    threads = [threading.Thread(target=_client, daemon=True,
                                args=(port, images, req_cfg, dtype, rdtype, per_client,
                                      barrier, timeout_s, out))
               for _ in range(clients)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 2 * timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        out["errors"].append(f"a client did not finish within {2 * timeout_s:.0f} s")
    return out


def summarise(out: dict) -> dict:
    """The reference's per-wire fields, and the round trip past the daemon's
    own time."""
    lat = np.array([r for r, _ in out["rounds"]]) * 1e3
    srv = np.array([s for _, s in out["rounds"]])
    wall = max(e for _, e in out["spans"]) - min(s for s, _ in out["spans"])
    return {
        "requests": len(lat),
        "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "p99_ms": float(np.percentile(lat, 99)),
        "max_ms": float(lat.max()),
        "server_side_p50_ms": float(np.percentile(srv, 50)),
        "client_past_server_p50_ms": float(np.percentile(lat - srv, 50)),
        "throughput_pairs_per_s": len(lat) / wall,
    }


def run(device, preset: str = "kitti_sep", clients: int = 4, requests: int = 100,
        port: int = 0, shape=None, radius=None, log_path=None, timeout_s: float = 300.0,
        maps=None, progress=print) -> dict:
    """The load test; ``maps``, where given, receives each wire's first answer."""
    device = torch.device(device)
    h, w, d = shape if shape is not None else GEOMETRY
    pair = synthetic.make_pair(height=h, width=w, max_disparity=d, seed=0)
    req_cfg = request_config(preset, shape, radius)
    cfg = config_of(req_cfg)
    want = {(dt, rdt): expected_answer(cfg, *wire_images(pair, dt), rdt, device)
            for dt, rdt in WIRES}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    per = max(1, requests // clients)
    proc = log = None
    if not port:
        log_path = log_path or os.path.join(common.RESULTS_DIR, "serve_bench_daemon.log")
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        log = open(log_path, "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "aswstereomatch_torch.tools.serve", "--device", device.type,
             "--port", "0"], stdout=log, stderr=subprocess.STDOUT, env=common.child_env(),
            cwd=str(common.REPO))
    rec = {"preset": preset, "clients": clients, "wire": {}, "shape": [h, w, d],
           "config_hash": cfg.config_hash()}
    errors = []
    try:
        if proc is not None:
            port = serve.wait_for_port(log_path, proc, timeout_s=timeout_s)
        for dtype, rdtype in WIRES:
            images = wire_images(pair, dtype)
            out = drive(port, images, req_cfg, dtype, rdtype, clients, per, timeout_s)
            if out["errors"] or len(out["rounds"]) != per * clients:
                errors += [f"{dtype}->{rdtype}: {e}" for e in out["errors"] or ["short"]]
                break
            key = f"{dtype}->{rdtype}"
            first = out["first"][0]
            if maps is not None:
                maps[key] = first
            differ = [int(np.sum(f != want[(dtype, rdtype)])) for f in out["first"]]
            rec["wire"][key] = {**summarise(out), "first_answer_bit_exact": not any(differ),
                                "first_answer_differing_pixels": max(differ)}
            progress(f"serve_bench {preset} {key}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in rec["wire"][key].items()))
    except Exception:
        if log is not None:
            log.flush()
            print(f"serve_bench: the daemon's log ({log_path}) ends:\n"
                  + common.log_tail(log_path), file=sys.stderr)
        raise
    finally:
        if proc is not None:
            common.stop(proc)
            log.close()
    if errors and log is not None:
        print(f"serve_bench: the daemon's log ({log_path}) ends:\n"
              + common.log_tail(log_path), file=sys.stderr)
    rec["errors"] = errors
    rec["ok"] = not errors and all(v["first_answer_bit_exact"] for v in rec["wire"].values())
    rec["note"] = (
        "wire key is request->response dtype; loopback TCP, one connection per client, "
        "each client's warm-up request untimed; server_side = the daemon's elapsed_ms "
        "(host-to-device copy, pipeline, device-to-host copy and its wait); "
        "client_past_server = round trip - elapsed_ms (wire both ways, request parse, "
        "response assembly); first_answer_bit_exact holds the first answer of every "
        "client against the same request run in the tool's process")
    rec.update(common.environment(device))
    return rec


def main(argv=None) -> int:
    ap = common.parser("serve_bench", __doc__)
    ap.set_defaults(out=None)
    ap.add_argument("--requests", type=int, default=100, help="timed requests per wire")
    ap.add_argument("--preset", default="kitti_sep")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--port", type=int, default=0,
                    help="target a running daemon instead of spawning one")
    common.add_shape_args(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    suffix = "" if args.preset == "kitti_sep" else f"_{args.preset}"
    out = args.out or os.path.join(common.RESULTS_DIR, f"serve_bench{suffix}.json")
    rec = run(device, args.preset, args.clients, args.requests, args.port, args.shape,
              args.radius)
    common.write_record(out, rec)
    print(f"serve_bench: {'ok' if rec['ok'] else 'FAILED'}; record {out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
