"""Serving daemon of the port: disparity requests over a local TCP socket.

The counterpart of the repository's ``tools/serve.py`` (the JAX package's
daemon), with the same wire protocol byte for byte: a long-lived process
serving rectified pairs (cameras pushing frames) on the card.  It keeps one
``StereoMatcher`` per (config hash, confidence); the first request that
reaches a kernel builds or loads the kernels' library once per process.

Protocol (all little-endian):
  request:  u32 header_len | header JSON | left bytes | right bytes
            header: {"height", "width", "channels", "config": {...overrides},
                     "dtype": "float32" (default) | "uint8",
                     "response_dtype": "float32" (default) | "uint16_x256",
                     "confidence": false (default) | true}
  response: u32 header_len | header JSON | disparity bytes
            [| uniq_pct float32 H*W | lr_valid uint8 H*W when confidence]
            header: {"status": "ok", "height", "width", "elapsed_ms",
                     "dtype", "confidence"} or {"status": "error", "message"}

"config" holds StereoConfig fields, optionally with "preset" naming the
preset they override; "backend" takes the port's "auto" | "eager" | "cuda".
With "confidence": true the response appends the per-pixel WTA-uniqueness
margin (percent, float32) and the LR-validity mask
(``pipeline.match_pair_with_confidence``): the client thresholds
``uniq_pct >= r`` instead of asking for another config per operating point.

"uint16_x256" is the KITTI on-disk disparity encoding: d * 256 rounded half
to even, clamped to [0, 65535] (invalid / negative -> 0), 1/256 px steps.
It is encoded on the card, so the device-to-host copy and the response
carry half the bytes.  The "uint8" wire format is lossless for 8-bit
images and ships 4x fewer bytes than float32; the widen to float32 happens
on the card.

Protocol limits (any client integer is untrusted; nothing is allocated
before validation):
  - header_len in (0, 1 MiB]; the header must decode as a JSON object.
  - height/width are integers in [1, 16384], channels is 1 or 3, and each
    image plane is capped at 256 MiB; "dtype" must be float32 or uint8.
  - Violations get a {"status": "error"} response and the connection is
    DROPPED: past a malformed header the stream position can no longer be
    trusted.  Errors raised after the body is fully consumed (a bad config
    value) keep the connection.
  - Handler sockets carry an idle timeout (--idle-timeout, default 300 s):
    a stalled or vanished client releases its thread.
  - Past --max-rss-mb of host memory the daemon finishes the in-flight
    response and exits with code 42 for a supervisor loop to restart it.

On the card (``--device cuda``, the default; it exits non-zero without one)
the daemon holds the device lock (``utils/devlock.py``) for its life; on
the CPU (``--device cpu``) it takes none.

Run:   python -m aswstereomatch_torch.tools.serve --port 9444
Test:  python -m aswstereomatch_torch.tools.serve --self-test
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..config import StereoConfig, get_preset
from ..models import pipeline
from ..utils import devlock, evaluate, synthetic


def _recv_exact(sock, n: int) -> bytearray:
    """``n`` bytes from ``sock``, received in place into one writable buffer
    (the request tensors are built on it without a copy).  ``n`` must be
    validated first: the buffer is allocated before the bytes arrive."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed mid-message")
        got += k
    return buf


def send_request(sock, left: np.ndarray, right: np.ndarray, config: dict,
                 dtype: str = "float32", response_dtype: str = "float32",
                 confidence: bool = False):
    """One request/response round trip.

    Returns ``(disp, rheader)``, or with ``confidence=True``
    ``(disp, rheader, uniq_pct, lr_valid)``: the per-pixel WTA-uniqueness
    margin (float32, percent) and LR-validity mask, so the caller picks its
    coverage operating point by thresholding."""
    header = {
        "height": left.shape[0],
        "width": left.shape[1],
        "channels": 1 if left.ndim == 2 else left.shape[2],
        "config": config,
        "dtype": dtype,
        "response_dtype": response_dtype,
        "confidence": confidence,
    }
    wire = np.dtype(dtype)
    hb = json.dumps(header).encode()
    # One send: split small writes wait on the peer's delayed ACK (Nagle).
    sock.sendall(b"".join([struct.pack("<I", len(hb)), hb,
                           np.ascontiguousarray(left, wire).tobytes(),
                           np.ascontiguousarray(right, wire).tobytes()]))
    rlen = struct.unpack("<I", _recv_exact(sock, 4))[0]
    rheader = json.loads(_recv_exact(sock, rlen))
    if rheader.get("status") != "ok":
        raise RuntimeError(rheader.get("message", "server error"))
    h, w = rheader["height"], rheader["width"]
    if rheader.get("dtype") == "uint16_x256":
        raw = np.frombuffer(_recv_exact(sock, h * w * 2), np.uint16)
        disp = (raw.astype(np.float32) / 256.0).reshape(h, w)
    else:
        disp = np.frombuffer(_recv_exact(sock, h * w * 4), np.float32).reshape(h, w)
    if rheader.get("confidence"):
        uniq = np.frombuffer(_recv_exact(sock, h * w * 4), np.float32).reshape(h, w)
        lrv = np.frombuffer(_recv_exact(sock, h * w), np.uint8).reshape(h, w).astype(bool)
        return disp, rheader, uniq, lrv
    return disp, rheader


def encode_u16(disp):
    """The "uint16_x256" encoding of a float32 disparity tensor, on its own
    device: ``clip(round(d * 256), 0, 65535)`` as uint16, rounding half to
    even (the reference's ``jnp.round``).  Round and clamp run in float32;
    only the final cast is to uint16, which PyTorch supports on the card."""
    return torch.clamp(torch.round(disp * 256.0), 0.0, 65535.0).to(torch.uint16)


# Protocol limits (see the module docstring), all checked BEFORE any
# allocation sized by a client integer.
MAX_HEADER_LEN = 1 << 20      # 1 MiB of config JSON is absurdly generous
MAX_DIM = 16384               # per image axis
MAX_BODY_BYTES = 1 << 28      # per image plane (256 MiB)


class _ProtocolError(ValueError):
    """Malformed framing/limits: respond, then DROP the connection (the
    stream position past the violation can no longer be trusted)."""


def _dim(header: dict, key: str, lo: int, hi: int) -> int:
    v = header.get(key)
    if isinstance(v, bool) or not isinstance(v, int) or not lo <= v <= hi:
        raise _ProtocolError(f"{key} must be an integer in [{lo}, {hi}], got {v!r}")
    return v


def _read_request(sock):
    """Read one request: ``(header, left, right)``, the images as numpy
    arrays on writable buffers; ``_ProtocolError`` on a framing or limit
    violation, ``ConnectionError`` / ``OSError`` when the peer is gone."""
    hlen = struct.unpack("<I", _recv_exact(sock, 4))[0]
    if not 0 < hlen <= MAX_HEADER_LEN:
        raise _ProtocolError(f"header_len {hlen} outside (0, {MAX_HEADER_LEN}]")
    try:
        header = json.loads(_recv_exact(sock, hlen))
    except (ValueError, UnicodeDecodeError):
        raise _ProtocolError("header is not valid JSON") from None
    if not isinstance(header, dict):
        raise _ProtocolError("header must be a JSON object")
    h = _dim(header, "height", 1, MAX_DIM)
    w = _dim(header, "width", 1, MAX_DIM)
    c = _dim(header, "channels", 1, 3)
    if c == 2:
        raise _ProtocolError("channels must be 1 or 3")
    try:
        wire = np.dtype(header.get("dtype", "float32"))
    except TypeError:
        raise _ProtocolError("unparseable wire dtype") from None
    if wire not in (np.dtype(np.float32), np.dtype(np.uint8)):
        # The body length depends on the dtype: an unknown one desyncs the
        # stream, so this is a drop, not a keep.
        raise _ProtocolError(f"unsupported wire dtype {wire}")
    n = h * w * c * wire.itemsize
    if n > MAX_BODY_BYTES:
        raise _ProtocolError(f"image plane {n} bytes exceeds cap {MAX_BODY_BYTES}")
    shape = (h, w) if c == 1 else (h, w, c)
    left = np.frombuffer(_recv_exact(sock, n), wire).reshape(shape)
    right = np.frombuffer(_recv_exact(sock, n), wire).reshape(shape)
    return header, left, right


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        self.request.settimeout(srv.idle_timeout)
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            drop = False
            try:
                try:
                    header, left, right = _read_request(self.request)
                except (ConnectionError, OSError, struct.error):
                    return  # peer closed, stalled past the idle timeout, reset
                rheader, body = srv.answer(header, left, right)
            except _ProtocolError as e:  # report, then drop the connection
                rheader = {"status": "error", "message": f"protocol: {e}"}
                body = b""
                drop = True
            except Exception as e:  # body consumed cleanly: report, keep serving
                rheader = {"status": "error", "message": f"{type(e).__name__}: {e}"}
                body = b""
            hb = json.dumps(rheader).encode()
            try:  # one send (see send_request)
                self.request.sendall(struct.pack("<I", len(hb)) + hb + body)
            except (ConnectionError, OSError):
                return
            # After the answer is sent: past the RSS limit the main thread
            # exits at once, and an answer still unsent would be lost.
            srv.check_rss()
            if drop:
                return


class Server(socketserver.ThreadingTCPServer):
    """The daemon: ``serve_forever()`` answers requests on ``addr`` with
    matchers on ``device`` ("cuda", the default, raises without a card)."""

    allow_reuse_address = True
    daemon_threads = True

    # Past the RSS limit the server finishes the in-flight response, closes
    # the listener and exits with this code for a supervisor loop to
    # restart it (`while :; do python -m aswstereomatch_torch.tools.serve;
    # [ $? -eq 42 ] || break; done`).
    RSS_EXIT_CODE = 42

    def __init__(self, addr, device: str = "cuda", max_rss_mb: float = 8192,
                 idle_timeout: float = 300.0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("serve --device cuda needs a CUDA device; pass "
                               "--device cpu to serve from the CPU")
        super().__init__(addr, _Handler)
        self.max_rss_mb = max_rss_mb
        self.idle_timeout = idle_timeout
        self.recycling = False
        self._matchers: dict = {}
        self._matchers_lock = threading.Lock()

    def matcher(self, cfg, confidence: bool):
        """The ``StereoMatcher`` kept for (config hash, confidence)."""
        key = (cfg.config_hash(), confidence)
        with self._matchers_lock:
            if key not in self._matchers:
                self._matchers[key] = pipeline.StereoMatcher(cfg, device=self.device)
            return self._matchers[key]

    def answer(self, header: dict, left: np.ndarray, right: np.ndarray):
        """``(response header, body bytes)`` for one parsed request; raises
        on a bad config or response dtype (the connection stays)."""
        cdict = dict(header.get("config", {}))
        preset = cdict.pop("preset", None)
        cfg = get_preset(preset).replace(**cdict) if preset is not None else StereoConfig(**cdict)
        want_conf = bool(header.get("confidence", False))
        rdtype = header.get("response_dtype", "float32")
        if rdtype not in ("float32", "uint16_x256"):
            raise ValueError(f"unsupported response_dtype {rdtype}")
        m = self.matcher(cfg, want_conf)
        t0 = time.perf_counter()
        l_dev = torch.from_numpy(left).to(self.device)
        r_dev = torch.from_numpy(right).to(self.device)
        planes = []
        if want_conf:
            disp, uniq, lrv = pipeline.match_pair_with_confidence(
                l_dev.to(torch.float32), r_dev.to(torch.float32), m.cfg)
            planes = [uniq.to(torch.float32), lrv.to(torch.uint8)]
        else:
            disp = m(l_dev, r_dev)
        if rdtype == "uint16_x256":
            disp = encode_u16(disp)
        host = [t.cpu().numpy() for t in (disp, *planes)]  # waits for the card
        rheader = {
            "status": "ok",
            "height": host[0].shape[0],
            "width": host[0].shape[1],
            "elapsed_ms": round(1e3 * (time.perf_counter() - t0), 2),
            "dtype": rdtype,
            "confidence": want_conf,
        }
        return rheader, b"".join(a.tobytes() for a in host)

    def check_rss(self):
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        rss_mb = int(line.split()[1]) / 1024
                        break
                else:
                    return
        except OSError:
            return
        if rss_mb > self.max_rss_mb and not self.recycling:
            self.recycling = True
            print(
                f"RSS {rss_mb:.0f} MB > limit {self.max_rss_mb} MB; "
                f"recycling (exit {self.RSS_EXIT_CODE})",
                file=sys.stderr, flush=True,
            )
            # shutdown() joins the serve_forever loop, so it must come from
            # another thread; main() then exits with RSS_EXIT_CODE.
            threading.Thread(target=self.shutdown, daemon=True).start()


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def self_test(device: str) -> int:
    """Spawn the daemon on a free port, send a few requests, check them."""
    # The daemon's output goes to a file, not a pipe, which nothing drains.
    log = tempfile.NamedTemporaryFile(prefix="stereo_serve_", suffix=".log", delete=False)
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aswstereomatch_torch.tools.serve", "--port", "0",
         "--device", device], stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        port = wait_for_port(log.name, proc, timeout_s=60)
        pair = synthetic.make_pair(height=48, width=64, max_disparity=8, seed=0)
        cfgdict = dict(max_disparity=8, aggregation="asw", window_radius=2)
        with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
            d1, h1 = send_request(sock, pair["left"], pair["right"], cfgdict)
            d2, h2 = send_request(sock, pair["left"], pair["right"], cfgdict)
            bad2 = evaluate.bad_delta(d1, pair["gt"], 2.0, ~pair["occluded"])
            if not (np.array_equal(d1, d2) and bad2 < 0.05):
                raise AssertionError(f"repeat equal {np.array_equal(d1, d2)}, bad_2 {bad2}")
            try:  # the error path keeps the connection
                send_request(sock, pair["left"], pair["right"], {"aggregation": "bogus"})
                raise AssertionError("expected an error response")
            except RuntimeError as e:
                if "bogus" not in str(e):
                    raise
            d3, _ = send_request(sock, pair["left"], pair["right"], cfgdict)
            if not np.array_equal(d3, d1):
                raise AssertionError("the request after an error differs")
        print(json.dumps({"self_test": "ok", "device": device, "bad_2": round(float(bad2), 5),
                          "first_ms": h1["elapsed_ms"], "second_ms": h2["elapsed_ms"]}))
        return 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()


def wait_for_port(log_path: str, proc, timeout_s: float) -> int:
    """The port a daemon started with ``--port 0`` listens on, read from
    the "serving on HOST:PORT" line of its log."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(log_path) as f:
            for line in f:
                if line.startswith("serving on "):
                    return int(line.rsplit(":", 1)[1])
        if proc.poll() is not None:
            with open(log_path) as f:
                raise RuntimeError(f"serve exited with {proc.returncode}:\n{f.read()[-4000:]}")
        time.sleep(0.1)
    raise TimeoutError(f"serve did not come up in {timeout_s} s")


def _serve(args) -> "Server":
    srv = Server((args.host, args.port), device=args.device, max_rss_mb=args.max_rss_mb,
                 idle_timeout=args.idle_timeout)
    print(f"serving on {srv.server_address[0]}:{srv.server_address[1]}", flush=True)
    srv.serve_forever()
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9444, help="0 picks a free port")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where requests run: the card (default; exits non-zero "
                         "without one) or the CPU's plain PyTorch path")
    ap.add_argument("--max-rss-mb", type=float, default=8192,
                    help="self-recycle (exit 42) past this host RSS; a "
                    "supervisor loop restarts the stateless daemon")
    ap.add_argument("--idle-timeout", type=float, default=300.0,
                    help="per-connection socket idle timeout in seconds; a "
                    "stalled client releases its handler thread")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test(args.device)
    if args.device == "cpu":
        srv = _serve(args)
    else:
        if not torch.cuda.is_available():
            print("serve --device cuda needs a CUDA device; pass --device cpu to "
                  "serve from the CPU", file=sys.stderr)
            return 1
        # Hold the card for the daemon's life: a sweep started beside a live
        # server fails fast, naming it, instead of sharing the card unseen.
        with devlock.device_lock("serve", timeout_s=60):
            srv = _serve(args)
    if srv.recycling:
        os._exit(Server.RSS_EXIT_CODE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
