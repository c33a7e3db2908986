"""The client side of the serving daemon's wire protocol.

Copied from ``aswstereomatch_torch/tools/serve.py`` (``_recv_exact``,
``send_request``, ``wait_for_port``), which the program's own load test
(``tools/serve_bench.py``) uses, so that a change to the program's client
cannot move the benchmark's traffic.  Protocol (little-endian): request
``u32 header_len | header JSON | left bytes | right bytes``, response
``u32 header_len | header JSON | disparity bytes``.
"""

from __future__ import annotations

import json
import struct
import time

import numpy as np


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
