"""The port's serving daemon (``aswstereomatch_torch.tools.serve``) over a
real socket on the CPU: every case of tests/test_serve.py, the answers
against the port's ``match_pair`` (bit for bit) and the reference's
``match_pair(..., backend="jnp")`` (the pipeline bars of
tests/test_oracle_parity.py:141-143), the reference's own client against
the port's server, and the uint16_x256 encoding against the reference's jnp
expression bit for bit.  The servers run in threads of this process."""

import importlib.util
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline

from aswstereomatch_torch.config import StereoConfig
from aswstereomatch_torch.models import pipeline
from aswstereomatch_torch.tools import serve
from aswstereomatch_torch.utils import evaluate, synthetic

REPO = Path(__file__).resolve().parents[1]


def _reference_client():
    """tools/serve.py of the reference (its module level imports no jax)."""
    spec = importlib.util.spec_from_file_location("ref_tools_serve", REPO / "tools" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_serve = _reference_client()

CFG_ASW = dict(max_disparity=8, aggregation="asw", window_radius=2, backend="eager")
CFG_BOX = dict(max_disparity=8, aggregation="box", window_radius=2, lr_check=False,
               fill_holes=False, subpixel=False, median_filter=False, cost="ad",
               backend="eager")
CFG_REFUSE = dict(max_disparity=8, aggregation="asw", window_radius=2, lr_check=True,
                  fill_holes=False, subpixel=True, median_filter=False, backend="eager")


class _Running:
    def __init__(self, **kw):
        self.server = serve.Server(("127.0.0.1", 0), device="cpu", **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def connect(self, timeout=120):
        return socket.create_connection(("127.0.0.1", self.port), timeout=timeout)

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def server():
    running = _Running()
    yield running
    running.stop()


def _pair(seed=0, h=32, w=48):
    return synthetic.make_pair(height=h, width=w, max_disparity=8, seed=seed)


def _here(pair, cfgd):
    """The port's match_pair on the same inputs, in this process."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return pipeline.match_pair(t(pair["left"]), t(pair["right"]), StereoConfig(**cfgd)).numpy()


def _jnp_u16(d):
    """The reference's device encoding (tools/serve.py, tools/sweep.py)."""
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(d) * 256.0), 0, 65535).astype(jnp.uint16))


def test_serve_end_to_end(server):
    pair = _pair()
    with server.connect() as sock:
        d1, h1 = serve.send_request(sock, pair["left"], pair["right"], CFG_ASW)
        d2, h2 = serve.send_request(sock, pair["left"], pair["right"], CFG_ASW)
        assert np.array_equal(d1, d2)
        assert h1["status"] == "ok" and h1["elapsed_ms"] > 0 and h1["confidence"] is False
        np.testing.assert_array_equal(d1, _here(pair, CFG_ASW))
        assert evaluate.bad_delta(d1, pair["gt"], 2.0, ~pair["occluded"]) < 0.05
        with pytest.raises(RuntimeError, match="bogus"):
            serve.send_request(sock, pair["left"], pair["right"], {"aggregation": "bogus"})
        d3, _ = serve.send_request(sock, pair["left"], pair["right"], CFG_ASW)
        assert np.array_equal(d3, d1)
        # uint8 wire: lossless for the integral synthetic pair
        du, _ = serve.send_request(sock, pair["left"].astype(np.uint8),
                                   pair["right"].astype(np.uint8), CFG_ASW, dtype="uint8")
        assert np.array_equal(du, d1)
        # preset + override config
        dp, _ = serve.send_request(sock, pair["left"], pair["right"],
                                   {"preset": "tsukuba_ad_box", "max_disparity": 8,
                                    "window_radius": 2})
        assert dp.shape == d1.shape
        # uint16_x256: the reference's encoding of the f32 answer, exactly
        du16, hu = serve.send_request(sock, pair["left"], pair["right"], CFG_ASW,
                                      response_dtype="uint16_x256")
        assert hu["dtype"] == "uint16_x256"
        np.testing.assert_array_equal(du16, _jnp_u16(d1).astype(np.float32) / 256.0)
        valid = d1 >= 0
        assert np.max(np.abs(du16 - d1)[valid]) <= 1 / 512 + 1e-6
        with pytest.raises(RuntimeError, match="response_dtype"):
            serve.send_request(sock, pair["left"], pair["right"], CFG_ASW,
                               response_dtype="float16")
        dg, _ = serve.send_request(sock, pair["left"][..., 0], pair["right"][..., 0], CFG_BOX)
        assert dg.shape == d1.shape  # one-channel images


@pytest.mark.parametrize("cfgd", [CFG_ASW, CFG_BOX, dict(CFG_ASW, asw_separable=True)],
                         ids=["asw_full", "ad_box", "asw_separable"])
def test_serve_agrees_with_reference_pipeline(server, cfgd):
    pair = synthetic.make_pair(height=40, width=56, max_disparity=8, seed=3)
    with server.connect() as sock:
        d, _ = serve.send_request(sock, pair["left"], pair["right"], cfgd)
    np.testing.assert_array_equal(d, _here(pair, cfgd))
    ref_cfg = RefConfig(**dict(cfgd, backend="jnp"))
    d_ref = np.asarray(ref_pipeline.match_pair(jnp.asarray(pair["left"]),
                                               jnp.asarray(pair["right"]), ref_cfg))
    diff = np.abs(d - d_ref)
    assert np.mean(diff <= 0.51) > 0.995
    assert np.mean(diff > 2.0) < 0.002


@pytest.mark.parametrize("kw", [{}, {"dtype": "uint8"},
                                {"response_dtype": "uint16_x256"},
                                {"confidence": True},
                                {"response_dtype": "uint16_x256", "confidence": True}],
                         ids=["f32", "u8_wire", "u16", "confidence", "confidence_u16"])
def test_reference_client_gets_identical_bytes(server, kw):
    """The reference's send_request against the port's server: the same
    answer as the port's client (the wire is byte for byte the same)."""
    pair = _pair(seed=4)
    cfgd = CFG_REFUSE if kw.get("confidence") else CFG_ASW
    left, right = pair["left"], pair["right"]
    if kw.get("dtype") == "uint8":
        left, right = left.astype(np.uint8), right.astype(np.uint8)
    with server.connect() as sock:
        got_ref = ref_serve.send_request(sock, left, right, cfgd, **kw)
        got = serve.send_request(sock, left, right, cfgd, **kw)
    assert len(got_ref) == len(got) == (4 if kw.get("confidence") else 2)
    for a, b in zip(got_ref, got):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            assert {k: v for k, v in a.items() if k != "elapsed_ms"} == \
                   {k: v for k, v in b.items() if k != "elapsed_ms"}
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_u16_encoding_matches_jnp_bit_for_bit():
    rng = np.random.default_rng(0)
    halves = (np.arange(-8, 520) + 0.5) / 256.0        # exact halves of a step
    edges = np.array([-1.0, -1e-6, 0.0, 1 / 512, 255.99, 255.998, 256.0, 300.0, 1e6])
    rand = rng.uniform(-2, 300, 4096)
    d = np.concatenate([halves, edges, rand]).astype(np.float32)
    got = serve.encode_u16(torch.from_numpy(d))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), _jnp_u16(d))
    assert got.numpy().tobytes() == _jnp_u16(d).tobytes()


def _read_response(sock):
    rlen = struct.unpack("<I", serve._recv_exact(sock, 4))[0]
    return json.loads(serve._recv_exact(sock, rlen))


def _assert_closed(sock):
    sock.settimeout(10)
    assert sock.recv(1) == b""


def _header(h):
    hb = json.dumps(h).encode()
    return struct.pack("<I", len(hb)) + hb


MALFORMED = {
    "oversized_header_len": (struct.pack("<I", 0xFFFFFFFF), "header_len"),
    "zero_header_len": (struct.pack("<I", 0), "header_len"),
    "not_json": (struct.pack("<I", 8) + b"notjson!", "not valid JSON"),
    "not_object": (struct.pack("<I", 4) + b"[12]", "JSON object"),
    "huge_height": (_header({"height": 1 << 30, "width": 64, "channels": 1}), "height"),
    "negative_width": (_header({"height": 64, "width": -3, "channels": 1}), "width"),
    "nine_channels": (_header({"height": 64, "width": 64, "channels": 9}), "channels"),
    "two_channels": (_header({"height": 64, "width": 64, "channels": 2}), "channels"),
    "string_height": (_header({"height": "64", "width": 64, "channels": 1}), "height"),
    "bool_height": (_header({"height": True, "width": 64, "channels": 1}), "height"),
    "missing_dims": (_header({"config": {}}), "height"),
    "float64_wire": (_header({"height": 4, "width": 4, "channels": 1, "dtype": "float64"}),
                     "wire dtype"),
    "list_dtype": (_header({"height": 4, "width": 4, "channels": 1, "dtype": [1, 2]}),
                   "dtype"),
    "over_body_cap": (_header({"height": 16384, "width": 16384, "channels": 3}),
                      "exceeds cap"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_serve_rejects_malformed_input(server, case):
    """Every malformed request gets an error response and a dropped
    connection, and the server stays alive for well-formed clients."""
    payload, expect = MALFORMED[case]
    with server.connect() as sock:
        sock.sendall(payload)
        rh = _read_response(sock)
        assert rh["status"] == "error" and expect in rh["message"], rh
        _assert_closed(sock)
    pair = _pair(h=16, w=24)
    with server.connect() as sock:
        disp, rh = serve.send_request(sock, pair["left"], pair["right"], CFG_BOX)
        assert rh["status"] == "ok" and disp.shape == (16, 24)


def test_serve_survives_truncated_body_and_keeps_config_errors(server):
    hb = json.dumps({"height": 8, "width": 8, "channels": 1}).encode()
    with server.connect() as sock:  # the client dies mid-image: no answer owed
        sock.sendall(struct.pack("<I", len(hb)) + hb + b"\x00" * 10)
    pair = _pair()
    with server.connect() as sock:
        disp, rh = serve.send_request(sock, pair["left"], pair["right"], CFG_BOX)
        assert rh["status"] == "ok" and disp.shape == (32, 48)
        # a bad CONFIG value (body consumed cleanly) keeps the connection
        with pytest.raises(RuntimeError, match="bogus"):
            serve.send_request(sock, pair["left"], pair["right"], {"aggregation": "bogus"})
        with pytest.raises(RuntimeError, match="unexpected keyword"):
            serve.send_request(sock, pair["left"], pair["right"], {"no_such_field": 1})
        disp2, _ = serve.send_request(sock, pair["left"], pair["right"], CFG_BOX)
        assert np.array_equal(disp2, disp)


def test_serve_idle_timeout_frees_handler():
    running = _Running(idle_timeout=1.0)
    try:
        with running.connect() as sock:
            t0 = time.time()
            sock.settimeout(30)
            assert sock.recv(1) == b""  # EOF after ~1 s of silence
            assert time.time() - t0 < 25
        pair = _pair(seed=1, h=16, w=32)
        with running.connect() as sock:
            _, rh = serve.send_request(sock, pair["left"], pair["right"], CFG_BOX)
            assert rh["status"] == "ok"
    finally:
        running.stop()


def test_serve_confidence_response(server):
    """"confidence": true appends the uniqueness margin and the LR mask;
    thresholding them reproduces the uniqueness_ratio gate, and they equal
    match_pair_with_confidence's planes."""
    pair = _pair(seed=2)
    with server.connect() as sock:
        disp, rh, uniq, lrv = serve.send_request(sock, pair["left"], pair["right"],
                                                 CFG_REFUSE, confidence=True)
        assert rh["confidence"] is True
        assert uniq.shape == disp.shape == lrv.shape == (32, 48)
        assert uniq.dtype == np.float32 and lrv.dtype == bool
        np.testing.assert_array_equal(lrv, disp >= 0)
        gated, _ = serve.send_request(sock, pair["left"], pair["right"],
                                      dict(CFG_REFUSE, uniqueness_ratio=10.0))
        np.testing.assert_array_equal(lrv & (uniq >= 10.0), gated >= 0)
        assert 0.3 < float(np.mean(gated >= 0)) < 1.0
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    want = pipeline.match_pair_with_confidence(t(pair["left"]), t(pair["right"]),
                                               StereoConfig(**CFG_REFUSE))
    for got, w in zip((disp, uniq, lrv), want):
        np.testing.assert_array_equal(got, w.numpy())


def test_serve_confidence_with_u16_response(server):
    pair = _pair(seed=5, h=24, w=40)
    with server.connect() as sock:
        d16, rh, uniq, lrv = serve.send_request(sock, pair["left"], pair["right"], CFG_REFUSE,
                                                response_dtype="uint16_x256", confidence=True)
        assert rh["dtype"] == "uint16_x256" and rh["confidence"] is True
        df, _, uniq2, lrv2 = serve.send_request(sock, pair["left"], pair["right"], CFG_REFUSE,
                                                confidence=True)
    np.testing.assert_array_equal(uniq, uniq2)
    np.testing.assert_array_equal(lrv, lrv2)
    valid = df >= 0
    assert np.max(np.abs(d16 - df)[valid]) <= 1 / 512 + 1e-6
    assert np.all(d16[~valid] == 0)


def test_serve_keeps_one_matcher_per_config_and_confidence(server):
    pair = _pair(seed=6, h=16, w=24)
    before = dict(server.server._matchers)
    with server.connect() as sock:
        for conf in (False, True, False, True):
            serve.send_request(sock, pair["left"], pair["right"],
                               dict(CFG_BOX, window_radius=1), confidence=conf)
    new = set(server.server._matchers) - set(before)
    h = StereoConfig(**dict(CFG_BOX, window_radius=1)).config_hash()
    assert new == {(h, False), (h, True)}


def test_serve_rss_limit_recycles():
    """Past --max-rss-mb the server answers, then stops serving."""
    running = _Running(max_rss_mb=1)
    pair = _pair(seed=7, h=16, w=24)
    with running.connect() as sock:
        _, rh = serve.send_request(sock, pair["left"], pair["right"], CFG_BOX)
    assert rh["status"] == "ok"
    running.thread.join(timeout=30)
    assert not running.thread.is_alive() and running.server.recycling
    running.server.server_close()


def _spawn(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "aswstereomatch_torch.tools.serve", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_serve_module_exits_42_past_the_rss_limit(tmp_path):
    log = open(tmp_path / "serve.log", "w")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "aswstereomatch_torch.tools.serve",
                             "--device", "cpu", "--port", "0", "--max-rss-mb", "1"],
                            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        port = serve.wait_for_port(log.name, proc, timeout_s=120)
        pair = _pair(seed=8, h=16, w=24)
        with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
            _, rh = serve.send_request(sock, pair["left"], pair["right"], CFG_BOX)
        assert rh["status"] == "ok"
        assert proc.wait(timeout=60) == serve.Server.RSS_EXIT_CODE
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert "recycling" in (tmp_path / "serve.log").read_text()


def test_serve_self_test_on_cpu():
    proc = _spawn("--self-test", "--device", "cpu", timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["self_test"] == "ok" and rec["device"] == "cpu" and rec["bad_2"] < 0.05


def test_serve_on_cuda_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the machine without one")
    assert serve.main(["--port", "0"]) != 0
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve.Server(("127.0.0.1", 0))


def test_request_buffers_are_writable():
    """The request tensors are built on the received buffers without a copy
    and without PyTorch's read-only warning."""
    a, b = socket.socketpair()
    with a, b:
        hb = json.dumps({"height": 2, "width": 3, "channels": 1, "dtype": "uint8"}).encode()
        a.sendall(struct.pack("<I", len(hb)) + hb + bytes(range(6)) + bytes(range(6, 12)))
        header, left, right = serve._read_request(b)
    assert left.flags.writeable and right.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = torch.from_numpy(left)
    assert t.tolist() == [[0, 1, 2], [3, 4, 5]] and header["dtype"] == "uint8"
