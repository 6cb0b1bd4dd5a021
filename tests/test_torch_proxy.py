"""The port's fuzzing proxy (erlamsa_tpu_torch/services/proxy.py) against
the JAX package's on the CPU.

- The host logic: both packages' ``_fuzz_maybe`` with one stub batcher,
  over packet sequences of tcp, http and http2 (the coin's gates,
  raise_prob, the HTTP split and Content-Length fixup, the HTTP/2
  framer).
- The device bytes: a loopback tcp:// proxy at -P 1.0,0.0 on the port's
  device batcher (4 rows x 256 B, the plain path), each packet's answer
  == the JAX request step for (seed, rid) at that width, at levels 0 and
  2 (one JAX compile a level); a packet over the width == the JAX oracle.
- Each protocol once on loopback (udp, connect, http2, serial over ptys,
  tls), the serial ``stop()`` repaired (the JAX one raises
  AttributeError), and the CLI's -i in a process of its own.

Every socket and thread is closed in a ``finally``; every blocking wait
has its own timeout.
"""

import os
import select
import shutil
import socket
import ssl
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from erlamsa_tpu.models import http2 as Jhttp2
from erlamsa_tpu.ops import prng as Jprng
from erlamsa_tpu.ops import slots as Jslots
from erlamsa_tpu.services import proxy as Jproxy
from erlamsa_tpu.services import supervisor as Jsupervisor
from erlamsa_tpu_torch.ops import prng as Tprng
from erlamsa_tpu_torch.ops import slots as Tslots
from erlamsa_tpu_torch.services import proxy as Tproxy

torch.set_num_threads(1)  # the plain path is small; leave the cores to jax

SEED = (1, 2, 3)
CAP, ROWS = 256, 4  # the port's batcher width in these tests
WAIT = 60.0  # every blocking wait's own bound
OPTS = {"seed": SEED, "workers": 1}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def small_proxy(spec, probs, level=0, **kw):
    """The port's proxy on its device batcher, at the test width, on the
    CPU."""
    return Tproxy.FuzzProxy(spec, probs, dict(OPTS), device="cpu",
                            level=level, batch=ROWS, capacity=CAP, **kw)


def record_fuzz(proxy):
    """[(direction, packet, output)] of every ``_fuzz_maybe`` call."""
    log = []
    real = proxy._fuzz_maybe

    def wrapped(data, prob, npacket, direction, conn_state):
        out = real(data, prob, npacket, direction, conn_state)
        log.append((direction, data, out))
        return out

    proxy._fuzz_maybe = wrapped
    return log


def record_batcher(proxy):
    """[(packet, answer)] of every batcher call, in order."""
    log = []
    real = proxy.batcher.fuzz

    def fuzz(data, opts, timeout=90.0):
        out = real(data, opts, timeout)
        log.append((data, out))
        return out

    proxy.batcher.fuzz = fuzz
    return log


class Upstream:
    """A loopback TCP server that records everything one connection
    sends, until EOF; ``wrap`` (an SSLContext) makes it a TLS server."""

    def __init__(self, wrap=None):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.sock.settimeout(WAIT)
        self.port = self.sock.getsockname()[1]
        self.wrap = wrap
        self.data = b""
        self.error = None
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            conn, _ = self.sock.accept()
            conn.settimeout(WAIT)
            if self.wrap is not None:
                conn = self.wrap.wrap_socket(conn, server_side=True)
            with conn:
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    self.data += chunk
        except OSError as e:
            self.error = e
        finally:
            self.done.set()

    def result(self) -> bytes:
        assert self.done.wait(WAIT), "the upstream never saw EOF"
        assert self.error is None, self.error
        return self.data

    def close(self):
        self.sock.close()
        self.thread.join(WAIT)


# ---- host logic -------------------------------------------------------------


def test_spec_probability_and_http_helpers_equal():
    specs = ["tcp://4000:target.host:80", "udp://1:h:2", "http2://9:h:443",
             "connect://8080::", "tls://1:localhost:2",
             "serial:///dev/ttyS0@9600:/dev/ttyS1@115200", "tcp://nope",
             "serial:///dev/ttyS0", "tcp://1:h:", "tcp://x:h:1"]

    def outcome(fn, *a):
        try:
            return ("ok", fn(*a))
        except (SystemExit, ValueError) as e:
            return (type(e).__name__, str(e))

    for s in specs:
        assert outcome(Tproxy.parse_proxy_spec, s) == \
            outcome(Jproxy.parse_proxy_spec, s)
    for p in ["0.1,0.1", "1.0", "0.3,", "0.5,0.25", "x,1"]:
        assert outcome(Tproxy.parse_probs, p) == outcome(Jproxy.parse_probs, p)
    rng = np.random.default_rng(21)
    for _ in range(200):
        prob, ascent = float(rng.random()), float(rng.uniform(-1, 2))
        assert Tproxy.raise_prob(prob, ascent) == Jproxy.raise_prob(prob, ascent)
        head = b"POST /%d HTTP/1.1\r\nHost: x" % int(rng.integers(0, 99))
        if rng.integers(0, 2):
            head += b"\r\ncontent-LENGTH: %d" % int(rng.integers(0, 99))
        body = rng.integers(0, 256, int(rng.integers(0, 30)),
                            dtype=np.uint8).tobytes()
        raw = head + b"\r\n\r\n" + body if rng.integers(0, 4) else body
        assert Tproxy._split_http(raw) == Jproxy._split_http(raw)
        assert Tproxy._pack_http(head, body) == Jproxy._pack_http(head, body)


class StubBatcher:
    """One deterministic batcher for both packages: reversed bytes plus a
    length byte, every third packet emptied; the opts it was handed are
    kept."""

    def __init__(self):
        self.opts = []

    def fuzz(self, data, opts, timeout=90.0):
        self.opts.append(opts)
        if len(data) % 3 == 2:
            return b""
        return data[::-1] + bytes([len(data) & 0xFF])


def _packets(proto, rng, count=40):
    """(direction, packet) pairs of one connection."""
    if proto == "http2":
        from test_torch_http2 import _frame_stream

        pieces = {}
        for direction, seed in (("c->s", 31), ("s->c", 32)):
            stream = _frame_stream(seed)
            cuts = sorted(rng.integers(0, len(stream), 12))
            pieces[direction] = [stream[a:b] for a, b in
                                 zip([0, *cuts], [*cuts, len(stream)])]
        # the two directions interleaved, each in its own order
        order = rng.permutation(["c->s"] * 13 + ["s->c"] * 13)
        return [(str(d), pieces[str(d)].pop(0)) for d in order]
    out = []
    for _ in range(count):
        direction = "c->s" if rng.integers(0, 2) else "s->c"
        body = rng.integers(0, 256, int(rng.integers(0, 40)),
                            dtype=np.uint8).tobytes()
        kind = int(rng.integers(0, 5))
        if proto != "http" or kind == 0:
            pkt = body or b"x"
        elif kind == 1:
            pkt = (b"POST /a HTTP/1.1\r\nHost: h\r\nContent-Length: %d\r\n\r\n"
                   % len(body) + body)
        elif kind == 2:
            pkt = b"GET /b HTTP/1.1\r\nHost: h\r\n\r\n" + body
        elif kind == 3:
            pkt = b"HTTP/1.1 200 OK\r\nServer: s\r\n\r\n" + body
        else:
            pkt = b"NOT-HTTP line\r\n\r\n" + body
        out.append((direction, pkt))
    return out


@pytest.mark.parametrize("proto,probs,bypass,ascent", [
    ("tcp", "0.5,0.3", 0, 0.0),
    ("tcp", "0.2,0.6", 3, 0.5),
    ("http", "0.7,0.4", 1, 0.0),
    ("http2", "0.6,0.5", 0, 0.25),
    ("http2", "1.0,0.0", 2, 0.0),
])
def test_fuzz_maybe_equals_jax(proto, probs, bypass, ascent):
    """The same packets through both packages' ``_fuzz_maybe``, a pump's
    bookkeeping (packet count, raise_prob) per direction: the outputs,
    the batcher's calls and the connection state are equal."""
    spec = f"{proto}://1:127.0.0.1:2"
    jp = Jproxy.FuzzProxy(spec, probs, dict(OPTS), bypass=bypass,
                          ascent=ascent)
    tp = Tproxy.FuzzProxy(spec, probs, dict(OPTS), backend="oracle",
                          bypass=bypass, ascent=ascent)
    jp.batcher, tp.batcher = StubBatcher(), StubBatcher()
    packets = _packets(proto, np.random.default_rng(
        zlib.crc32(f"{proto} {probs}".encode())))
    outs, states = {}, {}
    for name, px in (("jax", jp), ("port", tp)):
        n = {"c->s": 0, "s->c": 0}
        pcs = {"c->s": px.prob_cs, "s->c": px.prob_sc}
        state: dict = {}
        outs[name] = []
        for direction, pkt in packets:
            n[direction] += 1
            outs[name].append(px._fuzz_maybe(pkt, pcs[direction],
                                             n[direction], direction, state))
            pcs[direction] = Tproxy.raise_prob(pcs[direction], px.ascent)
        states[name] = state
    assert outs["port"] == outs["jax"]
    assert tp.batcher.opts == jp.batcher.opts
    assert states["port"].get("fuzzed") == states["jax"].get("fuzzed")
    assert states["jax"].get("fuzzed", 0) > 0
    assert outs["jax"] != [p for _d, p in packets]
    if proto == "http2":
        for d in ("c->s", "s->c"):
            js, ts = states["jax"][d], states["port"][d]
            assert (ts.remainder, ts.seen_headers) == \
                (js.remainder, js.seen_headers)


# ---- device bytes -------------------------------------------------------------


def _pairs_rows(pairs):
    data = np.zeros((len(pairs), CAP), np.uint8)
    lens = np.zeros(len(pairs), np.int32)
    for i, (_rid, p) in enumerate(pairs):
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    return np.array([r for r, _p in pairs], np.int32), data, lens


@pytest.fixture(scope="module", params=[0, 2], ids=["level0", "level2"])
def jax_step(request):
    """(level, run): JAX's flush request step at CAP, traced once under
    that level's ERLAMSA_PALLAS; ``run(pairs)`` answers (rid, packet)
    pairs."""
    level = request.param
    saved = os.environ.pop("ERLAMSA_PALLAS", None)
    if level:
        os.environ["ERLAMSA_PALLAS"] = str(level)
    try:
        step = Jslots.make_request_step(CAP, 8)
        base = Jprng.base_key(SEED)

        def run(pairs):
            outs = []
            for k in range(0, len(pairs), 8):
                chunk = list(pairs[k:k + 8])
                chunk += [(0, b"")] * (8 - len(chunk))
                out, n = step(base, *_pairs_rows(chunk))
                out, n = np.asarray(out), np.asarray(n)
                outs += [bytes(out[i, :int(n[i])]) for i in range(8)]
            return outs[:len(pairs)]

        run([(0, b"warm")])  # traced here, under this level
    finally:
        os.environ.pop("ERLAMSA_PALLAS", None)
        if saved is not None:
            os.environ["ERLAMSA_PALLAS"] = saved
    yield level, run


def _device_packets():
    """8 packets of 16-200 B (text, length-prefixed, binary) and one of
    300 B, over the width."""
    rng = np.random.default_rng(41)
    out = []
    for i, n in enumerate(rng.integers(16, 201, 8)):
        n = int(n)
        if i % 3 == 0:
            out.append((b"line %d value %d\n" % (i, n) * 20)[:n])
        elif i % 3 == 1:
            out.append(b"HD" + (n - 4).to_bytes(2, "big") +
                       rng.integers(65, 91, n - 4, dtype=np.uint8).tobytes())
        else:
            out.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    return out, rng.integers(0, 256, 300, dtype=np.uint8).tobytes()


def test_device_bytes_equal_jax_request_step(jax_step):
    """One connection, strict packet-by-packet: each packet's answer is
    the JAX request step's for (seed, rid) with rids in packet order, the
    over-width packet the JAX oracle's (it takes no request id), and the
    upstream got exactly the answers, in order."""
    from erlamsa_tpu.oracle.engine import fuzz as jax_oracle

    level, run = jax_step
    packets, big = _device_packets()
    seq = packets[:4] + [big] + packets[4:]
    up = Upstream()
    lport = free_port()
    proxy = small_proxy(f"tcp://{lport}:127.0.0.1:{up.port}", "1.0,0.0",
                        level=level)
    answers = record_batcher(proxy)
    try:
        proxy.start(block=False)
        with socket.create_connection(("127.0.0.1", lport),
                                      timeout=WAIT) as c:
            for i, pkt in enumerate(seq):
                c.sendall(pkt)
                wait_for(lambda: len(answers) == i + 1, f"packet {i}")
            c.shutdown(socket.SHUT_WR)
            forwarded = up.result()
    finally:
        proxy.stop()
        up.close()
    assert [d for d, _a in answers] == seq
    dev = [a for d, a in answers if len(d) <= CAP]
    assert dev == run(list(enumerate(packets)))
    esc = [a for d, a in answers if len(d) > CAP]
    assert esc == [jax_oracle(big, seed=SEED, workers=1)]
    assert forwarded == b"".join(a for _d, a in answers)
    st = proxy.batcher.stats()
    assert (st["admitted"], st["escapes"], st["failed"]) == (8, 1, 0)
    assert sum(a != d for d, a in answers) >= 6


# ---- each protocol once on loopback ------------------------------------------


def test_udp_both_directions():
    up = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    up.bind(("127.0.0.1", 0))
    up.settimeout(WAIT)
    seen = []

    def echo():
        try:
            for _ in range(3):
                data, addr = up.recvfrom(65536)
                seen.append(data)
                up.sendto(b"reply:" + data, addr)
        except OSError:
            pass

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    lport = free_port()
    proxy = small_proxy(f"udp://{lport}:localhost:{up.getsockname()[1]}",
                        "1.0,1.0")
    log = record_fuzz(proxy)
    c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    c.settimeout(WAIT)
    try:
        proxy.start(block=False)
        back = []
        for i in range(3):
            c.sendto(b"udp datagram %d 12345" % i, ("127.0.0.1", lport))
            back.append(c.recvfrom(65536)[0])
    finally:
        proxy.stop()
        c.close()
        up.close()
        t.join(WAIT)
    assert seen == [o for d, _p, o in log if d == "c->s"]
    assert back == [o for d, _p, o in log if d == "s->c"]
    assert [p for d, p, _o in log if d == "s->c"] == \
        [b"reply:" + s for s in seen]
    assert any(p != o for _d, p, o in log)


def test_connect_tunnel():
    up = Upstream()
    lport = free_port()
    proxy = small_proxy(f"connect://{lport}::", "1.0,0.0")
    log = record_fuzz(proxy)
    try:
        proxy.start(block=False)
        with socket.create_connection(("127.0.0.1", lport),
                                      timeout=WAIT) as c:
            c.sendall(b"CONNECT 127.0.0.1:%d HTTP/1.1\r\n\r\n" % up.port)
            assert b" 200 " in c.recv(1024)
            c.sendall(b"tunneled payload 123\n")
            wait_for(lambda: len(log) == 1, "the tunneled packet")
            c.shutdown(socket.SHUT_WR)
            forwarded = up.result()
    finally:
        proxy.stop()
        up.close()
    assert [(d, p) for d, p, _o in log] == [("c->s", b"tunneled payload 123\n")]
    assert forwarded == log[0][2] != log[0][1]


def test_http2_only_data_changes():
    from erlamsa_tpu_torch.models.hpack import HpackContext

    up = Upstream()
    lport = free_port()
    proxy = small_proxy(f"http2://{lport}:127.0.0.1:{up.port}", "1.0,0.0")
    answers = record_batcher(proxy)
    block = HpackContext().encode([(b":method", b"POST"), (b":path", b"/p")])
    frames = [(-1, 0, 0, Jhttp2.PREFACE),
              (Jhttp2.T_SETTINGS, 0, 0, bytes(6)),
              (Jhttp2.T_HEADERS, Jhttp2.F_END_HEADERS, 1, block),
              (Jhttp2.T_DATA, 0, 1, b"first data payload 42"),
              (Jhttp2.T_DATA, 1, 1, b"second one, END_STREAM")]
    wire = b"".join(Jhttp2.build_frame(*f) for f in frames)
    try:
        proxy.start(block=False)
        with socket.create_connection(("127.0.0.1", lport),
                                      timeout=WAIT) as c:
            cut = len(wire) - 30  # the last DATA frame split across packets
            c.sendall(wire[:cut])
            wait_for(lambda: len(answers) == 1, "the first DATA frame")
            c.sendall(wire[cut:])
            wait_for(lambda: len(answers) == 2, "the second DATA frame")
            c.shutdown(socket.SHUT_WR)
            forwarded = up.result()
    finally:
        proxy.stop()
        up.close()
    got, rem = Jhttp2.parse_frames(forwarded)
    assert rem == b""
    assert got[:3] == frames[:3]
    assert [(t, fl, s) for t, fl, s, _p in got[3:]] == \
        [(t, fl, s) for t, fl, s, _p in frames[3:]]
    assert [p for *_h, p in got[3:]] == [a for _d, a in answers]
    assert [d for d, _a in answers] == [frames[3][3], frames[4][3]]


def test_serial_stop_returns_where_the_jax_stop_raises():
    """Two pty pairs: the port's serial proxy forwards the fuzzed bytes
    and ``stop()`` returns with its loop ended; the JAX proxy's
    ``stop()`` raises AttributeError (it reads a tcp/udp listener that
    the serial path never opens)."""
    import pty

    fds = []
    try:
        m1, s1 = pty.openpty()
        m2, s2 = pty.openpty()
        fds += [m1, s1, m2, s2]
        spec = f"serial://{os.ttyname(s1)}@115200:{os.ttyname(s2)}@115200"
        proxy = small_proxy(spec, "1.0,0.0")
        log = record_fuzz(proxy)
        try:
            proxy.start(block=False)
            os.write(m1, b"serial fuzz 123\n")
            wait_for(lambda: log, "the serial packet")
            want = log[0][2]
            got = b""
            while len(got) < len(want):
                r, _w, _x = select.select([m2], [], [], WAIT)
                assert r, "nothing reached the second pty"
                got += os.read(m2, 4096)
        finally:
            t = time.monotonic()
            proxy.stop()
            stop_s = time.monotonic() - t
        assert got == want != b"serial fuzz 123\n"
        assert not proxy._thread.is_alive() and stop_s < 3.0

        m3, s3 = pty.openpty()
        m4, s4 = pty.openpty()
        fds += [m3, s3, m4, s4]
        jspec = f"serial://{os.ttyname(s3)}@115200:{os.ttyname(s4)}@115200"
        jp = Jproxy.FuzzProxy(jspec, "1.0,0.0", dict(OPTS)).start(block=False)
        with pytest.raises(AttributeError):
            jp.stop()
        wait_for(lambda: not Jsupervisor.thread_stats()
                 ["fuzzproxy-serial"]["alive"], "the JAX serial loop")
    finally:
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass


@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl is not on PATH")
def test_tls_mitm(tmp_path):
    cert, key = tmp_path / "c.pem", tmp_path / "k.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
                    "ec_paramgen_curve:prime256v1", "-nodes", "-keyout",
                    str(key), "-out", str(cert), "-days", "1", "-subj",
                    "/CN=localhost"], check=True, capture_output=True,
                   timeout=WAIT)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(cert, key)
    up = Upstream(wrap=server_ctx)
    lport = free_port()
    proxy = Tproxy.FuzzProxy(
        f"tls://{lport}:localhost:{up.port}", "1.0,0.0",
        dict(OPTS, certfile=str(cert), keyfile=str(key)), device="cpu",
        level=0, batch=ROWS, capacity=CAP)
    log = record_fuzz(proxy)
    client_ctx = ssl.create_default_context()
    client_ctx.check_hostname = False
    client_ctx.verify_mode = ssl.CERT_NONE
    try:
        proxy.start(block=False)
        raw = socket.create_connection(("127.0.0.1", lport), timeout=WAIT)
        with client_ctx.wrap_socket(raw, server_hostname="localhost") as c:
            c.sendall(b"tls secret 0123456789\n")
            wait_for(lambda: log, "the TLS packet")
            c.shutdown(socket.SHUT_WR)
            forwarded = up.result()
    finally:
        proxy.stop()
        up.close()
    assert [(d, p) for d, p, _o in log] == [("c->s", b"tls secret 0123456789\n")]
    assert forwarded == log[0][2]


def test_cli_proxy_forwards_the_first_packet():
    """``python -m erlamsa_tpu_torch -i tcp://...`` in a process of its
    own forwards request id 0's bytes: the in-process proxy's answer to
    the same first packet (the single-shot request step)."""
    packet = b"cli proxy packet 1234567\n"
    step = Tslots.make_request_step(CAP, 1, device="cpu", level=0)
    out, n = step(Tprng.base_key(SEED), *_pairs_rows([(0, packet)]))
    want = bytes(out[0, :int(n[0])].numpy())
    up = Upstream()
    lport = free_port()
    env = {k: v for k, v in os.environ.items() if k != "ERLAMSA_PALLAS"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "erlamsa_tpu_torch", "-s", "1,2,3", "-i",
         f"tcp://{lport}:127.0.0.1:{up.port}", "-P", "1.0,0.0",
         "--capacity", str(CAP), "--device", "cpu"],
        cwd=repo, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + WAIT
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            try:
                c = socket.create_connection(("127.0.0.1", lport), timeout=WAIT)
                break
            except ConnectionRefusedError:
                assert time.monotonic() < deadline, "the CLI never listened"
                time.sleep(0.1)
        with c:
            c.sendall(packet)
            c.shutdown(socket.SHUT_WR)
            forwarded = up.result()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=WAIT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        up.close()
    assert forwarded == want


def test_proxy_runs_on_cuda_unless_asked():
    """With no card and no --device cpu, neither the CLI's -i nor
    FuzzProxy falls back to the CPU or the oracle: both refuse."""
    from erlamsa_tpu_torch.services import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["-s", "1,2,3", "-i", "tcp://1:127.0.0.1:2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Tproxy.FuzzProxy("tcp://1:127.0.0.1:2", "1.0", dict(OPTS))
