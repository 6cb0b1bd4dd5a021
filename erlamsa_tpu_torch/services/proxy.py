"""Fuzzing MitM proxy: TCP/UDP/HTTP pass-through with probabilistic
mutation of either direction (erlamsa_tpu/services/proxy.py), its
packets mutated on the card through the flush batcher.

Reference: src/erlamsa_fuzzproxy.erl — per-endpoint acceptor workers, c->s
and s->c fuzzing probabilities with an ascent coefficient (raise_prob),
first-K-packet bypass, HTTP header re-packing with Content-Length fixup,
and CONNECT-based TLS MitM. Spec forms (erlamsa_cmdparse proxy parsing):

    tcp://lport:rhost:rport
    udp://lport:rhost:rport
    http://lport:rhost:rport
    http2://lport:rhost:rport
    tls://lport:rhost:rport    (MitM: self-signed listener, TLS upstream;
                                cert/key via opts certfile/keyfile)
    connect://lport::          (standalone HTTP proxy: clients send
                                CONNECT host:port / absolute-URI requests;
                                the upstream target comes from the request,
                                like the reference's CONNECT MitM path,
                                src/erlamsa_fuzzproxy.erl:138-164)
    serial://dev1@baud:dev2@baud  (dual serial pass-through,
                                src/erlamsa_fuzzproxy.erl:202-224)

The default backend is the device one: a gated packet is a request of
``TpuBatcher`` (services/batcher.py; 256 rows x 16384 B, a 20 ms
deadline), so its bytes are the request step's for ``(seed, rid)``, with
request ids assigned in the order the packets reach the batcher. Packets
over the batcher's width take its oracle escape with the proxy's opts
(``-e`` mutations and ``post`` included). ``backend="oracle"`` runs every
packet on the host oracle instead. The gate's coin is
``random.Random(str(seed))``, as in the JAX package, so it depends on the
seed's string form (a tuple and a list give different gates).

``stop()`` ends every protocol's serve loop: it sets the stop event and
closes the listening socket and every open connection; the udp and
serial loops leave within their 1 s select and close their own
descriptors. It raises nothing (the JAX package's ``stop()`` raises
AttributeError on serial://, where it reads a listener that path never
opens).
"""

from __future__ import annotations

import random
import socket
import threading

from ..corpus import feedback
from ..utils.erlrand import gen_urandom_seed
from . import logger
from .batcher import make_batcher
from .supervisor import supervise

ACCEPT_POLL_S = 0.5  # the tcp accept loop looks at the stop event this often
STOP_JOIN_S = 3.0  # stop() waits this long for a non-blocking serve loop
READY_WAIT_S = 5.0  # start(block=False) waits this long for the listener
CONNECT_TIMEOUT_S = 10.0  # bounds an upstream connect and a CONNECT head read


def parse_proxy_spec(spec: str):
    proto, _, rest = spec.partition("://")
    if proto == "serial":
        parts = rest.split(":")
        if len(parts) != 2 or "@" not in parts[0] or "@" not in parts[1]:
            raise SystemExit(
                f"bad serial proxy spec {spec!r}; want serial://dev1@baud:dev2@baud"
            )
        return proto, parts[0], parts[1], 0
    parts = rest.split(":")
    if len(parts) != 3:
        raise SystemExit(f"bad proxy spec {spec!r}; want proto://lport:rhost:rport")
    if proto == "connect":
        # the upstream comes from each CONNECT/Host request; rhost:rport in
        # the spec are meaningless and stay empty
        return proto, int(parts[0]), "", 0
    if not parts[2]:
        raise SystemExit(f"bad proxy spec {spec!r}; missing rport")
    return proto, int(parts[0]), parts[1], int(parts[2])


def parse_probs(s: str) -> tuple[float, float]:
    a, _, b = s.partition(",")
    return float(a), float(b or a)


def raise_prob(prob: float, ascent: float) -> float:
    """Probability ascent per packet (erlamsa_fuzzproxy.erl:61-65)."""
    if ascent <= 0:
        return prob
    return min(1.0, prob + prob * ascent)


def _split_http(data: bytes):
    """(headers, body) or None when not HTTP-ish
    (erlamsa_netutils:extract_http, src/erlamsa_netutils.erl:154-174)."""
    sep = data.find(b"\r\n\r\n")
    if sep < 0:
        return None
    head = data[:sep]
    if b"HTTP/" not in head.split(b"\r\n", 1)[0]:
        return None
    return head, data[sep + 4 :]


def _pack_http(head: bytes, body: bytes) -> bytes:
    """Reassemble with Content-Length fixup
    (erlamsa_netutils:pack_http, src/erlamsa_netutils.erl:176-207)."""
    lines = head.split(b"\r\n")
    out = []
    had_cl = False
    for ln in lines:
        if ln.lower().startswith(b"content-length:"):
            out.append(b"Content-Length: %d" % len(body))
            had_cl = True
        else:
            out.append(ln)
    if not had_cl and body:
        out.append(b"Content-Length: %d" % len(body))
    return b"\r\n".join(out) + b"\r\n\r\n" + body


def _close(sock) -> None:
    """Shut a socket down both ways (which wakes a thread blocked in its
    recv or accept) and close it."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class FuzzProxy:
    """The proxy of one spec. ``device`` and ``level`` go to the device
    batcher (None: ``cuda`` and ERLAMSA_PALLAS); its step is built and
    warmed here, so a kernel that does not build fails the constructor.
    ``batch`` and ``capacity`` size that batcher."""

    def __init__(self, spec: str, probs: str = "0.1,0.1", opts: dict | None = None,
                 backend: str = "tpu", bypass: int = 0, ascent: float = 0.0,
                 device=None, level=None, batch: int = 256,
                 capacity: int = 16384):
        self.proto, self.lport, self.rhost, self.rport = parse_proxy_spec(spec)
        self.prob_cs, self.prob_sc = parse_probs(probs)
        self.opts = opts or {}
        self.bypass = bypass  # first K packets pass through (-k)
        self.ascent = ascent
        if self.proto == "tls" and not self.opts.get("certfile"):
            raise SystemExit(
                "tls:// proxy needs --certfile/--keyfile (generate with: "
                "openssl req -x509 -newkey rsa:2048 -nodes -keyout k.pem "
                "-out c.pem -days 30 -subj /CN=localhost)")
        self.batcher = make_batcher(backend, workers=self.opts.get("workers", 10),
                                    seed=self.opts.get("seed"), device=device,
                                    level=level, batch=batch, capacity=capacity)
        self._coin = random.Random(str(self.opts.get("seed") or gen_urandom_seed()))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._srv = None  # the tcp/udp listener, once bound
        self._conns: set = set()  # open connection sockets (tcp family)
        self._thread = None  # the supervised serve loop (block=False)
        self._ready = threading.Event()  # set once the endpoints are open

    def _fuzz_maybe(self, data: bytes, prob: float, npacket: int,
                    direction: str, conn_state: dict) -> bytes:
        """Probability gate + protocol-aware fuzz (fuzz_rnd,
        src/erlamsa_fuzzproxy.erl:309-324). HTTP/2 is special: EVERY packet
        must flow through the framer (its reassembly buffer owns partial
        frames), with the coin gating only whether DATA payloads mutate."""
        gate = npacket > self.bypass and self._coin.random() < prob
        if gate:
            # per-connection fuzz tally: an abnormal close AFTER a fuzzed
            # packet reads as a desync, not a routine drop (_pump)
            conn_state["fuzzed"] = conn_state.get("fuzzed", 0) + 1
        if self.proto == "http2":
            from ..models.http2 import Http2FuzzState, fuzz_http2

            st = conn_state.setdefault(direction, Http2FuzzState())
            fuzzer = (
                (lambda b: self.batcher.fuzz(b, dict(self.opts)))
                if gate
                else (lambda b: b)
            )
            out = fuzz_http2(fuzzer, data, st)
            del st.seen_headers[:-32]  # bounded observability buffer
            if gate:
                logger.log_data("info", "proxy fuzzed packet %d (%s)",
                                (npacket, direction), out)
            return out
        if not gate:
            return data
        if self.proto == "http":
            parts = _split_http(data)
            if parts is not None:
                head, body = parts
                fuzzed = self.batcher.fuzz(body, dict(self.opts)) if body else body
                out = _pack_http(head, fuzzed)
            else:
                out = self.batcher.fuzz(data, dict(self.opts))
        else:
            out = self.batcher.fuzz(data, dict(self.opts))
        logger.log_data("info", "proxy fuzzed packet %d (%s)",
                        (npacket, direction), out)
        return out

    # --- connection bookkeeping (so stop() can close what is open) --------

    def _track(self, *socks) -> bool:
        """Register open connection sockets; False (and the sockets
        closed) once the proxy is stopping."""
        with self._lock:
            if not self._stop.is_set():
                self._conns.update(socks)
                return True
        for s in socks:
            _close(s)
        return False

    def _release(self, *socks) -> None:
        with self._lock:
            self._conns.difference_update(socks)
        for s in socks:
            _close(s)

    def _start_pumps(self, client, server, conn_state: dict) -> None:
        """The connection's two pump threads; the last to end closes both
        sockets."""
        left = [2]
        lock = threading.Lock()

        def pump(src, dst, prob, direction):
            try:
                self._pump(src, dst, prob, direction, conn_state)
            finally:
                with lock:
                    left[0] -= 1
                    last = left[0] == 0
                if last:
                    self._release(client, server)

        for args in ((client, server, self.prob_cs, "c->s"),
                     (server, client, self.prob_sc, "s->c")):
            threading.Thread(target=pump, args=args, daemon=True).start()

    # --- TCP stream (loop_stream, erlamsa_fuzzproxy.erl:261-296) ----------

    def _pump(self, src: socket.socket, dst: socket.socket, prob: float,
              direction: str, conn_state: dict):
        n = 0
        pcs = prob
        try:
            while not self._stop.is_set():
                data = src.recv(65536)
                if not data:
                    break
                n += 1
                out = self._fuzz_maybe(data, pcs, n, direction, conn_state)
                pcs = raise_prob(pcs, self.ascent)
                dst.sendall(out)
        except OSError as e:
            if not self._stop.is_set():
                # abnormal close (reset/refused mid-stream): a desync when
                # fuzzed traffic flowed on this connection, else a drop —
                # feedback-mode runs promote whatever seeds were in flight
                kind = "desync" if conn_state.get("fuzzed") else "drop"
                feedback.publish(kind, source=f"proxy:{direction}",
                                 detail=str(e)[:100])
                logger.log("finding", "proxy %s (%s): %s", kind, direction, e)
        finally:
            # propagate the half-close: stop writing to dst, but leave the
            # opposite pump (dst -> src) alive to deliver the response
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _tls_wrap_client(self, client: socket.socket):
        import ssl

        certfile = self.opts.get("certfile")
        keyfile = self.opts.get("keyfile")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        if certfile:
            ctx.load_cert_chain(certfile, keyfile)
        else:
            raise RuntimeError(
                "tls:// proxy needs certfile=/keyfile= in opts "
                "(generate: openssl req -x509 -newkey rsa:2048 -nodes ...)")
        return ctx.wrap_socket(client, server_side=True)

    def _tls_wrap_server(self, server: socket.socket):
        import ssl

        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx.wrap_socket(server, server_hostname=self.rhost)

    def _handle_tcp(self, client: socket.socket):
        server = None
        try:
            server = socket.create_connection((self.rhost, self.rport),
                                              timeout=CONNECT_TIMEOUT_S)
            if self.proto == "tls":
                client = self._tls_wrap_client(client)
                server = self._tls_wrap_server(server)
            # the timeout bounds the set-up only: the JAX package leaves it
            # on the upstream socket, so an upstream silent for 10 s (a
            # keep-alive connection between requests, packets fuzzed to
            # nothing) ends the proxied connection
            server.settimeout(None)
        except (OSError, RuntimeError) as e:
            logger.log("error", "proxy connection setup failed (%s:%d): %s",
                       self.rhost, self.rport, e)
            client.close()
            if server is not None:
                server.close()
            return
        if self._track(client, server):
            # per-connection HTTP/2 framing + HPACK state
            self._start_pumps(client, server, {})

    # --- CONNECT / absolute-URI HTTP proxy (erlamsa_fuzzproxy.erl:138-164) -

    def _handle_connect(self, client: socket.socket):
        """Standalone HTTP proxy: read the request head, derive the real
        upstream from CONNECT host:port or the request's Host header."""
        server = None
        try:
            client.settimeout(CONNECT_TIMEOUT_S)
            head = b""
            while b"\r\n\r\n" not in head and len(head) < 65536:
                chunk = client.recv(8192)
                if not chunk:
                    client.close()
                    return
                head += chunk
            first = head.split(b"\r\n", 1)[0]
            if first.startswith(b"CONNECT "):
                target = first.split()[1].decode()
                host, _, port = target.rpartition(":")
                server = socket.create_connection(
                    (host or target, int(port or 443)), timeout=CONNECT_TIMEOUT_S
                )
                client.sendall(b"HTTP/1.1 200 Connection Established\r\n\r\n")
                leftover = head.split(b"\r\n\r\n", 1)[1]
            else:
                # absolute-URI / Host-header plain proxying
                host_line = next(
                    (l for l in head.split(b"\r\n") if l.lower().startswith(b"host:")),
                    None,
                )
                if host_line is None:
                    client.close()
                    return
                hostport = host_line.split(b":", 1)[1].strip().decode()
                host, _, port = hostport.partition(":")
                server = socket.create_connection(
                    (host, int(port or 80)), timeout=CONNECT_TIMEOUT_S
                )
                leftover = head  # forward the full request
            client.settimeout(None)
            server.settimeout(None)  # set-up only, as in _handle_tcp
            conn_state: dict = {}
            if leftover:
                out = self._fuzz_maybe(leftover, self.prob_cs, 1, "c->s", conn_state)
                server.sendall(out)
            if self._track(client, server):
                self._start_pumps(client, server, conn_state)
        except (OSError, ValueError, IndexError) as e:
            logger.log("error", "connect-proxy setup failed: %s", e)
            client.close()
            if server is not None:
                server.close()

    # --- dual serial (erlamsa_fuzzproxy.erl:202-224) -----------------------

    def _serve_serial(self):
        import os as _os
        import select

        from .out import open_serial_raw

        def open_dev(spec):
            dev, _, baud = spec.partition("@")
            return open_serial_raw(dev, int(baud or 115200))

        fd1 = open_dev(self.lport)  # lport/rhost carry the dev specs here
        try:
            fd2 = open_dev(self.rhost)
        except OSError:
            _os.close(fd1)
            raise
        self._ready.set()
        conn_state: dict = {}
        counts = {"c->s": 0, "s->c": 0}  # per-direction like _pump's n
        try:
            while not self._stop.is_set():
                r, _w, _x = select.select([fd1, fd2], [], [], 1.0)
                for fd in r:
                    try:
                        data = _os.read(fd, 4096)
                    except OSError as e:
                        logger.log("error", "serial proxy read failed: %s", e)
                        return
                    if not data:
                        # EOF (pty peer closed): selecting again would spin
                        logger.log("info", "serial endpoint closed")
                        return
                    direction = "c->s" if fd == fd1 else "s->c"
                    counts[direction] += 1
                    prob = self.prob_cs if fd == fd1 else self.prob_sc
                    out = self._fuzz_maybe(
                        data, prob, counts[direction], direction, conn_state
                    )
                    try:
                        _os.write(fd2 if fd == fd1 else fd1, out)
                    except OSError as e:
                        logger.log("error", "serial proxy write failed: %s", e)
                        return
        finally:
            _os.close(fd1)
            _os.close(fd2)

    def _serve_tcp(self):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", self.lport))
        srv.listen(64)
        srv.settimeout(ACCEPT_POLL_S)
        self._srv = srv
        self._ready.set()
        logger.log("info", "fuzzproxy %s://%d -> %s:%d",
                   self.proto, self.lport, self.rhost, self.rport)
        try:
            while not self._stop.is_set():
                try:
                    client, _addr = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                client.settimeout(None)
                if self.proto == "connect":
                    threading.Thread(
                        target=self._handle_connect, args=(client,),
                        daemon=True,
                    ).start()
                else:
                    self._handle_tcp(client)
        finally:
            srv.close()  # a supervised restart must be able to re-bind

    # --- UDP (loop_udp, erlamsa_fuzzproxy.erl:226-259) --------------------

    def _serve_udp(self):
        import select

        # bound OUTSIDE the try: a bind failure must not look like a
        # recoverable crash to the supervisor
        srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", self.lport))
        self._srv = srv
        # upstream-facing socket: client packets go out of it, so server
        # replies come back to ITS ephemeral port — select over both, like
        # the reference receiving on SrvSocket and ClSocket
        # (erlamsa_fuzzproxy.erl:226-259)
        up = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        up.bind(("0.0.0.0", 0))
        self._ready.set()
        try:
            r_ip = socket.gethostbyname(self.rhost)
        except OSError:
            r_ip = self.rhost
        client_addr = None
        counts = {"c->s": 0, "s->c": 0}
        conn_state: dict = {}
        try:
            while not self._stop.is_set():
                try:
                    rd, _w, _x = select.select([srv, up], [], [], 1.0)
                except (OSError, ValueError):
                    # stop() closes srv from another thread; a closed
                    # socket's fileno() is -1 which select rejects
                    break
                for sock in rd:
                    try:
                        data, addr = sock.recvfrom(65536)
                    except OSError:
                        return
                    is_server = sock is up or (
                        addr[0] == r_ip and addr[1] == self.rport
                    )
                    if is_server:
                        if client_addr is None:
                            continue
                        counts["s->c"] += 1
                        out = self._fuzz_maybe(
                            data, self.prob_sc, counts["s->c"], "s->c",
                            conn_state,
                        )
                        try:
                            srv.sendto(out, client_addr)
                        except OSError:
                            # a vanished client answers with ICMP
                            # port-unreachable; drop, keep serving
                            pass
                    else:
                        client_addr = addr
                        counts["c->s"] += 1
                        out = self._fuzz_maybe(
                            data, self.prob_cs, counts["c->s"], "c->s",
                            conn_state,
                        )
                        try:
                            up.sendto(out, (r_ip, self.rport))
                        except OSError:
                            pass
        finally:
            # release the listen port too, so a supervised restart can
            # re-bind instead of dying on EADDRINUSE
            up.close()
            srv.close()

    def start(self, block: bool = True):
        if self.proto == "serial":
            target = self._serve_serial
        elif self.proto == "udp":
            target = self._serve_udp
        else:
            target = self._serve_tcp
        if block:
            target()
            return 0
        self._thread = supervise(f"fuzzproxy-{self.proto}", target)
        # return once the endpoints are open, so a client may connect
        self._ready.wait(READY_WAIT_S)
        return self

    def stop(self):
        """End the serve loop on every protocol: set the stop event, close
        the listener and every open connection, and wait (up to
        STOP_JOIN_S) for a loop started with ``block=False`` to leave.
        Raises nothing."""
        self._stop.set()
        with self._lock:
            conns, self._conns = list(self._conns), set()
        srv = self._srv
        if srv is not None and self.proto != "udp":
            _close(srv)
        for s in conns:
            _close(s)
        if self._thread is not None:
            self._thread.join(STOP_JOIN_S)


def run_proxy(spec: str, probs: str, opts: dict, device=None) -> int:
    return FuzzProxy(spec, probs, opts, device=device).start(block=True)
