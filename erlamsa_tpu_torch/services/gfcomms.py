"""Genfuzz TCP service: serve grammar-generated fuzzing data per connection
(a copy of erlamsa_tpu/services/gfcomms.py).

Reference: src/erlamsa_gfcomms.erl — accept TCP, call the external module's
fuzzer per packet with a session dict. Here the handler generates from a
genfuzz grammar (models/genfuzz.py) or delegates to an external module's
``fuzzer(proto, data, session)``.

Two generation paths:

* **sequential** (default): one shared ErlRand AS183 stream, one
  ``fuzz_grammar`` expansion per packet under a lock — the reference's
  shape. The stream seed is explicit and logged at startup, so a fixed
  ``--seed`` replays the service byte-identically (it used to default to
  urandom silently, which made "replay the session" impossible).
* **batched** (``engine=`` / --gfcomms-batched): responses come from the
  grammar expander on the card via a GenEngine. A handler drains
  whatever packets are already pending on the connection and queues
  them; one batcher thread answers every connection's queued packets
  with ONE expander call (the JAX package's handlers each call the
  expander for their own connection: on the card a call costs about the
  same for one row as for hundreds, so the port groups across
  connections too). Response i of connection c is keyed on
  ``(grammar_id, c, i)`` — a pure function of the seed and the packet's
  position, independent of how packets were grouped into expander calls —
  so the single-connection replay contract survives batching, and the
  engine's gen.expand chaos/degradation semantics apply. The engine is
  warmed (GenEngine.warm: the expander built, the tables on the device)
  before the listener binds, so the first packet of the first connection
  waits on nothing but its own expansion; the JAX package's server
  compiles its expander on that packet instead.
"""

from __future__ import annotations

import queue
import socket
import threading

from ..models.genfuzz import fuzz_grammar
from ..obs import trace
from ..utils.erlrand import ErlRand, gen_urandom_seed
from . import logger

# batched mode: cap on packets one connection's drain takes, and on the
# rows of one expander call
MAX_DRAIN = 64
MAX_ROWS = 4096


def _fmt_seed(seed) -> str:
    if isinstance(seed, tuple):
        return ",".join(str(x) for x in seed)
    return str(seed)


class _Batcher:
    """Batched mode's expander calls: handlers queue (connection, slots)
    and wait; one thread takes every queued request (up to MAX_ROWS rows)
    and answers them with one ``engine.expand`` over per-row cases. An
    exception of the call is raised in each waiting handler."""

    def __init__(self, engine, stop: threading.Event):
        self.engine = engine
        self._stop = stop
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._thread = None

    def expand(self, conn_id: int, slots: range) -> list[bytes]:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                name="gfcomms-batcher",
                                                daemon=True)
                self._thread.start()
        req = {"conn": conn_id, "slots": slots, "done": threading.Event()}
        self._q.put(req)
        req["done"].wait()
        if "error" in req:
            raise req["error"]
        return req["out"]

    def _run(self):
        while not self._stop.is_set():
            try:
                batch = [self._q.get(timeout=0.1)]
            except queue.Empty:
                continue
            rows = len(batch[0]["slots"])
            while rows < MAX_ROWS:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                batch.append(req)
                rows += len(req["slots"])
            cases = [r["conn"] for r in batch for _s in r["slots"]]
            slots = [s for r in batch for s in r["slots"]]
            try:
                outs, _trunc = self.engine.expand(cases, slots=slots)
            except Exception as e:  # re-raised in every waiting handler
                for r in batch:
                    r["error"] = e
                    r["done"].set()
                continue
            at = 0
            for r in batch:
                r["out"] = outs[at:at + len(r["slots"])]
                at += len(r["slots"])
                r["done"].set()


class GfComms:
    def __init__(self, port: int, grammar=None, external_fuzzer=None,
                 seed=None, engine=None):
        self.port = port
        self.grammar = grammar
        self.external = external_fuzzer
        self.engine = engine  # gen.GenEngine -> batched keyed mode
        if seed is None:
            seed = gen_urandom_seed()
        self.seed = seed
        self.r = ErlRand(seed)
        # one AS183 stream shared by handler threads: serialize draws so a
        # fixed seed stays reproducible (single-connection replay contract)
        self._rlock = threading.Lock()
        self._stop = threading.Event()
        self._conn_seq = 0
        self._batcher = (_Batcher(engine, self._stop) if engine is not None
                         else None)

    def _handle(self, conn: socket.socket, addr):
        session: dict = {}
        try:
            while not self._stop.is_set():
                data = conn.recv(65536)
                if not data:
                    break
                with trace.span("gfcomms.request", bytes=len(data)):
                    if self.external is not None:
                        out = self.external("tcp", data, session)
                    elif self.grammar is not None:
                        with self._rlock:
                            out = fuzz_grammar(self.r, self.grammar,
                                               session)
                    else:
                        out = data
                conn.sendall(out)
        except OSError:
            pass
        finally:
            conn.close()

    def _handle_batched(self, conn: socket.socket, addr, conn_id: int):
        """Drain pending packets, answer them through the batcher's next
        expander call. Response i of this connection is expand(case=
        conn_id, slot=i) whatever the grouping — replay-stable by
        construction."""
        seq = 0
        try:
            while not self._stop.is_set():
                data = conn.recv(65536)
                if not data:
                    break
                npkts = 1
                conn.setblocking(False)
                try:
                    while npkts < MAX_DRAIN:
                        more = conn.recv(65536)
                        if not more:
                            break
                        npkts += 1
                except OSError:
                    pass  # nothing else pending
                finally:
                    conn.setblocking(True)
                with trace.span("gen.expand", conn=conn_id, seq=seq,
                                pkts=npkts):
                    outs = self._batcher.expand(conn_id,
                                                range(seq, seq + npkts))
                seq += npkts
                for out in outs:
                    conn.sendall(out)
        except OSError:
            pass
        finally:
            conn.close()

    def serve(self, block: bool = True):
        if self.engine is not None:
            # the set-up a client's first packet would wait on otherwise
            self.engine.warm()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", self.port))
        srv.listen(16)
        self._srv = srv
        # the replay coordinate, stated up front: rerunning with this
        # seed (and the same per-connection packet sequence) reproduces
        # every response byte
        logger.log("info", "gfcomms listening on :%d (seed %s, %s mode)",
                   self.port, _fmt_seed(self.seed),
                   "batched" if self.engine is not None else "sequential")

        def loop():
            while not self._stop.is_set():
                try:
                    conn, addr = srv.accept()
                except OSError:
                    break
                conn_id = self._conn_seq
                self._conn_seq += 1
                if self.engine is not None:
                    target, args = self._handle_batched, (conn, addr, conn_id)
                else:
                    target, args = self._handle, (conn, addr)
                threading.Thread(target=target, args=args,
                                 daemon=True).start()

        if block:
            loop()
            return 0
        threading.Thread(target=loop, daemon=True).start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
