"""The erlamsa-side bridge server, the north star's ``-m xla`` backend, on
the port's engines (erlamsa_tpu/services/xla_bridge.py).

Speaks the length-prefixed frame protocol in bridge/PROTOCOL.md to an
Erlang `open_port({packet,4})` (stdio mode) or over TCP (daemon mode).
The Erlang counterpart is bridge/erlamsa_mutations_xla.erl, loaded into
the reference with ``-e erlamsa_mutations_xla`` (the external-module hook,
src/erlamsa_cmdparse.erl:456-470; module shape external_muta.erl:1-21).
That module starts the command in ``ERLAMSA_XLA_BRIDGE_CMD``, so

    ERLAMSA_XLA_BRIDGE_CMD="python3 -m erlamsa_tpu_torch.services.xla_bridge"

puts this server in the JAX one's place. Its frames equal the JAX
server's byte for byte (the HELLO answer names the same server and
backends), so the Erlang side needs no change.

Ops (see PROTOCOL.md):
- FUZZ_CASE: whole-case oracle run for byte-exact parity at fixed seed.
- MUX_EVENT: one mux_fuzzers event (src/erlamsa_mutations.erl:1256-1280)
  against the caller's live AS183 state; the advanced state rides back so
  the Erlang process's stream continues in lockstep.
- FUZZ_BATCH: many samples per call on the device batch engine (or the
  oracle, per-sample) — the throughput path. ``backend: "tpu"`` runs on
  the server's device (``cuda`` unless ``--device cpu``) in the stream
  ERLAMSA_PALLAS selects; it never falls back to the CPU or the oracle: a
  step that fails answers OP_ERROR.

The server holds no cross-frame state (state travels in the frames), so a
restart loses nothing. A bad frame, sample or option answers OP_ERROR and
the session goes on: an unknown mutation or pattern name included (the
JAX server's parse raises SystemExit there, which ends its session).
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import threading

MAX_FRAME = 64 * 1024 * 1024
VERSION = 1

OP_HELLO = 0x01
OP_FUZZ_CASE = 0x02
OP_MUX_EVENT = 0x03
OP_FUZZ_BATCH = 0x05
OP_PING = 0x7E
OP_ERROR = 0xFF
RESP = 0x80


class ProtocolError(Exception):
    pass


def encode_frame(opcode: int, header: dict, payload: bytes = b"") -> bytes:
    body = bytes([opcode]) + json.dumps(header).encode() + b"\x00" + payload
    if len(body) > MAX_FRAME:
        raise ProtocolError("frame too large")
    return struct.pack(">I", len(body)) + body


def decode_body(body: bytes) -> tuple[int, dict, bytes]:
    if not body:
        raise ProtocolError("empty frame")
    sep = body.find(b"\x00", 1)
    if sep < 0:
        raise ProtocolError("missing header separator")
    header = json.loads(body[1:sep] or b"{}")
    return body[0], header, body[sep + 1 :]


def _read_exact(read, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(read) -> tuple[int, dict, bytes] | None:
    """read(n) -> bytes callable; returns None on clean EOF."""
    hdr = _read_exact(read, 4)
    if hdr is None:
        return None
    (ln,) = struct.unpack(">I", hdr)
    if ln > MAX_FRAME:
        raise ProtocolError("oversized frame")
    body = _read_exact(read, ln)
    if body is None:
        raise ProtocolError("truncated frame")
    return decode_body(body)


# ---- op handlers ----------------------------------------------------------


def _parse_mutations(spec):
    """None for the default set, else [(name, pri)]; an unknown name or a
    bad priority raises ValueError (an error frame)."""
    from ..oracle.mutations import default_mutations
    from .cli import read_actions

    if not spec or spec == "default":
        return None
    return read_actions(spec, default_mutations(), "mutation")


def _parse_patterns(spec):
    from ..oracle.patterns import default_patterns
    from .cli import read_actions

    if not spec or spec == "default":
        return None
    return read_actions(spec, default_patterns(), "pattern")


def _handle_fuzz_case(header: dict, payload: bytes):
    from ..oracle.engine import fuzz

    seed = tuple(int(x) for x in header["seed"])
    opts = {}
    muts = _parse_mutations(header.get("mutations"))
    if muts is not None:
        opts["mutations"] = muts
    pats = _parse_patterns(header.get("patterns"))
    if pats is not None:
        opts["patterns"] = pats
    out = fuzz(payload, seed=seed, **opts)
    return {"len": len(out)}, out


def _handle_mux_event(header: dict, payload: bytes):
    """make_mutator (init-score draws included) + one apply_mux on the
    caller's AS183 state; deterministic per (state, mutations, data)."""
    from ..oracle.mutations import (
        Ctx,
        apply_mux,
        default_mutations,
        make_mutator,
    )
    from ..utils.erlrand import ErlRand

    state = tuple(int(x) for x in header["state"])
    r = ErlRand()
    r.setstate(state)
    ctx = Ctx(r)
    muts = _parse_mutations(header.get("mutations")) or default_mutations()
    rows = make_mutator(ctx, muts)
    _rows, ll, meta = apply_mux(ctx, rows, [payload], [])
    out = b"".join(b for b in ll if isinstance(b, bytes))
    used = next((v for k, v in meta if k == "used"), None)
    return {"len": len(out), "state": list(r.getstate()), "used": used}, out


def _split_payload(payload: bytes, lens: list[int]) -> list[bytes]:
    if sum(lens) != len(payload):
        raise ProtocolError("lens do not sum to payload size")
    out, pos = [], 0
    for n in lens:
        out.append(payload[pos : pos + n])
        pos += n
    return out


def _fuzz_batch_tpu(seed, case_idx: int, samples: list[bytes], device=None,
                    level=None) -> list[bytes]:
    from .. import resolve_device
    from ..ops import prng
    from ..ops.buffers import Batch, capacity_for, pack, unpack
    from ..ops.scheduler import init_scores
    from ..ops.slots import STEP_CACHE

    dev = resolve_device(device)
    cap = capacity_for(max(1, max(len(s) for s in samples)))
    packed = pack(samples, capacity=cap, device=dev)
    # built once per geometry and stream (the JAX server builds it anew
    # on every call, with the same bytes)
    step = STEP_CACHE.fuzzer_step(cap, len(samples), device=dev, level=level)
    base = prng.base_key(seed, device=dev)
    scores = init_scores(prng.fold_in(base, 999), len(samples))
    data, lens, _scores, _meta = step(
        base, case_idx, packed.data, packed.lens, scores
    )
    return unpack(Batch(data, lens))


def _fuzz_batch_oracle(seed, case_idx: int, samples: list[bytes]) -> list[bytes]:
    """Per-sample oracle with the engine's ThreadSeed derivation: sample i
    of case c uses the parent stream's (case*B+i)-th derived seed."""
    from ..oracle.engine import fuzz
    from ..utils.erlrand import ErlRand

    parent = ErlRand(tuple(seed))
    for _ in range(3 * case_idx * len(samples)):
        parent.erand(99999)
    out = []
    for s in samples:
        ts = (parent.erand(99999), parent.erand(99999), parent.erand(99999))
        out.append(fuzz(s, seed=ts))
    return out


def _handle_fuzz_batch(header: dict, payload: bytes, device=None, level=None):
    seed = tuple(int(x) for x in header["seed"])
    case_idx = int(header.get("case", 0))
    samples = _split_payload(payload, [int(x) for x in header["lens"]])
    if not samples:
        return {"lens": []}, b""
    backend = header.get("backend", "tpu")
    if backend == "oracle":
        results = _fuzz_batch_oracle(seed, case_idx, samples)
    else:
        results = _fuzz_batch_tpu(seed, case_idx, samples, device, level)
    return {"lens": [len(r) for r in results]}, b"".join(results)


class BridgeServer:
    """One protocol session over a (read, write) byte-stream pair.
    FUZZ_BATCH ``tpu`` runs on ``device`` (None: ``cuda``, resolved per
    call, so a server without a card still answers the other ops) in the
    stream ERLAMSA_PALLAS selects."""

    def __init__(self, device=None):
        self._hello_done = False
        self.device = device

    def handle(self, opcode: int, header: dict, payload: bytes) -> bytes:
        try:
            if opcode == OP_HELLO:
                self._hello_done = True
                return encode_frame(
                    OP_HELLO | RESP,
                    {
                        "ok": True,
                        "server": "erlamsa_tpu",
                        "version": VERSION,
                        "backends": ["oracle", "tpu"],
                    },
                )
            if opcode == OP_PING:
                return encode_frame(OP_PING | RESP, {})
            if not self._hello_done:
                raise ProtocolError("HELLO required first")
            if opcode == OP_FUZZ_CASE:
                h, p = _handle_fuzz_case(header, payload)
                return encode_frame(OP_FUZZ_CASE | RESP, h, p)
            if opcode == OP_MUX_EVENT:
                h, p = _handle_mux_event(header, payload)
                return encode_frame(OP_MUX_EVENT | RESP, h, p)
            if opcode == OP_FUZZ_BATCH:
                h, p = _handle_fuzz_batch(header, payload, self.device)
                return encode_frame(OP_FUZZ_BATCH | RESP, h, p)
            raise ProtocolError(f"unknown opcode {opcode:#x}")
        except ProtocolError as e:
            return encode_frame(OP_ERROR, {"error": str(e)})
        except Exception as e:  # lint: broad-except-ok never kill the port on a bad sample
            return encode_frame(OP_ERROR, {"error": f"{type(e).__name__}: {e}"})

    def serve_stream(self, read, write) -> None:
        while True:
            try:
                frame = read_frame(read)
            except ProtocolError as e:
                write(encode_frame(OP_ERROR, {"error": str(e)}))
                return
            if frame is None:
                return
            write(self.handle(*frame))


def serve_stdio(device=None) -> int:
    """Erlang port mode: {packet,4} frames on stdin/stdout. stdout carries
    frames only: the frames go to a duplicate of descriptor 1, and
    descriptor 1 itself (with ``sys.stdout``) is pointed at stderr, so a
    print, a warning or a child process's output can never land between
    two frames."""
    import os

    stdin = sys.stdin.buffer
    sys.stdout.flush()
    frames_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    out = os.fdopen(frames_fd, "wb")

    def write(b: bytes):
        out.write(b)
        out.flush()

    try:
        BridgeServer(device).serve_stream(
            stdin.read1 if hasattr(stdin, "read1") else stdin.read, write)
    finally:
        out.close()
    return 0


def serve_tcp(port: int, host: str = "127.0.0.1", block: bool = True,
              device=None):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)

    def client(conn):
        with conn:
            BridgeServer(device).serve_stream(conn.recv, conn.sendall)

    def loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=client, args=(conn,), daemon=True).start()

    if block:
        loop()
        return 0
    threading.Thread(target=loop, daemon=True).start()
    return srv


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m erlamsa_tpu_torch.services.xla_bridge",
        description="erlamsa bridge server (see bridge/PROTOCOL.md)"
    )
    ap.add_argument("--tcp", type=int, default=None, metavar="PORT",
                    help="serve over TCP instead of stdio")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device of FUZZ_BATCH tpu (default cuda; "
                         "'cpu' for the plain path)")
    args = ap.parse_args(argv)
    if args.tcp is not None:
        return serve_tcp(args.tcp, args.host, device=args.device)
    return serve_stdio(device=args.device)


if __name__ == "__main__":
    sys.exit(main())
