"""The port's bridge server (erlamsa_tpu_torch/services/xla_bridge.py,
the ``-m xla`` backend) and its -e hook (services/external.py,
services/external_nhrp.py) against the JAX package's on the CPU.

Both packages' ``BridgeServer`` answer the same frames in process and
their response frames are compared byte for byte: HELLO, PING,
FUZZ_CASE, MUX_EVENT with its state threaded, FUZZ_BATCH on the oracle
and on the device engine at levels 0, 1 and 2 (the JAX side's
``make_fuzzer`` kept per geometry and stream, one compile a level: its
server builds a new one per call, with the same bytes), and the error
paths. An unknown mutation or pattern name answers 0xFF in the port and
the session goes on; the JAX server raises SystemExit there. Then the
transports (stdio in a process of its own, TCP), the -e hook, and a
fresh interpreter's imports.
"""

import io
import os
import socket
import struct
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from erlamsa_tpu.services import external as Jext
from erlamsa_tpu.services import external_nhrp as Jnhrp
from erlamsa_tpu.services import xla_bridge as J
from erlamsa_tpu_torch.services import external as Text
from erlamsa_tpu_torch.services import external_nhrp as Tnhrp
from erlamsa_tpu_torch.services import xla_bridge as T

torch.set_num_threads(1)  # the plain path is small; leave the cores to jax

WAIT = 120.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def servers():
    """(JAX server, port server on the CPU), both past HELLO."""
    j, t = J.BridgeServer(), T.BridgeServer(device="cpu")
    hello = {"version": 1}
    assert t.handle(T.OP_HELLO, hello, b"") == j.handle(J.OP_HELLO, hello, b"")
    return j, t


def both(j, t, op, header, payload=b""):
    """Both servers' response frames to one request; equal."""
    want = j.handle(op, header, payload)
    got = t.handle(op, header, payload)
    assert got == want, (J.decode_body(want[4:])[:2], T.decode_body(got[4:])[:2])
    return T.decode_body(got[4:])


def samples(seed, count=8, top=96):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(1, top + 1))
        if i % 2:
            out.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        else:
            out.append((b"num %d line %d\n" % (i, n) * 12)[:n])
    return out


def test_framing_equal():
    rng = np.random.default_rng(1)
    for i in range(100):
        header = {"seed": [int(x) for x in rng.integers(0, 9999, 3)],
                  "n": i, "s": "x" * int(rng.integers(0, 9))}
        payload = rng.integers(0, 256, int(rng.integers(0, 64)),
                               dtype=np.uint8).tobytes()
        frame = J.encode_frame(J.OP_FUZZ_CASE, header, payload)
        assert T.encode_frame(T.OP_FUZZ_CASE, header, payload) == frame
        assert T.decode_body(frame[4:]) == J.decode_body(frame[4:])
        assert T.read_frame(io.BytesIO(frame).read) == \
            J.read_frame(io.BytesIO(frame).read)
    assert (T.MAX_FRAME, T.VERSION, T.OP_ERROR, T.RESP) == \
        (J.MAX_FRAME, J.VERSION, J.OP_ERROR, J.RESP)


def test_hello_ping_and_error_paths():
    j, t = J.BridgeServer(), T.BridgeServer(device="cpu")
    # an op before HELLO, then HELLO and PING
    op, h, _ = both(j, t, J.OP_FUZZ_CASE, {"seed": [1, 2, 3]}, b"x")
    assert op == J.OP_ERROR and "HELLO" in h["error"]
    op, h, _ = both(j, t, J.OP_HELLO, {"version": 1})
    assert (h["server"], h["backends"]) == ("erlamsa_tpu", ["oracle", "tpu"])
    assert both(j, t, J.OP_PING, {})[0] == J.OP_PING | J.RESP
    # an unknown opcode, lens that do not sum, a bad priority, no seed
    assert both(j, t, 0x42, {})[0] == J.OP_ERROR
    op, h, _ = both(j, t, J.OP_FUZZ_BATCH,
                    {"seed": [1, 2, 3], "lens": [2, 5]}, b"abc")
    assert op == J.OP_ERROR and "lens" in h["error"]
    op, h, _ = both(j, t, J.OP_FUZZ_CASE,
                    {"seed": [1, 2, 3], "mutations": "bd=x"}, b"abc")
    assert op == J.OP_ERROR and "ValueError" in h["error"]
    assert both(j, t, J.OP_FUZZ_CASE, {}, b"abc")[0] == J.OP_ERROR
    # an oversized frame ends the session with an error frame
    for mod, srv in ((J, j), (T, t)):
        out = []
        srv.serve_stream(io.BytesIO(struct.pack(">I", mod.MAX_FRAME + 1)).read,
                         out.append)
        assert len(out) == 1
    assert out[0] == J.encode_frame(J.OP_ERROR, {"error": "oversized frame"})


def test_unknown_names_answer_error_and_the_session_goes_on():
    """The port answers 0xFF to an unknown mutation or pattern name and
    serves the next frame; the JAX server's name check raises
    SystemExit, which passes its ``except Exception`` and would end its
    session."""
    frames = b"".join([
        T.encode_frame(T.OP_HELLO, {"version": 1}),
        T.encode_frame(T.OP_FUZZ_CASE, {"seed": [1, 2, 3],
                                        "mutations": "nosuch"}, b"abc"),
        T.encode_frame(T.OP_MUX_EVENT, {"state": [1, 2, 3],
                                        "mutations": "bd,zzz"}, b"abc"),
        T.encode_frame(T.OP_FUZZ_CASE, {"seed": [1, 2, 3],
                                        "patterns": "nopattern"}, b"abc"),
        T.encode_frame(T.OP_PING, {}),
    ])
    out = []
    T.BridgeServer(device="cpu").serve_stream(io.BytesIO(frames).read,
                                              out.append)
    ops = [T.decode_body(f[4:]) for f in out]
    assert [o for o, _h, _p in ops] == [T.OP_HELLO | T.RESP, T.OP_ERROR,
                                        T.OP_ERROR, T.OP_ERROR,
                                        T.OP_PING | T.RESP]
    assert "nosuch" in ops[1][1]["error"] and "zzz" in ops[2][1]["error"]
    assert "nopattern" in ops[3][1]["error"]
    j = J.BridgeServer()
    j.handle(J.OP_HELLO, {"version": 1}, b"")
    with pytest.raises(SystemExit):
        j.handle(J.OP_FUZZ_CASE, {"seed": [1, 2, 3], "mutations": "nosuch"},
                 b"abc")


@pytest.mark.parametrize("header", [
    {"seed": [11, 22, 33]},
    {"seed": [1, 2, 3], "mutations": "bf=1,bd=2,num", "patterns": "od"},
    {"seed": [7, 8, 9], "mutations": "default", "patterns": "nd=2,bu"},
])
def test_fuzz_case_equal(header):
    j, t = servers()
    for data in samples(3, count=4, top=160):
        op, h, out = both(j, t, J.OP_FUZZ_CASE, header, data)
        assert op == J.OP_FUZZ_CASE | J.RESP and h["len"] == len(out)


def test_mux_event_threads_state_equal():
    j, t = servers()
    for muts in (None, "bd,bf,sr=3,num"):
        state = [1001, 2002, 3003]
        for data in samples(4, count=5, top=120):
            header = {"state": state}
            if muts:
                header["mutations"] = muts
            op, h, _out = both(j, t, J.OP_MUX_EVENT, header, data)
            assert op == J.OP_MUX_EVENT | J.RESP and h["state"] != state
            state = h["state"]


def test_fuzz_batch_oracle_equal():
    j, t = servers()
    data = samples(5, count=6)
    for case in (0, 2):
        op, h, out = both(j, t, J.OP_FUZZ_BATCH,
                          {"seed": [4, 5, 6], "case": case, "backend": "oracle",
                           "lens": [len(s) for s in data]}, b"".join(data))
        assert op == J.OP_FUZZ_BATCH | J.RESP and sum(h["lens"]) == len(out)
    assert both(j, t, J.OP_FUZZ_BATCH, {"seed": [1, 2, 3], "lens": []})[1] \
        == {"lens": []}


_JAX_FUZZERS = {}


@pytest.mark.parametrize("level", [None, "1", "2"], ids=["level0", "level1",
                                                         "level2"])
def test_fuzz_batch_device_equal(monkeypatch, level):
    """8 samples of at most 96 B, cases 0 and 3, ERLAMSA_PALLAS set for
    both packages: the port's FUZZ_BATCH on the CPU == the JAX server's
    frame."""
    from erlamsa_tpu.ops import pipeline as Jpipeline

    if level is None:
        monkeypatch.delenv("ERLAMSA_PALLAS", raising=False)
    else:
        monkeypatch.setenv("ERLAMSA_PALLAS", level)
    real = _JAX_FUZZERS.setdefault("make", Jpipeline.make_fuzzer)

    def make_fuzzer(capacity, batch, **kw):
        key = (capacity, batch, level, tuple(sorted(kw.items())))
        if key not in _JAX_FUZZERS:
            _JAX_FUZZERS[key] = real(capacity, batch, **kw)
        return _JAX_FUZZERS[key]

    monkeypatch.setattr(Jpipeline, "make_fuzzer", make_fuzzer)
    j, t = servers()
    data = samples(6)
    assert max(map(len, data)) <= 96
    outs = []
    for case in (0, 3):
        header = {"seed": [4, 5, 6], "case": case, "backend": "tpu",
                  "lens": [len(s) for s in data]}
        op, h, out = both(j, t, J.OP_FUZZ_BATCH, header, b"".join(data))
        assert op == J.OP_FUZZ_BATCH | J.RESP and sum(h["lens"]) == len(out)
        outs.append(out)
    assert outs[0] != outs[1] and outs[0] != b"".join(data)


def test_fuzz_batch_device_without_card_answers_error():
    """No CUDA device and no --device cpu: the tpu backend answers an
    error frame, never the oracle or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = T.BridgeServer()
    t.handle(T.OP_HELLO, {}, b"")
    op, h, _ = T.decode_body(t.handle(
        T.OP_FUZZ_BATCH, {"seed": [1, 2, 3], "lens": [3]}, b"abc")[4:])
    assert op == T.OP_ERROR and "CUDA" in h["error"]


def _batch_request():
    data = samples(7, count=5)
    return ({"seed": [9, 9, 9], "case": 1, "backend": "tpu",
             "lens": [len(s) for s in data]}, b"".join(data))


def test_stdio_subprocess_answers_and_stdout_holds_frames_only(monkeypatch):
    """``python -m erlamsa_tpu_torch.services.xla_bridge --device cpu``
    over stdio, as ERLAMSA_XLA_BRIDGE_CMD starts it: HELLO and one
    FUZZ_BATCH equal the in-process frames, and stdout holds those two
    frames and nothing else."""
    header, payload = _batch_request()
    monkeypatch.delenv("ERLAMSA_PALLAS", raising=False)
    t = T.BridgeServer(device="cpu")
    want = [t.handle(T.OP_HELLO, {"version": 1}, b""),
            t.handle(T.OP_FUZZ_BATCH, header, payload)]
    proc = subprocess.run(
        [sys.executable, "-m", "erlamsa_tpu_torch.services.xla_bridge",
         "--device", "cpu"],
        input=T.encode_frame(T.OP_HELLO, {"version": 1})
        + T.encode_frame(T.OP_FUZZ_BATCH, header, payload),
        capture_output=True, cwd=REPO, timeout=WAIT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == b"".join(want)
    assert T.decode_body(want[1][4:])[0] == T.OP_FUZZ_BATCH | T.RESP


def test_serve_tcp_session():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = T.serve_tcp(port, block=False, device="cpu")
    j = J.BridgeServer()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT) as c:
            c.settimeout(WAIT)
            for op, header, payload in ((T.OP_HELLO, {"version": 1}, b""),
                                        (T.OP_PING, {}, b""),
                                        (T.OP_FUZZ_CASE, {"seed": [1, 2, 3]},
                                         b"tcp bridge 42\n")):
                c.sendall(T.encode_frame(op, header, payload))
                ln = struct.unpack(">I", T._read_exact(c.recv, 4))[0]
                frame = struct.pack(">I", ln) + T._read_exact(c.recv, ln)
                assert frame == j.handle(op, header, payload)
    finally:
        srv.close()


# ---- the -e hook ------------------------------------------------------------


def test_external_mutations_and_post_equal():
    """tests/torch_external_muta.py through both packages' oracle: the
    custom row joins the table, its draws come from the same stream, and
    post runs over the output; through the proxy's oracle escape too."""
    from erlamsa_tpu.oracle.engine import fuzz as jfuzz
    from erlamsa_tpu_torch.oracle.engine import fuzz as tfuzz
    from erlamsa_tpu_torch.services.batcher import OverflowEscape

    jx, tx = Jext.load_external("torch_external_muta"), \
        Text.load_external("torch_external_muta")
    assert tx.capabilities == jx.capabilities == {"mutations", "post"}
    stamped = 0
    for i, data in enumerate(samples(8, count=6, top=80)):
        seed = (i + 1, 2 * i + 3, 7)
        for muts in ([("bd", 1), ("bf", 1)], None):
            kw = {} if muts is None else {"mutations": muts}
            want = jfuzz(data, seed=seed, external_module=jx, post=jx.post(),
                         **kw)
            got = tfuzz(data, seed=seed, external_module=tx, post=tx.post(),
                        **kw)
            assert got == want and got.endswith(b"|post")
            stamped += b"EXT" in got
    assert stamped
    opts = {"seed": (3, 4, 5), "external_module": tx, "post": tx.post()}
    big = samples(9, count=1, top=80)[0] * 8
    esc = OverflowEscape(30.0)
    assert esc.fuzz(big, dict(opts), WAIT) == jfuzz(
        big, seed=(3, 4, 5), external_module=jx, post=jx.post())


def test_external_nhrp_post_equal():
    tx = Text.load_external("erlamsa_tpu_torch.services.external_nhrp")
    jx = Jext.load_external("erlamsa_tpu.services.external_nhrp")
    assert tx.capabilities == jx.capabilities == {"post", "fuzzer"}
    rng = np.random.default_rng(10)
    for n in (0, 5, 17, 18, 19, 40, 41, 200):
        pkt = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tx.post()(pkt) == jx.post()(pkt)
        assert Tnhrp.inet_checksum(pkt) == Jnhrp.inet_checksum(pkt)
    from erlamsa_tpu_torch.services import cli

    opts = {}
    cli._load_external("erlamsa_tpu_torch.services.external_nhrp", opts)
    assert opts["post"] is Tnhrp.post and "external_generator" not in opts


def test_grammar_module_raises_not_ported():
    """A module offering only grammar() loaded through -e: since grammar
    generation is ported (models/genfuzz.py) it no longer raises, and
    its generator fills the genfuz slot with the grammar's samples."""
    from erlamsa_tpu_torch.models.genfuzz import make_external_generator
    from erlamsa_tpu_torch.services import cli

    grammar = [("static", b"x"), ("rbinary", 2)]
    mod = types.ModuleType("torch_grammar_external")
    mod.capabilities = lambda: set()
    mod.grammar = lambda: grammar
    sys.modules["torch_grammar_external"] = mod
    try:
        gen = Text.load_external("torch_grammar_external").generator()
        blocks, meta = gen()
        assert meta == ("generator", "genfuz")
        assert len(blocks) == 1 and len(blocks[0]) == 3
        opts = {}
        cli._load_external("torch_grammar_external", opts)
        assert opts["external_generator"]()[1] == meta
        seeded = make_external_generator(grammar, seed=(1, 2, 3))
        assert seeded() == make_external_generator(grammar,
                                                   seed=(1, 2, 3))()
    finally:
        del sys.modules["torch_grammar_external"]


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import erlamsa_tpu_torch.models.huffman, erlamsa_tpu_torch.models.hpack\n"
        "import erlamsa_tpu_torch.models.http2\n"
        "import erlamsa_tpu_torch.services.proxy\n"
        "import erlamsa_tpu_torch.services.xla_bridge\n"
        "import erlamsa_tpu_torch.services.external\n"
        "import erlamsa_tpu_torch.services.external_nhrp\n"
        "import erlamsa_tpu_torch.services.cli\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'erlamsa_tpu' or m.startswith('erlamsa_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=WAIT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "clean"
