"""The port's HTTP/2 models (erlamsa_tpu_torch/models/huffman.py,
hpack.py, http2.py) against the JAX package's on the same inputs, made
from a seed with numpy: outputs and raised errors equal (tolerance 0:
every function is bytes). Pure Python on both sides, no device."""

import numpy as np
import pytest

from erlamsa_tpu.models import hpack as Jhpack
from erlamsa_tpu.models import http2 as Jhttp2
from erlamsa_tpu.models import huffman as Jhuff
from erlamsa_tpu_torch.models import hpack as Thpack
from erlamsa_tpu_torch.models import http2 as Thttp2
from erlamsa_tpu_torch.models import huffman as Thuff

N = 300  # random inputs per check


def outcome(fn, *args):
    """fn's result, or its error's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # lint: broad-except-ok the error IS the compared outcome
        return ("raise", type(e).__name__, str(e))


def blobs(seed, count=N, top=48):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, top)),
                         dtype=np.uint8).tobytes() for _ in range(count)]


def test_huffman_codes_equal():
    rng = np.random.default_rng(1)
    texts = blobs(2)
    # printable header-like strings too, the codes' short end
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-/:. ",
                             np.uint8)
    texts += [rng.choice(alphabet, int(rng.integers(0, 40))).tobytes()
              for _ in range(N)]
    for t in texts:
        enc = outcome(Jhuff.huffman_encode, t)
        assert outcome(Thuff.huffman_encode, t) == enc
        assert outcome(Thuff.huffman_length, t) == outcome(
            Jhuff.huffman_length, t)
        # a valid code decodes back; a random one raises in both alike
        assert outcome(Thuff.huffman_decode, enc[1]) == outcome(
            Jhuff.huffman_decode, enc[1]) == ("ok", t)
    bad = [outcome(Jhuff.huffman_decode, b) for b in blobs(3)]
    assert [outcome(Thuff.huffman_decode, b) for b in blobs(3)] == bad
    assert any(o[0] == "raise" for o in bad) and any(o[0] == "ok" for o in bad)


def test_hpack_integer_and_string_codecs_equal():
    rng = np.random.default_rng(4)
    for _ in range(N):
        value = int(rng.integers(0, 1 << int(rng.integers(1, 30))))
        bits = int(rng.integers(1, 9))
        flags = int(rng.integers(0, 256)) & ~((1 << bits) - 1) & 0xFF
        enc = Jhpack.encode_integer(value, bits, flags)
        assert Thpack.encode_integer(value, bits, flags) == enc
        assert Thpack.decode_integer(enc, 0, bits) == \
            Jhpack.decode_integer(enc, 0, bits) == (value, len(enc))
    for raw in blobs(5):
        pos = int(raw[0]) % max(1, len(raw)) if raw else 0
        for bits in (4, 5, 6, 7):
            assert outcome(Thpack.decode_integer, raw, pos, bits) == \
                outcome(Jhpack.decode_integer, raw, pos, bits)
        assert outcome(Thpack.decode_string, raw, pos) == \
            outcome(Jhpack.decode_string, raw, pos)
        assert Thpack.encode_string(raw) == Jhpack.encode_string(raw)
        huff = Jhpack.encode_integer(len(Jhuff.huffman_encode(raw)), 7,
                                     0x80) + Jhuff.huffman_encode(raw)
        assert Thpack.decode_string(huff, 0) == Jhpack.decode_string(huff, 0)


def _header_blocks(seed):
    """Header blocks mixing each representation (indexed, incremental
    literal, table-size update, literal without indexing, Huffman and
    plain strings) with random bytes."""
    rng = np.random.default_rng(seed)
    names = [b"content-type", b"x-fuzz", b":path", b"cookie", b"via"]
    out = []
    for _ in range(N):
        block = b""
        for _f in range(int(rng.integers(1, 6))):
            kind = int(rng.integers(0, 6))
            name = names[int(rng.integers(0, len(names)))]
            value = rng.integers(32, 127, int(rng.integers(0, 24)),
                                 dtype=np.uint8).tobytes()

            def s(x):
                if rng.integers(0, 2):
                    h = Jhuff.huffman_encode(x)
                    return Jhpack.encode_integer(len(h), 7, 0x80) + h
                return Jhpack.encode_string(x)

            if kind == 0:
                block += Jhpack.encode_integer(int(rng.integers(1, 70)), 7,
                                               0x80)
            elif kind == 1:
                block += Jhpack.encode_integer(0, 6, 0x40) + s(name) + s(value)
            elif kind == 2:
                block += Jhpack.encode_integer(int(rng.integers(1, 62)), 6,
                                               0x40) + s(value)
            elif kind == 3:
                block += Jhpack.encode_integer(int(rng.integers(0, 300)), 5,
                                               0x20)
            elif kind == 4:
                block += Jhpack.encode_integer(0, 4, 0x10) + s(name) + s(value)
            else:
                block += rng.integers(0, 256, int(rng.integers(1, 8)),
                                      dtype=np.uint8).tobytes()
        out.append(block)
    return out


def test_hpack_context_decode_and_encode_equal():
    """One context per package over every block in turn (the dynamic
    table carries across blocks), errors included."""
    jctx, tctx = Jhpack.HpackContext(), Thpack.HpackContext()
    outcomes = []
    for block in _header_blocks(6):
        want = outcome(jctx.decode, block)
        assert outcome(tctx.decode, block) == want
        assert tctx.dynamic == jctx.dynamic and tctx.max_size == jctx.max_size
        outcomes.append(want[0])
        if want[0] == "ok":
            assert tctx.encode(want[1]) == jctx.encode(want[1])
    assert "ok" in outcomes and "raise" in outcomes


def stub_fuzzer(data: bytes) -> bytes:
    """Deterministic stand-in for the batcher: reversed bytes, a length
    byte, and every third packet emptied."""
    if len(data) % 3 == 2:
        return b""
    return data[::-1] + bytes([len(data) & 0xFF])


def _frame_stream(seed):
    """A client's HTTP/2 byte stream: the preface, SETTINGS, HEADERS
    (padded, with priority, or plain), DATA (padded or not, empty too),
    PING, WINDOW_UPDATE, RST_STREAM and a truncated tail."""
    rng = np.random.default_rng(seed)
    ctx = Jhpack.HpackContext()
    out = Jhttp2.PREFACE + Jhttp2.build_frame(Jhttp2.T_SETTINGS, 0, 0,
                                              bytes(6))
    for i in range(int(rng.integers(4, 12))):
        stream = 2 * i + 1
        block = ctx.encode([(b":method", b"POST"), (b":path", b"/x%d" % i),
                            (b"x-fuzz", bytes(rng.integers(97, 123, 5,
                                                           dtype=np.uint8)))])
        flags = Jhttp2.F_END_HEADERS
        if rng.integers(0, 3) == 0:
            pad = int(rng.integers(0, 6))
            block = bytes([pad]) + block + bytes(pad)
            flags |= Jhttp2.F_PADDED
        if rng.integers(0, 3) == 0:
            block = bytes(4) + b"\x10" + block
            flags |= Jhttp2.F_PRIORITY
        out += Jhttp2.build_frame(Jhttp2.T_HEADERS, flags, stream, block)
        for _d in range(int(rng.integers(0, 3))):
            body = rng.integers(0, 256, int(rng.integers(0, 40)),
                                dtype=np.uint8).tobytes()
            dflags = int(rng.integers(0, 2))  # END_STREAM
            if rng.integers(0, 2):
                pad = int(rng.integers(0, 50))
                body = bytes([pad]) + body + bytes(pad)
                dflags |= Jhttp2.F_PADDED
            out += Jhttp2.build_frame(Jhttp2.T_DATA, dflags, stream, body)
        other = [(Jhttp2.T_PING, 0, 0, bytes(8)),
                 (Jhttp2.T_WINDOW_UPDATE, 0, stream, b"\x00\x00\x10\x00"),
                 (Jhttp2.T_RST_STREAM, 0, stream, bytes(4))]
        out += Jhttp2.build_frame(*other[int(rng.integers(0, 3))])
    return out + b"\x00\x00\x09\x00"  # a frame header cut short


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_frames_and_fuzz_http2_equal_over_random_splits(seed):
    rng = np.random.default_rng(seed + 100)
    stream = _frame_stream(seed)
    jframes, jrem = Jhttp2.parse_frames(stream)
    assert Thttp2.parse_frames(stream) == (jframes, jrem)
    for f in jframes:
        assert Thttp2.build_frame(*f) == Jhttp2.build_frame(*f)
    for _split in range(20):
        cuts = sorted(rng.integers(0, len(stream), int(rng.integers(1, 8))))
        pieces = [stream[a:b] for a, b in
                  zip([0, *cuts], [*cuts, len(stream)])]
        jst, tst = Jhttp2.Http2FuzzState(), Thttp2.Http2FuzzState()
        jout = [Jhttp2.fuzz_http2(stub_fuzzer, p, jst) for p in pieces]
        tout = [Thttp2.fuzz_http2(stub_fuzzer, p, tst) for p in pieces]
        assert tout == jout
        assert (tst.remainder, tst.seen_headers) == \
            (jst.remainder, jst.seen_headers)
    # the whole stream at once: non-DATA frames pass through unchanged,
    # DATA payloads are the stub's (padding stripped), lengths recomputed
    out = Thttp2.fuzz_http2(stub_fuzzer, stream, Thttp2.Http2FuzzState())
    frames, rem = Thttp2.parse_frames(out)
    assert rem == b""
    want = [(t, fl & ~Jhttp2.F_PADDED if t == Jhttp2.T_DATA and p else fl,
             s, stub_fuzzer(p[1:len(p) - p[0]] if t == Jhttp2.T_DATA
                            and p and fl & Jhttp2.F_PADDED else p)
             if t == Jhttp2.T_DATA and p else p)
            for t, fl, s, p in jframes]
    assert frames == want
