"""HTTP/2 framing and the DATA-only fuzz path.

Reference: src/erlamsa_http2.erl — parses the frame stream, HPACK-tracks
header state per direction, fuzzes ONLY DATA payloads, and repacks
(fuzz_http2, :609-665). Same policy here: HEADERS/SETTINGS/etc. pass
through byte-identical (which also keeps both endpoints' HPACK contexts
consistent), DATA payloads go through the fuzzer and the frame length is
recomputed; padding is stripped on fuzzed frames.
"""

from __future__ import annotations

from typing import Callable

from .hpack import HpackContext

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

T_DATA = 0x0
T_HEADERS = 0x1
T_PRIORITY = 0x2
T_RST_STREAM = 0x3
T_SETTINGS = 0x4
T_PUSH_PROMISE = 0x5
T_PING = 0x6
T_GOAWAY = 0x7
T_WINDOW_UPDATE = 0x8
T_CONTINUATION = 0x9

F_PADDED = 0x8
F_END_HEADERS = 0x4
F_PRIORITY = 0x20


def parse_frames(data: bytes) -> tuple[list[tuple[int, int, int, bytes]], bytes]:
    """-> ([(type, flags, stream_id, payload)], remainder). The remainder is
    an incomplete trailing frame (stream reassembly buffer)."""
    frames = []
    pos = 0
    if data.startswith(PREFACE):
        frames.append((-1, 0, 0, PREFACE))  # pseudo-frame for the preface
        pos = len(PREFACE)
    while pos + 9 <= len(data):
        length = int.from_bytes(data[pos : pos + 3], "big")
        ftype = data[pos + 3]
        flags = data[pos + 4]
        stream = int.from_bytes(data[pos + 5 : pos + 9], "big") & 0x7FFFFFFF
        if pos + 9 + length > len(data):
            break
        frames.append((ftype, flags, stream, data[pos + 9 : pos + 9 + length]))
        pos += 9 + length
    return frames, data[pos:]


def build_frame(ftype: int, flags: int, stream: int, payload: bytes) -> bytes:
    if ftype == -1:
        return payload  # preface pseudo-frame
    return (
        len(payload).to_bytes(3, "big")
        + bytes([ftype & 0xFF, flags & 0xFF])
        + (stream & 0x7FFFFFFF).to_bytes(4, "big")
        + payload
    )


class Http2FuzzState:
    """Per-direction stream state: HPACK context + reassembly remainder
    (the reference keeps this in the process dictionary,
    src/erlamsa_http2.erl:623-624)."""

    def __init__(self):
        self.hpack = HpackContext()
        self.remainder = b""
        self.seen_headers: list = []


def fuzz_http2(
    fuzzer: Callable[[bytes], bytes], data: bytes, state: Http2FuzzState
) -> bytes:
    """Fuzz DATA payloads in a captured HTTP/2 byte stream; everything else
    passes through unchanged."""
    frames, rem = parse_frames(state.remainder + data)
    state.remainder = rem
    out = bytearray()
    for ftype, flags, stream, payload in frames:
        if ftype == T_HEADERS:
            # decode purely to track state/observability; frame unchanged
            try:
                block = payload
                if flags & F_PADDED and block:
                    pad = block[0]
                    block = block[1 : len(block) - pad]
                if flags & F_PRIORITY and len(block) >= 5:
                    block = block[5:]  # stream dep (4) + weight (1)
                state.seen_headers.append(state.hpack.decode(block))
            except (IndexError, ValueError):
                pass  # desync-tolerant, like the reference's kill-on-desync
            out += build_frame(ftype, flags, stream, payload)
        elif ftype == T_DATA and payload:
            body = payload
            new_flags = flags
            if flags & F_PADDED and body:
                pad = body[0]
                body = body[1 : len(body) - pad] if pad < len(body) else b""
                new_flags = flags & ~F_PADDED
            fuzzed = fuzzer(body)
            out += build_frame(ftype, new_flags, stream, fuzzed)
        else:
            out += build_frame(ftype, flags, stream, payload)
    return bytes(out)
