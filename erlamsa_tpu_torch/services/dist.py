"""The frame codec of the distribution layer (erlamsa_tpu/services/
dist.py, its ``_pack_frame`` and ``_read_frame``): a length-prefixed
frame of a JSON header and a raw blob. The coverage hub
(services/monitors.py) reads connect-back edge bitmaps in these frames;
the rest of the distribution layer (nodes, the shard protocol) is not in
the port yet.
"""

from __future__ import annotations

import json
import struct

# a peer streaming one endless header must not exhaust memory
MAX_LINE = 64 * 1024 * 1024

#: first byte 0x8f can never start a JSON line, so a listener can sniff
#: one byte to route a connection to the framed or the JSON-lines loop
FRAME_MAGIC = b"\x8fEF1"
_FRAME_HDR = struct.Struct("<II")  # header_len, blob_len
#: raw byte panels ride the frame blob un-encoded; 1 GiB is far past any
#: legitimate batch slice
MAX_FRAME = 1 << 30


def _pack_frame(header: dict, blob: bytes = b"") -> bytes:
    """Encode one frame: MAGIC + (header_len, blob_len) + JSON header +
    raw blob."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    if len(hdr) > MAX_LINE or len(blob) > MAX_FRAME:
        raise ValueError("oversized frame")
    return b"".join((FRAME_MAGIC, _FRAME_HDR.pack(len(hdr), len(blob)),
                     hdr, blob))


def _read_frame(f) -> tuple[dict, bytes] | None:
    """Read one frame from a buffered reader; None on clean EOF. The
    reader's read(n) loops internally, so a short result outside EOF is
    impossible; any malformed prefix raises ValueError (a garbling peer
    is an error, never a hang)."""
    want = len(FRAME_MAGIC) + _FRAME_HDR.size
    head = f.read(want)
    if not head:
        return None
    if len(head) < want or head[:len(FRAME_MAGIC)] != FRAME_MAGIC:
        raise ValueError("malformed frame header")
    hlen, blen = _FRAME_HDR.unpack(head[len(FRAME_MAGIC):])
    if hlen > MAX_LINE or blen > MAX_FRAME:
        raise ValueError("oversized frame")
    hdr = f.read(hlen)
    blob = f.read(blen)
    if len(hdr) < hlen or len(blob) < blen:
        raise ValueError("truncated frame")
    return json.loads(hdr), blob
