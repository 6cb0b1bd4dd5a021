"""HPACK (RFC 7541) header compression — decoder/encoder.

Reference vendors cowlib's cow_hpack (src/cow_hpack.erl +
src/cow_hpack_dec_huffman_lookup.hrl) for its HTTP/2 proxy path. This
implementation covers integer/string primitives, Huffman string coding
(models/huffman.py), the full static table, and a size-managed dynamic
table — so http2 header fuzzing sees real decoded strings. Invalid
Huffman payloads fall back to an opaque ``?huff:`` marker rather than
failing the whole block; re-encoding uses non-huffman literals (always
legal per the RFC).
"""

from __future__ import annotations

from .huffman import huffman_decode

STATIC_TABLE = [
    (b":authority", b""), (b":method", b"GET"), (b":method", b"POST"),
    (b":path", b"/"), (b":path", b"/index.html"), (b":scheme", b"http"),
    (b":scheme", b"https"), (b":status", b"200"), (b":status", b"204"),
    (b":status", b"206"), (b":status", b"304"), (b":status", b"400"),
    (b":status", b"404"), (b":status", b"500"), (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"), (b"accept-language", b""),
    (b"accept-ranges", b""), (b"accept", b""), (b"access-control-allow-origin", b""),
    (b"age", b""), (b"allow", b""), (b"authorization", b""),
    (b"cache-control", b""), (b"content-disposition", b""),
    (b"content-encoding", b""), (b"content-language", b""),
    (b"content-length", b""), (b"content-location", b""),
    (b"content-range", b""), (b"content-type", b""), (b"cookie", b""),
    (b"date", b""), (b"etag", b""), (b"expect", b""), (b"expires", b""),
    (b"from", b""), (b"host", b""), (b"if-match", b""),
    (b"if-modified-since", b""), (b"if-none-match", b""), (b"if-range", b""),
    (b"if-unmodified-since", b""), (b"last-modified", b""), (b"link", b""),
    (b"location", b""), (b"max-forwards", b""), (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""), (b"range", b""), (b"referer", b""),
    (b"refresh", b""), (b"retry-after", b""), (b"server", b""),
    (b"set-cookie", b""), (b"strict-transport-security", b""),
    (b"transfer-encoding", b""), (b"user-agent", b""), (b"vary", b""),
    (b"via", b""), (b"www-authenticate", b""),
]


def encode_integer(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    """RFC 7541 §5.1 prefix-coded integer."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append((value % 128) + 128)
        value //= 128
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    """Returns (value, next_pos)."""
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def decode_string(data: bytes, pos: int) -> tuple[bytes, bool, int]:
    """Returns (string, is_opaque, next_pos). Huffman payloads are decoded
    to their real octets; is_opaque is True only when a huffman payload is
    invalid and must be carried raw (caller marks it)."""
    huff = bool(data[pos] & 0x80)
    length, pos = decode_integer(data, pos, 7)
    raw = data[pos : pos + length]
    if huff:
        try:
            return huffman_decode(raw), False, pos + length
        except ValueError:
            return raw, True, pos + length
    return raw, False, pos + length


def encode_string(s: bytes) -> bytes:
    """Non-huffman literal (always legal)."""
    return encode_integer(len(s), 7) + s


class HpackContext:
    """One direction's decoding context (dynamic table)."""

    def __init__(self, max_size: int = 4096):
        self.max_size = max_size
        # (name, value, rfc_size): size is tracked OUT OF BAND, computed
        # from the wire-decoded octet lengths at insert time, so a decoded
        # value that happens to start with the '?huff:' fallback marker
        # can't skew the accounting
        self.dynamic: list[tuple[bytes, bytes, int]] = []

    def _size(self) -> int:
        return sum(sz for _n, _v, sz in self.dynamic)

    def _evict(self):
        while self.dynamic and self._size() > self.max_size:
            self.dynamic.pop()

    def add(self, name: bytes, value: bytes, entry_size: int | None = None):
        """entry_size: RFC 7541 §4.1 decoded-octets size (len(name) +
        len(value) + 32); derived from the stored strings when omitted."""
        if entry_size is None:
            entry_size = len(name) + len(value) + 32
        self.dynamic.insert(0, (name, value, entry_size))
        self._evict()

    def lookup(self, index: int) -> tuple[bytes, bytes]:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        dyn = index - len(STATIC_TABLE) - 1
        if 0 <= dyn < len(self.dynamic):
            return self.dynamic[dyn][:2]
        raise IndexError(f"hpack index {index} out of range")

    def decode(self, block: bytes) -> list[tuple[bytes, bytes]]:
        """Header block -> [(name, value)] with huffman strings decoded;
        invalid huffman payloads come back marked b'?huff:'+raw."""
        headers = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:  # indexed
                idx, pos = decode_integer(block, pos, 7)
                headers.append(self.lookup(idx))
            elif b & 0x40:  # literal with incremental indexing
                idx, pos = decode_integer(block, pos, 6)
                if idx:
                    name = self.lookup(idx)[0]
                    name_sz = len(name)
                else:
                    raw, hf, pos = decode_string(block, pos)
                    name = b"?huff:" + raw if hf else raw
                    name_sz = len(raw)
                raw, hf, pos = decode_string(block, pos)
                value = b"?huff:" + raw if hf else raw
                self.add(name, value, name_sz + len(raw) + 32)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = decode_integer(block, pos, 5)
                self.max_size = size
                self._evict()
            else:  # literal without indexing / never indexed (4-bit prefix)
                idx, pos = decode_integer(block, pos, 4)
                name = self.lookup(idx)[0] if idx else None
                if name is None:
                    raw, hf, pos = decode_string(block, pos)
                    name = b"?huff:" + raw if hf else raw
                raw, hf, pos = decode_string(block, pos)
                value = b"?huff:" + raw if hf else raw
                headers.append((name, value))
        return headers

    def encode(self, headers: list[tuple[bytes, bytes]]) -> bytes:
        """Simple encoder: indexed where a full static match exists, else
        literal-without-indexing with plain strings."""
        out = bytearray()
        for name, value in headers:
            try:
                idx = STATIC_TABLE.index((name, value)) + 1
                out += encode_integer(idx, 7, 0x80)
                continue
            except ValueError:
                pass
            name_idx = 0
            for i, (n, _v) in enumerate(STATIC_TABLE):
                if n == name:
                    name_idx = i + 1
                    break
            out += encode_integer(name_idx, 4, 0x00)
            if not name_idx:
                out += encode_string(name)
            out += encode_string(value)
        return bytes(out)
