"""NHRP external module: the shipped real-protocol example for the -e hook
(the port's copy of erlamsa_tpu/services/external_nhrp.py).

Mirrors the reference's ``external_nhrp.erl`` (repo root of the
reference): a post-processor that re-fixes the NHRP packet checksum after
mutation, so fuzzed packets keep passing the target's integrity check and
the interesting payload bytes actually get parsed. Layout follows the
reference module exactly — a 4-byte fixed prefix, 12 header bytes, a
16-bit one's-complement checksum, then the body — and, like the
reference's ``fix_checksum``, the checksum is computed over the packet
WITHOUT the 4-byte prefix, checksum field zeroed (``packet:makesum``
semantics = the RFC 1071 internet checksum).

On top of the reference's post hook this module also provides the
``fuzzer`` capability used by gfcomms/proxy session fuzzing: a
protocol-shaped fuzz that preserves the 18-byte header structure, mutates
only the body through the full oracle engine, and re-fixes the checksum —
i.e. structure-aware fuzzing of a real protocol through the same -e seam
a user's own module would use.

Usage:  -e erlamsa_tpu_torch.services.external_nhrp
"""

from __future__ import annotations

_PREFIX = 4          # the reference's HSRP:32 fixed prefix
_HDR = 12            # Hdr:96
_CKSUM_OFF = _PREFIX + _HDR  # 2-byte checksum right after the header
_MIN = _CKSUM_OFF + 2


def capabilities() -> set[str]:
    return {"post", "fuzzer"}


def inet_checksum(data: bytes) -> int:
    """RFC 1071 one's-complement 16-bit checksum (packet:makesum)."""
    if len(data) % 2:
        data += b"\x00"
    total = 0
    for i in range(0, len(data), 2):
        total += (data[i] << 8) | data[i + 1]
        total = (total & 0xFFFF) + (total >> 16)
    return (~total) & 0xFFFF


def fix_checksum(data: bytes) -> bytes:
    """Rewrite the checksum field so the packet verifies; packets too
    short to carry the header pass through untouched (the reference's
    catch-all clause)."""
    if len(data) < _MIN:
        return data
    stub = data[_PREFIX:_CKSUM_OFF] + b"\x00\x00" + data[_MIN:]
    ck = inet_checksum(stub)
    return data[:_CKSUM_OFF] + ck.to_bytes(2, "big") + data[_MIN:]


def post(data: bytes) -> bytes:
    return fix_checksum(data)


def fuzzer(proto: str, data: bytes, session: dict | None) -> bytes:
    """Protocol-shaped session fuzz: keep the 18-byte NHRP header intact,
    oracle-fuzz the body, re-fix the checksum. Non-NHRP-sized payloads
    fall back to whole-packet fuzz (still checksum-fixed on the way out
    if they grew past the header)."""
    from ..oracle.engine import fuzz as oracle_fuzz
    from ..utils.erlrand import gen_urandom_seed

    session = session if isinstance(session, dict) else {}
    # deterministic within a session: successive calls advance a counter
    seed = session.get("nhrp_seed") or gen_urandom_seed()
    count = session["nhrp_count"] = session.get("nhrp_count", 0) + 1
    session["nhrp_seed"] = seed
    seed3 = (seed[0], seed[1] ^ count, seed[2])

    if len(data) <= _MIN:
        # whole-packet fuzz; if the result grew past the header it now has
        # a checksum field, which must verify (fix_checksum passes
        # still-short packets through untouched)
        return fix_checksum(oracle_fuzz(data, seed=seed3))
    head, body = data[:_MIN], data[_MIN:]
    fuzzed = oracle_fuzz(body, seed=seed3)
    return fix_checksum(head + fuzzed)
