"""Generation-based fuzzing combinators (genfuzz).

Reference: src/erlamsa_gf.erl — a small grammar DSL (static / range /
rbyte..rddword / rbinary / pick / pick_pref / loop / sizer / block /
session_get) whose tree is flattened once to estimate depth and then
generated with a fuzzing probability scaled by that depth
(erlamsa_gf:fuzz/3, :173-181).

A grammar is a list of nodes; each node is a tuple ("kind", ...):

    ("static", bytes)            literal bytes
    ("range", lo, hi)            one byte in [lo, hi]
    ("rbyte",) ("rword",) ("rdword",) ("rddword",)   random 1/2/4/8 bytes
    ("rbinary", n)               n random bytes
    ("pick", [grammar, ...])     uniform choice of a sub-grammar
    ("pick_pref", [(w, grammar), ...])   weighted choice
    ("loop", grammar, max_n)     1..max_n repetitions
    ("sizer", fmt, grammar)      length field over the generated block;
                                 fmt in {u8, u16be, u16le, u32be, u32le}
    ("block", [grammar...])      grouping (sizer target)
    ("session_get", key, default)   replay session state (gfcomms)

generate() is the pure expansion; fuzz_grammar() expands while mutating
leaves with probability ~ 1/depth, like the reference's scaled fuzzing.
generate_keyed() walks a COMPILED grammar (gen/compile.py) with counter-
keyed threefry draws: the host twin of the expander on the card
(ops/grammar.py). This module is a copy of erlamsa_tpu/models/genfuzz.py;
the keyed twin computes its draws with a threefry of its own in numpy.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.erlrand import ErlRand

_SIZER_FMT = {
    "u8": ("B", 1, "big"),
    "u16be": (">H", 2, "big"),
    "u16le": ("<H", 2, "little"),
    "u32be": (">I", 4, "big"),
    "u32le": ("<I", 4, "little"),
}


def _flatten_depth(node, depth=1) -> int:
    """Estimate grammar depth (the reference flattens twice,
    erlamsa_gf:173-181)."""
    if isinstance(node, list):
        return max((_flatten_depth(x, depth + 1) for x in node), default=depth)
    if not isinstance(node, tuple):
        return depth
    kind = node[0]
    if kind in ("pick",):
        return max(
            (_flatten_depth(g, depth + 1) for g in node[1]), default=depth
        )
    if kind == "pick_pref":
        return max(
            (_flatten_depth(g, depth + 1) for _w, g in node[1]), default=depth
        )
    if kind in ("loop", "sizer"):
        return _flatten_depth(node[-1] if kind == "loop" else node[2], depth + 1)
    if kind == "block":
        return max(
            (_flatten_depth(g, depth + 1) for g in node[1]), default=depth
        )
    return depth


def generate(r: ErlRand, grammar, session: dict | None = None,
             fuzz_prob: float = 0.0) -> bytes:
    """Expand a grammar to bytes; leaves mutate with fuzz_prob."""
    session = session if session is not None else {}

    def emit(node) -> bytes:
        if isinstance(node, list):
            return b"".join(emit(x) for x in node)
        if isinstance(node, (bytes, bytearray)):
            node = ("static", bytes(node))
        kind = node[0]
        if kind == "static":
            out = node[1]
            if fuzz_prob and r.rand_float() < fuzz_prob and out:
                # flip one byte of the literal
                p = r.rand(len(out))
                out = out[:p] + bytes([r.rand(256)]) + out[p + 1 :]
            return out
        if kind == "range":
            lo, hi = node[1], node[2]
            if fuzz_prob and r.rand_float() < fuzz_prob:
                return bytes([r.rand(256)])  # out-of-range byte
            return bytes([r.rand_span(lo, hi)])
        if kind == "rbyte":
            return r.rbyte()
        if kind == "rword":
            return r.rword()
        if kind == "rdword":
            return r.rdword()
        if kind == "rddword":
            return r.rddword()
        if kind == "rbinary":
            return r.random_block(node[1])
        if kind == "pick":
            return emit(r.rand_elem(node[1]))
        if kind == "pick_pref":
            total = sum(w for w, _g in node[1])
            n = r.rand(total)
            for w, g in node[1]:
                if n < w:
                    return emit(g)
                n -= w
            return emit(node[1][-1][1])
        if kind == "loop":
            times = r.erand(node[2])
            if fuzz_prob and r.rand_float() < fuzz_prob:
                times = times * (1 + r.rand_log(6))  # loop blowup
            return b"".join(emit(node[1]) for _ in range(times))
        if kind == "sizer":
            fmt, _width, _endian = _SIZER_FMT[node[1]]
            body = emit(node[2])
            size = len(body)
            if fuzz_prob and r.rand_float() < fuzz_prob:
                size = r.rand(1 << (8 * _width))  # lie about the length
            mask = (1 << (8 * _width)) - 1
            return struct.pack(fmt, size & mask) + body
        if kind == "block":
            return b"".join(emit(g) for g in node[1])
        if kind == "session_get":
            return bytes(session.get(node[1], node[2]))
        raise ValueError(f"unknown grammar node {node!r}")

    return emit(grammar)


def fuzz_grammar(r: ErlRand, grammar, session: dict | None = None) -> bytes:
    """Generate with depth-scaled fuzzing probability
    (erlamsa_gf:fuzz/3)."""
    depth = _flatten_depth(grammar)
    prob = 1.0 / max(depth * 2, 2)
    return generate(r, grammar, session, fuzz_prob=prob)




# ------------------------------------------------- keyed host twin ----

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_FIRST_BLOCK = 256  # draws computed at once when a sample starts


def _threefry(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on uint32 numpy arrays, wrapping as the
    hardware does: jax.random's block function, which ops/prng.py
    computes in torch."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x1 + ks[0]
    y = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + y
            y = ((y << np.uint32(r)) | (y >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        y = y + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, y


def _key_words(k1, k2):
    """For keys (k1, k2): the two words ``prng.rand`` reduces
    (``bits`` of each half of ``split(k, 2)``) and ``bits(k)``, the word
    ``uniform_f32`` scales. ``bits(k)`` is x1 ^ x2 of fold_in(k, 0),
    which is split's first half, so it comes free."""
    zero = np.zeros_like(k1)
    a1, a2 = _threefry(k1, k2, zero, zero)
    b1, b2 = _threefry(k1, k2, zero, zero + np.uint32(1))
    h1, h2 = _threefry(a1, a2, zero, zero)
    l1, l2 = _threefry(b1, b2, zero, zero)
    return h1 ^ h2, l1 ^ l2, a1 ^ a2


def _bounded(hi: int, lo: int, n: int) -> int:
    """``prng.rand`` from its two words: jax.random.randint's reduction
    into [0, n); 0 when n <= 0 (erlamsa_rnd:rand/1)."""
    if n <= 0:
        return 0
    span = n & _M32
    mult = ((65536 % span) ** 2 & _M32) % span  # uint32: 2^32 wraps to 0
    return (((hi % span) * mult + lo % span) & _M32) % span


class _KeyedDraws:
    """Draw j of one sample key (``fold_in(skey, j)``), computed for
    blocks of j at once: a walk that reads draw j also reads j + 1,
    j + 2, ... soon, so each block is one vectorized threefry pass
    instead of one per draw."""

    def __init__(self, skey):
        k1, k2 = (int(x) & _M32 for x in skey)
        self.k1, self.k2 = np.uint32(k1), np.uint32(k2)
        self.hi = self.lo = self.u = np.zeros(0, np.uint32)

    def _need(self, end: int):
        have = len(self.lo)
        if end <= have:
            return
        top = max(end, 2 * have, _FIRST_BLOCK)
        j = np.arange(have, top, dtype=np.uint32)
        kk1, kk2 = _threefry(np.full_like(j, self.k1),
                             np.full_like(j, self.k2),
                             np.zeros_like(j), j)
        hi, lo, u = _key_words(kk1, kk2)
        self.hi = np.concatenate([self.hi, hi])
        self.lo = np.concatenate([self.lo, lo])
        self.u = np.concatenate([self.u, u])

    def rand(self, j: int, n: int) -> int:
        """rand(fold_in(skey, j), n)."""
        self._need(j + 1)
        return _bounded(int(self.hi[j]), int(self.lo[j]), int(n))

    def bytes(self, j: int, n: int) -> bytes:
        """rand(fold_in(skey, j + t), 256) for t < n: jax's randint over
        a span of 256 reduces the second word alone."""
        self._need(j + n)
        return (self.lo[j:j + n] & np.uint32(0xFF)).astype(np.uint8).tobytes()

    def uniform_below(self, j: int, prob: np.float32) -> bool:
        """uniform_f32(fold_in(skey, j)) < prob, in float32."""
        self._need(j + 1)
        return bool(np.float32(self.u[j] >> np.uint32(9))
                    * np.float32(2.0 ** -23) < prob)

    def rand_log(self, j: int, n: int) -> int:
        """rand_log(fold_in(skey, j), n) (prng.rand_log): rand_nbit of
        sub key 2 over rand(sub key 1, n)."""
        kk = _threefry(np.asarray([self.k1]), np.asarray([self.k2]),
                       np.zeros(1, np.uint32), np.asarray([j], np.uint32))
        s1 = _threefry(*kk, np.zeros(1, np.uint32), np.ones(1, np.uint32))
        s2 = _threefry(*kk, np.zeros(1, np.uint32),
                       np.full(1, 2, np.uint32))
        hi, lo, _u = _key_words(*s1)
        bits = _bounded(int(hi[0]), int(lo[0]), n)
        if n <= 0 or bits <= 0:
            return 0
        top = 1 << max(bits - 1, 0)
        hi, lo, _u = _key_words(*s2)
        return top | _bounded(int(hi[0]), int(lo[0]), top)


def generate_keyed(cg, skey, fuzz: bool = False):
    """Counter-keyed expansion of a COMPILED grammar — the host twin of
    ops/grammar.py's expander on the card.

    ``generate()`` above follows the reference's sequential ErlRand
    stream and stays the gfcomms/per-sample path. This walk instead
    consumes draw j of a per-sample threefry key (``skey``: the port's
    int64[2] key tensor or a pair of 32-bit words), exactly the (j, n)
    sequence the device expander consumes — which makes this function
    both the byte-identity test oracle and the degraded path when the
    device is lost (gen/engine.py, chaos site ``gen.expand``).
    Truncation, sizer-record budgets and step budgets mirror the
    expander's static bounds.

    Returns (row bytes[width], length, truncated) — the full padded
    panel row, so tests can compare entire rows against the device.
    """
    from ..gen.compile import (ENDIAN_LITTLE, K_LOOP, K_PICK, K_PICKP,
                               K_RANGE, K_RBYTES, K_SEQ, K_SIZER, K_STATIC,
                               K_SZEND, K_VERB)

    prod = cg.prod.tolist()
    children = cg.children.tolist()
    cweights = cg.cweights.tolist()
    pool = bytes(cg.pool)
    W = int(cg.width)
    R = int(cg.max_recs)
    prob = np.float32(cg.fuzz_prob) if fuzz else None
    d = _KeyedDraws(skey.tolist() if hasattr(skey, "tolist") else skey)

    out = bytearray(W + max(int(cg.emit), 4))
    stack: list[tuple[int, int]] = [(int(cg.root), 1)]
    recs: list[list[int]] = []
    pos = j = steps = 0
    truncated = False

    def emit(data: bytes, n: int):
        nonlocal pos
        wp = min(pos, W)
        out[wp : wp + n] = data[:n]
        pos += n

    while stack and steps < int(cg.max_steps):
        steps += 1
        node, aux = stack[-1]
        kind, a, b, off, cnt = prod[node]
        if kind != K_SZEND and aux > 1:
            stack[-1] = (node, aux - 1)
        else:
            stack.pop()
        if kind in (K_STATIC, K_VERB):
            lit = pool[a : a + b]
            if prob is not None and kind == K_STATIC:
                fire = d.uniform_below(j, prob) and b > 0
                if fire:
                    p = d.rand(j + 1, b)
                    v = d.rand(j + 2, 256)
                    lit = lit[:p] + bytes([v]) + lit[p + 1 :]
                j += 1 + (2 if fire else 0)
            emit(lit, b)
        elif kind == K_RANGE:
            if prob is not None:
                v = d.rand(j + 1, 256) if d.uniform_below(j, prob) else (
                    a + d.rand(j + 1, b - a + 1))
                j += 2
            else:
                v = a + d.rand(j, b - a + 1)
                j += 1
            emit(bytes([v]), 1)
        elif kind == K_RBYTES:
            emit(d.bytes(j, a), a)
            j += a
        elif kind == K_PICK:
            c = d.rand(j, cnt)
            j += 1
            stack.append((children[off + c], 1))
        elif kind == K_PICKP:
            n = d.rand(j, b)
            j += 1
            sel = next(i for i in range(cnt) if n < cweights[off + i])
            stack.append((children[off + sel], 1))
        elif kind == K_LOOP:
            times = d.rand(j, a) + 1
            j += 1
            if prob is not None:
                fire = d.uniform_below(j, prob)
                if fire:
                    times *= 1 + d.rand_log(j + 1, 6)
                j += 1 + (1 if fire else 0)
            stack.append((children[off], times))
        elif kind == K_SIZER:
            avail = len(recs) < R
            field_pos = pos
            emit(b"\x00" * a, a)
            if avail:
                recs.append([field_pos, pos, 0, a, b])
                stack.append((children[off + 1], len(recs) - 1))
            else:
                truncated = True
            stack.append((children[off], 1))
        elif kind == K_SZEND:
            width = recs[aux][3]
            blen = pos - recs[aux][1]
            lo, hi = blen & 0xFFFF, blen >> 16
            if prob is not None:
                fire = d.uniform_below(j, prob)
                wide = width == 4
                if fire:
                    d1 = d.rand(j + 1, 256 if width == 1 else 65536)
                    lo, hi = (d.rand(j + 2, 65536), d1) if wide else (d1, 0)
                j += 1 + (2 if wide else 1) * int(fire)
            recs[aux][1], recs[aux][2] = lo, hi
        elif kind == K_SEQ:
            for i in reversed(range(cnt)):
                stack.append((children[off + i], 1))
        else:
            raise ValueError(f"bad compiled node kind {kind}")

    truncated = truncated or bool(stack) or pos > W
    for fp, lo, hi, width, endian in recs:
        le = (lo & 0xFF, (lo >> 8) & 0xFF, hi & 0xFF, (hi >> 8) & 0xFF)
        wp = min(fp, W)
        for k in range(width):
            out[wp + k] = le[k if endian == ENDIAN_LITTLE else width - 1 - k]
    return bytes(out[:W]), min(pos, W), truncated


def make_external_generator(grammar, seed=None):
    """Adapter: a grammar becomes a generator for the engine's genfuz slot
    (the reference's external module `generator` capability)."""
    from ..utils.erlrand import gen_urandom_seed

    r = ErlRand(seed or gen_urandom_seed())

    def gen():
        return [fuzz_grammar(r, grammar)], ("generator", "genfuz")

    return gen
