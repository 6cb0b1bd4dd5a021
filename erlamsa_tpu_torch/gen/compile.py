"""Grammar compiler: genfuzz grammars -> fixed-shape device tables
(a copy of erlamsa_tpu/gen/compile.py; the tables and ``grammar_id`` are
the JAX package's, byte for byte).

The reference expands a grammar recursively, one ErlRand draw at a time
(src/erlamsa_gf.erl; models/genfuzz.py is the faithful host port). That
shape — unbounded recursion, data-dependent output sizes — cannot run as
one batched device program. This module flattens a grammar once, at
build time, into a table-driven form: a production table of int32 rows,
a flat children array, a cumulative-weight array for pick_pref and a
uint8 literal pool, plus *static bounds* (panel width, stack depth, step
budget, sizer-record budget, per-node emission width) derived from the
grammar's depth and loop caps. ops/grammar.py walks these tables as a
bounded stack machine, every sample of a panel in lockstep;
models/genfuzz.generate_keyed walks the *same* tables with the *same*
counter-keyed draws on the host, which is what makes device output
byte-checkable.

DSL (text form accepted by --gen, s-expressions, ';' comments)::

    (static "GET /")            literal bytes ("\\r\\n\\t\\\\\\"\\xNN" escapes)
    (range 97 122)              one byte in [lo, hi]
    (rbyte) (rword) (rdword) (rddword)   1/2/4/8 random bytes
    (rbinary 6)                 n random bytes
    (pick A B ...)              uniform choice of an alternative
    (pick_pref (3 A ...) (1 B ...))      weighted choice of a clause
    (loop 8 BODY ...)           1..max repetitions of the body sequence
    (sizer u16be BODY ...)      length field over the body; fmt in
                                u8/u16be/u16le/u32be/u32le
    (block BODY ...)            grouping
    (session KEY "default")     replay-session slot; the device table
                                compiles the default verbatim

A file of s-expressions at top level is one grammar (a sequence).
Python-tuple grammars (models/genfuzz.py docstring) compile directly.
All spec/parse problems raise GenSpecError — the CLI turns those into
hard errors, never a silently-empty campaign.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np

# Production-table node kinds (prod[:, 0]).
K_STATIC = 0  # a=pool_off, b=len; fuzz flips one byte
K_RANGE = 1  # a=lo, b=hi; fuzz substitutes an out-of-range byte
K_RBYTES = 2  # a=n random bytes, drawn left-to-right
K_PICK = 3  # uniform child choice
K_PICKP = 4  # weighted child choice; b=total weight, cweights cumulative
K_LOOP = 5  # a=max_n; child[0]=body; fuzz multiplies the repeat count
K_SIZER = 6  # a=width, b=endian; children=[body, end-marker]
K_SZEND = 7  # a=width, b=endian; synthetic: closes a sizer record
K_SEQ = 8  # push children in order
K_VERB = 9  # a=pool_off, b=len; verbatim literal, never fuzzed
N_KINDS = 10

ENDIAN_BIG = 0
ENDIAN_LITTLE = 1

_SIZER_WE = {
    "u8": (1, ENDIAN_BIG),
    "u16be": (2, ENDIAN_BIG),
    "u16le": (2, ENDIAN_LITTLE),
    "u32be": (4, ENDIAN_BIG),
    "u32le": (4, ENDIAN_LITTLE),
}

# Hard caps: a grammar whose static bounds exceed these is a spec error
# (the device panel is fixed-shape; unbounded grammars belong on the
# sequential ErlRand path).
EMIT_CAP = 1024  # max bytes one node execution may emit
WIDTH_CAP = 8192  # max panel width
STEP_CAP = 4096  # max stack-machine steps per sample
REC_CAP = 256  # max sizer records per sample
STACK_CAP = 512
# Fuzzed loops multiply their repeat count by up to (1 + rand_log(6));
# budgets get this headroom factor before hitting the caps so moderate
# blowups complete instead of truncating.
FUZZ_HEADROOM = 4


class GenSpecError(ValueError):
    """A grammar spec/DSL problem: bad syntax, unknown node, bounds
    blown. The CLI treats this as a hard error."""


@dataclasses.dataclass
class CompiledGrammar:
    prod: np.ndarray  # int32 [n_nodes, 5]: kind, a, b, child_off, child_cnt
    children: np.ndarray  # int32 flat child-index array (+pad)
    cweights: np.ndarray  # int32 cumulative pick_pref weights (+sentinel pad)
    pool: np.ndarray  # uint8 literal pool (+emit pad)
    root: int  # root node index
    width: int  # output panel width W
    emit: int  # max bytes emitted by one node execution
    stack: int  # stack rows (incl. scratch slack)
    max_steps: int  # scan step budget
    max_recs: int  # sizer record rows
    max_child: int  # max children of any node
    depth: int  # _flatten_depth of the source grammar
    fuzz_prob: float  # 1/max(2*depth, 2) — fuzz_grammar's scaling
    grammar_id: int  # stable table hash; keys the TAG_GEN draw chain
    source: str  # short human label (builtin name / path / "<tuple>")


# ---------------------------------------------------------------- DSL --

_ESCAPES = {"n": 10, "r": 13, "t": 9, "0": 0, '"': 34, "\\": 92}


def _tokenize(text: str):
    toks: list[tuple[str, object, int]] = []  # (type, value, pos)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
        elif c == ";":
            while i < n and text[i] != "\n":
                i += 1
        elif c in "()":
            toks.append((c, c, i))
            i += 1
        elif c == '"':
            j, buf = i + 1, bytearray()
            while j < n and text[j] != '"':
                if text[j] == "\\":
                    if j + 1 >= n:
                        raise GenSpecError(f"unterminated escape at byte {j}")
                    e = text[j + 1]
                    if e == "x":
                        if j + 3 >= n:
                            raise GenSpecError(f"bad \\x escape at byte {j}")
                        try:
                            buf.append(int(text[j + 2 : j + 4], 16))
                        except ValueError:
                            raise GenSpecError(
                                f"bad \\x escape at byte {j}"
                            ) from None
                        j += 4
                        continue
                    if e not in _ESCAPES:
                        raise GenSpecError(f"unknown escape \\{e} at byte {j}")
                    buf.append(_ESCAPES[e])
                    j += 2
                else:
                    buf.append(ord(text[j]) & 0xFF)
                    j += 1
            if j >= n:
                raise GenSpecError(f"unterminated string at byte {i}")
            toks.append(("str", bytes(buf), i))
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n();"':
                j += 1
            atom = text[i:j]
            try:
                toks.append(("int", int(atom, 0), i))
            except ValueError:
                toks.append(("sym", atom, i))
            i = j
    return toks


def _parse_sexprs(toks, i=0, depth=0):
    """Parse a token run into nested lists; returns (exprs, next_i)."""
    out = []
    while i < len(toks):
        t, v, pos = toks[i]
        if t == "(":
            inner, i = _parse_sexprs(toks, i + 1, depth + 1)
            if i >= len(toks) or toks[i][0] != ")":
                raise GenSpecError(f"unclosed '(' at byte {pos}")
            out.append(inner)
            i += 1
        elif t == ")":
            if depth == 0:
                raise GenSpecError(f"unbalanced ')' at byte {pos}")
            return out, i
        else:
            out.append(v)
            i += 1
    if depth != 0:
        raise GenSpecError("unclosed '(' at end of input")
    return out, i


def _sexpr_to_node(sx):
    """One parsed s-expression -> a python-tuple grammar node."""
    if isinstance(sx, bytes):
        return ("static", sx)
    if isinstance(sx, int):
        raise GenSpecError(f"bare integer {sx} outside a form")
    if not isinstance(sx, list) or not sx or not isinstance(sx[0], str):
        raise GenSpecError(f"expected (op ...), got {sx!r}")
    op, rest = sx[0].replace("-", "_"), sx[1:]
    if op == "static":
        if len(rest) != 1 or not isinstance(rest[0], bytes):
            raise GenSpecError('(static "...") wants one string')
        return ("static", rest[0])
    if op == "range":
        if len(rest) != 2 or not all(isinstance(x, int) for x in rest):
            raise GenSpecError("(range lo hi) wants two integers")
        lo, hi = rest
        if not (0 <= lo <= hi <= 255):
            raise GenSpecError(f"(range {lo} {hi}): want 0 <= lo <= hi <= 255")
        return ("range", lo, hi)
    if op in ("rbyte", "rword", "rdword", "rddword"):
        if rest:
            raise GenSpecError(f"({op}) takes no arguments")
        return (op,)
    if op == "rbinary":
        if len(rest) != 1 or not isinstance(rest[0], int) or rest[0] < 0:
            raise GenSpecError("(rbinary n) wants one non-negative integer")
        return ("rbinary", rest[0])
    if op == "pick":
        if not rest:
            raise GenSpecError("(pick ...) wants at least one alternative")
        return ("pick", [_sexpr_to_node(a) for a in rest])
    if op == "pick_pref":
        clauses = []
        for cl in rest:
            if (
                not isinstance(cl, list)
                or len(cl) < 2
                or not isinstance(cl[0], int)
                or cl[0] <= 0
            ):
                raise GenSpecError(
                    "(pick_pref (weight node ...) ...): each clause wants a "
                    "positive integer weight then a body"
                )
            clauses.append((cl[0], [_sexpr_to_node(x) for x in cl[1:]]))
        if not clauses:
            raise GenSpecError("(pick_pref ...) wants at least one clause")
        return ("pick_pref", clauses)
    if op == "loop":
        if len(rest) < 2 or not isinstance(rest[0], int) or rest[0] < 1:
            raise GenSpecError("(loop max body...) wants max >= 1 and a body")
        return ("loop", [_sexpr_to_node(x) for x in rest[1:]], rest[0])
    if op == "sizer":
        if len(rest) < 2 or rest[0] not in _SIZER_WE:
            raise GenSpecError(
                "(sizer fmt body...) wants fmt in "
                + "/".join(sorted(_SIZER_WE))
            )
        return ("sizer", rest[0], [_sexpr_to_node(x) for x in rest[1:]])
    if op == "block":
        return ("block", [_sexpr_to_node(x) for x in rest])
    if op in ("session", "session_get"):
        if (
            len(rest) != 2
            or not isinstance(rest[0], str)
            or not isinstance(rest[1], bytes)
        ):
            raise GenSpecError('(session key "default") wants a key + string')
        return ("session_get", rest[0], rest[1])
    raise GenSpecError(f"unknown grammar form ({op} ...)")


def parse_grammar(text: str) -> list:
    """DSL text -> python-tuple grammar (a list of nodes)."""
    exprs, _ = _parse_sexprs(_tokenize(text))
    if not exprs:
        raise GenSpecError("empty grammar")
    return [_sexpr_to_node(sx) for sx in exprs]


# Builtin grammars: small, exercise every node kind, usable as smoke /
# bench fixtures without shipping files around.
BUILTIN_GRAMMARS = {
    "demo-http": (
        '(static "GET /")\n'
        "(loop 8 (pick (range 97 122) (range 48 57) (static \"/\")))\n"
        '(static " HTTP/1.0\\r\\n")\n'
        '(pick_pref (3 (static "Host: a\\r\\n"))\n'
        '           (1 (static "X-Pad: ") (rbinary 4) (static "\\r\\n")))\n'
        '(static "\\r\\n")'
    ),
    "demo-tlv": (
        "(loop 4 (range 1 4) (sizer u16be (rbinary 6) "
        '(pick (static "") (static "!"))))\n'
        '(static "\\x00\\x00")'
    ),
    "demo-lines": (
        '(loop 6 (pick_pref (2 (static "key=") (rbinary 3))\n'
        '                   (1 (static "# comment")))\n'
        '        (static "\\n"))'
    ),
}


def load_grammar(spec: str) -> tuple[list, str]:
    """Resolve a --gen grammar reference: a builtin name or a DSL file
    path. Returns (grammar, label). Raises GenSpecError on anything
    unloadable or unparsable."""
    if spec in BUILTIN_GRAMMARS:
        return parse_grammar(BUILTIN_GRAMMARS[spec]), spec
    if os.path.exists(spec):
        try:
            with open(spec, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            raise GenSpecError(f"cannot read grammar file {spec}: {e}")
        try:
            return parse_grammar(text), os.path.basename(spec)
        except GenSpecError as e:
            raise GenSpecError(f"{spec}: {e}")
    raise GenSpecError(
        f"no builtin grammar or file named {spec!r} "
        f"(builtins: {', '.join(sorted(BUILTIN_GRAMMARS))})"
    )


# ----------------------------------------------------------- compiler --


def _norm(node):
    """Normalize to ("kind", ...) tuples; lists/bytes get wrapped."""
    if isinstance(node, list):
        return ("block", [_norm(x) for x in node])
    if isinstance(node, (bytes, bytearray)):
        return ("static", bytes(node))
    if not isinstance(node, tuple) or not node:
        raise GenSpecError(f"unknown grammar node {node!r}")
    kind = node[0]
    if kind in ("static", "range", "rbinary", "session_get"):
        return node
    if kind in ("rbyte", "rword", "rdword", "rddword"):
        return node
    if kind == "pick":
        if not node[1]:
            raise GenSpecError("pick with no alternatives")
        return ("pick", [_norm(g) for g in node[1]])
    if kind == "pick_pref":
        if not node[1]:
            raise GenSpecError("pick_pref with no clauses")
        if any(w <= 0 for w, _g in node[1]):
            raise GenSpecError("pick_pref weights must be positive")
        return ("pick_pref", [(int(w), _norm(g)) for w, g in node[1]])
    if kind == "loop":
        if int(node[2]) < 1:
            raise GenSpecError("loop max_n must be >= 1")
        return ("loop", _norm(node[1]), int(node[2]))
    if kind == "sizer":
        if node[1] not in _SIZER_WE:
            raise GenSpecError(f"sizer fmt {node[1]!r} not in {_SIZER_WE}")
        return ("sizer", node[1], _norm(node[2]))
    if kind == "block":
        return ("block", [_norm(g) for g in node[1]])
    raise GenSpecError(f"unknown grammar node {node!r}")


_RB_N = {"rbyte": 1, "rword": 2, "rdword": 4, "rddword": 8}


def _bounds(node):
    """Static bounds of a normalized node: (steps, bytes, stack, recs)."""
    kind = node[0]
    if kind in ("static", "session_get"):
        return 1, len(node[-1]), 1, 0
    if kind == "range":
        return 1, 1, 1, 0
    if kind in _RB_N:
        return 1, _RB_N[kind], 1, 0
    if kind == "rbinary":
        return 1, node[1], 1, 0
    if kind == "pick":
        subs = [_bounds(g) for g in node[1]]
        return (
            1 + max(s[0] for s in subs),
            max(s[1] for s in subs),
            max(s[2] for s in subs),
            max(s[3] for s in subs),
        )
    if kind == "pick_pref":
        subs = [_bounds(g) for _w, g in node[1]]
        return (
            1 + max(s[0] for s in subs),
            max(s[1] for s in subs),
            max(s[2] for s in subs),
            max(s[3] for s in subs),
        )
    if kind == "loop":
        st, by, sk, rc = _bounds(node[1])
        n = node[2]
        return 1 + n * st, n * by, 1 + sk, n * rc
    if kind == "sizer":
        st, by, sk, rc = _bounds(node[2])
        w, _e = _SIZER_WE[node[1]]
        return 2 + st, w + by, 1 + sk, 1 + rc
    if kind == "block":
        subs = [_bounds(g) for g in node[1]]
        steps = 1 + sum(s[0] for s in subs)
        nbytes = sum(s[1] for s in subs)
        k = len(subs)
        stack = max(
            [1] + [s[2] + (k - 1 - i) for i, s in enumerate(subs)]
        )
        return steps, nbytes, stack, sum(s[3] for s in subs)
    raise GenSpecError(f"unknown grammar node {node!r}")


class _Builder:
    def __init__(self):
        self.rows: list[list[int]] = []  # kind, a, b, child_off, child_cnt
        self.children: list[int] = []
        self.cweights: list[int] = []
        self.pool = bytearray()

    def row(self, kind, a=0, b=0) -> int:
        self.rows.append([kind, a, b, 0, 0])
        return len(self.rows) - 1

    def set_children(self, idx: int, kids: list[int], weights=None):
        self.rows[idx][3] = len(self.children)
        self.rows[idx][4] = len(kids)
        self.children.extend(kids)
        if weights is not None:
            acc = 0
            for w in weights:
                acc += w
                self.cweights.append(acc)
            self.rows[idx][2] = acc  # b = total weight
        else:
            self.cweights.extend([1 << 30] * len(kids))

    def lit(self, data: bytes) -> int:
        off = len(self.pool)
        self.pool.extend(data)
        return off

    def emit(self, node) -> int:
        kind = node[0]
        if kind == "static":
            return self.row(K_STATIC, self.lit(node[1]), len(node[1]))
        if kind == "session_get":
            return self.row(K_VERB, self.lit(node[2]), len(node[2]))
        if kind == "range":
            return self.row(K_RANGE, node[1], node[2])
        if kind in _RB_N:
            return self.row(K_RBYTES, _RB_N[kind])
        if kind == "rbinary":
            return self.row(K_RBYTES, node[1])
        if kind == "pick":
            idx = self.row(K_PICK)
            self.set_children(idx, [self.emit(g) for g in node[1]])
            return idx
        if kind == "pick_pref":
            idx = self.row(K_PICKP)
            kids = [self.emit(g) for _w, g in node[1]]
            self.set_children(idx, kids, weights=[w for w, _g in node[1]])
            return idx
        if kind == "loop":
            idx = self.row(K_LOOP, node[2])
            self.set_children(idx, [self.emit(node[1])])
            return idx
        if kind == "sizer":
            w, e = _SIZER_WE[node[1]]
            idx = self.row(K_SIZER, w, e)
            body = self.emit(node[2])
            end = self.row(K_SZEND, w, e)
            self.set_children(idx, [body, end])
            return idx
        if kind == "block":
            idx = self.row(K_SEQ)
            self.set_children(idx, [self.emit(g) for g in node[1]])
            return idx
        raise GenSpecError(f"unknown grammar node {node!r}")


def compile_grammar(grammar, width: int | None = None,
                    source: str = "<tuple>") -> CompiledGrammar:
    """Flatten a genfuzz grammar into device tables with static bounds.

    `grammar` is a python-tuple grammar (models/genfuzz.py docstring) or
    a DSL string. Raises GenSpecError when any static bound blows its
    cap — that is a spec problem, not a runtime one.
    """
    if isinstance(grammar, str):
        grammar = parse_grammar(grammar)
    # depth BEFORE normalization: fuzz_grammar computes it on the raw
    # tuple form, and the 1/depth scaling must match it exactly.
    from ..models.genfuzz import _flatten_depth

    depth = _flatten_depth(grammar)
    root_node = _norm(grammar)
    steps, nbytes, stack, recs = _bounds(root_node)

    b = _Builder()
    root = b.emit(root_node)
    prod = np.asarray(b.rows, dtype=np.int32)

    emit = 1
    for kind, a, bb, _o, _c in b.rows:
        if kind in (K_STATIC, K_VERB):
            emit = max(emit, bb)
        elif kind == K_RBYTES:
            emit = max(emit, a)
        elif kind == K_SIZER:
            emit = max(emit, a)
    if emit > EMIT_CAP:
        raise GenSpecError(
            f"a single literal/rbinary emits {emit} bytes "
            f"(cap {EMIT_CAP}); split it up"
        )
    if width is None:
        width = min(max(nbytes, 16), WIDTH_CAP)
    if width > WIDTH_CAP:
        raise GenSpecError(f"panel width {width} exceeds cap {WIDTH_CAP}")
    if stack + 8 > STACK_CAP:
        raise GenSpecError(
            f"grammar needs {stack} stack rows (cap {STACK_CAP})"
        )
    max_steps = min(FUZZ_HEADROOM * steps + 64, STEP_CAP)
    max_recs = max(min(FUZZ_HEADROOM * recs + 4, REC_CAP), 1)
    max_child = max([int(r[4]) for r in b.rows] + [1])

    children = np.asarray(
        (b.children or [0]) + [0] * max_child, dtype=np.int32
    )
    cweights = np.asarray(
        (b.cweights or [1 << 30]) + [1 << 30] * max_child, dtype=np.int32
    )
    pool = np.frombuffer(
        bytes(b.pool) + b"\x00" * max(emit, 1), dtype=np.uint8
    ).copy()

    canon = repr(
        (prod.tolist(), children.tolist(), cweights.tolist(),
         bytes(b.pool), root, width, max_steps, max_recs)
    ).encode()
    grammar_id = zlib.crc32(canon) & 0x7FFFFFFF

    return CompiledGrammar(
        prod=prod,
        children=children,
        cweights=cweights,
        pool=pool,
        root=root,
        width=int(width),
        emit=int(emit),
        stack=int(stack + 8 + max_child + 1),
        max_steps=int(max_steps),
        max_recs=int(max_recs),
        max_child=int(max_child),
        depth=int(depth),
        fuzz_prob=1.0 / max(depth * 2, 2),
        grammar_id=int(grammar_id),
        source=source,
    )
