"""Grammar expansion on the card: a bounded stack machine over compiled
tables, every sample of a panel stepping in lockstep (torch code; the
JAX package's ops/grammar.py runs one ``lax.scan`` per sample under
``vmap``).

gen/compile.py flattens a genfuzz grammar into fixed-shape int32 tables.
Each step pops every row's top entry (node, aux), computes the effect of
every node kind for the rows of that kind and selects by kind, as
``lax.switch`` under ``vmap`` does: emit up to ``emit`` bytes into the
row's panel, push children, draw. Loops ride the aux field as a repeat
count (one stack row regardless of the repeat count, so the stack bound
is static); sizers emit a placeholder field, open a record, and a
synthetic end-marker node closes it when the body has fully expanded.
After the last step the length fields are backpatched over the panel,
mirroring models/genfuzz's ``struct.pack(fmt, size) + body`` layout.

Determinism contract: every draw is counter-keyed as

    sample_key = fold_in(fold_in(fold_in(sub(base, TAG_GEN),
                                         grammar_id), case_idx), slot)
    draw j     = rand(fold_in(sample_key, j), n)

so the JAX expander, this one on any device, and the keyed host twin
(models/genfuzz.generate_keyed, a plain walk of the same tables
consuming the same (j, n) sequence) give the same panel byte for byte.

Truncation is deterministic on every side: ``pos`` counts TRUE bytes
(sizer lengths stay honest past the panel edge), writes clamp at the
panel width, and a sample is flagged truncated when it overran the
panel, exhausted the step budget, or blew the sizer-record budget. The
JAX scan always runs ``max_steps`` steps, the steps after a row's stack
empties doing nothing; this expander stops once every row's stack is
empty, which it reads on the host every ``CHECK_EVERY`` steps.
"""

from __future__ import annotations

import torch

from ..gen.compile import (ENDIAN_LITTLE, K_LOOP, K_PICK, K_PICKP, K_RANGE,
                           K_RBYTES, K_SEQ, K_SIZER, K_STATIC, K_SZEND,
                           K_VERB, CompiledGrammar)
from . import prng

K_NOP = 10  # the kind of a row whose stack is empty
CHECK_EVERY = 16  # steps between the host's reads of "every stack empty"


def gen_case_key(base: torch.Tensor, grammar_id, case_idx) -> torch.Tensor:
    """The (grammar, case) point of the TAG_GEN draw chain."""
    k = prng.fold_in(prng.sub(base, prng.TAG_GEN), grammar_id)
    return prng.fold_in(k, case_idx)


def gen_sample_key(base: torch.Tensor, grammar_id, case_idx,
                   slot) -> torch.Tensor:
    """Per-sample key; the host twin derives the identical key."""
    return prng.fold_in(gen_case_key(base, grammar_id, case_idx), slot)


def _lane_words(skey, j, lanes, fuzz):
    """The words of draws j + t, t < ``lanes``, of each row's key, in
    batched threefry passes: ``hi`` and ``lo`` [B, lanes] (the two words
    rand reduces: bits of each half of ``split(k, 2)``; a span of 256
    reads ``lo`` alone) and ``u`` [B, lanes] (``bits(k)``, which
    uniform_f32 scales: x1 ^ x2 of fold_in(k, 0), split's first half).
    With ``fuzz`` also ``rand_log(key of draw j + 2, 6)`` (a loop's
    blow-up: rand_nbit of sub key 2 over rand(sub key 1, 6)), its
    threefry work riding the same passes; else None."""
    dev = j.device
    idx = j.to(torch.int64)[:, None] + torch.arange(
        lanes, dtype=torch.int64, device=dev)
    k1, k2 = prng.threefry2x32(skey[:, 0:1], skey[:, 1:2], 0, idx)
    # fold_in(k, 0), fold_in(k, 1): split's halves; fold_in(k, 2): sub 2
    subs = torch.arange(3 if fuzz else 2, dtype=torch.int64, device=dev)
    a1, a2 = prng.threefry2x32(k1[..., None], k2[..., None], 0, subs)
    u = a1[..., 0] ^ a2[..., 0]
    B = idx.shape[0]
    h1, h2 = a1[..., :2].reshape(B, -1), a2[..., :2].reshape(B, -1)
    count = torch.zeros_like(h1)
    if fuzz:
        # split the draw j + 2 key's sub keys 1 and 2 in the same pass
        pair = torch.arange(2, dtype=torch.int64, device=dev).repeat(2)
        h1 = torch.cat([h1, a1[:, 2, 1:3].repeat_interleave(2, 1)], 1)
        h2 = torch.cat([h2, a2[:, 2, 1:3].repeat_interleave(2, 1)], 1)
        count = torch.cat([count, pair.expand(B, 4)], 1)
    x, y = prng.threefry2x32(h1, h2, 0, count)
    w = (x ^ y)[:, :2 * lanes].reshape(B, lanes, 2)
    log6 = None
    if fuzz:
        x, y = prng.threefry2x32(x[:, 2 * lanes:], y[:, 2 * lanes:], 0, 0)
        words = (x ^ y).reshape(B, 2, 2)
        nbit = prng.rand_from_words(words[:, 0], 6)
        top = torch.ones_like(nbit) << (nbit - 1).clamp(min=0)
        log6 = torch.where(nbit <= 0, 0,
                           top | prng.rand_from_words(words[:, 1], top))
    return w[..., 0], w[..., 1], u, log6


class _State:
    """The stack machine's state, one row per sample: the stack (S rows,
    then a column that swallows suppressed pushes), the panel (W bytes,
    then a column that swallows writes past the panel), the write
    position, the draw counter, the sizer records (R rows, then
    scratch) and the overflow flag."""

    def __init__(self, B, S, W, R, root, dev):
        i32 = torch.int32
        self.root = root
        self.snode = torch.empty((B, S + 1), dtype=i32, device=dev)
        self.saux = torch.empty((B, S + 1), dtype=i32, device=dev)
        self.sp = torch.empty(B, dtype=i32, device=dev)
        self.out = torch.empty((B, W + 1), dtype=torch.uint8, device=dev)
        self.pos = torch.empty(B, dtype=i32, device=dev)
        self.j = torch.empty(B, dtype=i32, device=dev)
        self.nrec = torch.empty(B, dtype=i32, device=dev)
        self.recs = torch.empty((5, B, R + 1), dtype=i32, device=dev)
        self.of = torch.empty(B, dtype=torch.bool, device=dev)
        self.skey = torch.empty((B, 2), dtype=torch.int64, device=dev)

    def reset(self, skey):
        """Every row at its start: the root on the stack, nothing
        emitted, keyed by ``skey``; in place, so a captured graph
        replays over it."""
        for x in (self.snode, self.saux, self.out, self.pos, self.j,
                  self.nrec, self.recs, self.of):
            x.zero_()
        self.snode[:, 0] = self.root
        self.saux[:, 0] = 1
        self.sp.fill_(1)
        self.skey.copy_(skey)

    _ROWS = ("snode", "saux", "sp", "out", "pos", "j", "nrec", "of",
             "skey")

    def take(self, keep):
        """The rows ``keep`` selects, as a state of their own."""
        sub = object.__new__(_State)
        sub.root = self.root
        for name in self._ROWS:
            setattr(sub, name, getattr(self, name)[keep])
        sub.recs = self.recs[:, keep]
        return sub

    def put(self, rows, st, which):
        """Store the rows ``which`` of ``st`` (rows ``rows`` of this
        state) here."""
        at = rows[which]
        for name in ("out", "pos", "sp", "of", "nrec"):
            getattr(self, name)[at] = getattr(st, name)[which]
        self.recs[:, at] = st.recs[:, which]


class _Tables:
    """A compiled grammar's tables on one device, the step's constants,
    and on the card the captured step graphs by row count."""

    def __init__(self, cg: CompiledGrammar, device):
        def put(a, dtype):
            return torch.as_tensor(a, dtype=dtype).to(device)

        self.prod = put(cg.prod, torch.int32)
        self.children = put(cg.children, torch.int32)
        self.cweights = put(cg.cweights, torch.int32)
        self.pool = put(cg.pool, torch.uint8)
        self.prob = put(cg.fuzz_prob, torch.float32)
        self.consts = (torch.arange(int(cg.emit), device=device)[None, :],
                       torch.arange(int(cg.max_child), device=device)[None, :],
                       put(1, torch.int32), put(2, torch.int32),
                       put(65536, torch.int32))
        self.graphs = {}


def make_expand(cg: CompiledGrammar, fuzz: bool = False):
    """Build the batch expander for one compiled grammar.

    Returns ``expand(base, case_idx, slots) -> (panel, lens, truncated)``
    with panel uint8[B, width], lens/truncated int32[B], on the device of
    ``base`` (the port's int64[2] root key, ``prng.base_key``);
    ``case_idx`` is one case for every slot or one case per slot. With
    ``fuzz`` the expansion mutates leaves at the grammar's 1/depth
    probability (fuzz_grammar's scaling); draws stay counter-keyed, so
    batched == per-sample == host twin either way. ``expand.steps`` is
    the step count of the last call (at most ``cg.max_steps``).
    """
    W = int(cg.width)
    EMIT = int(cg.emit)
    S = int(cg.stack)
    R = int(cg.max_recs)
    MAXC = int(cg.max_child)
    STEPS = int(cg.max_steps)
    root = int(cg.root)
    gid = int(cg.grammar_id)
    # draws a step reads past j: three, or a K_RBYTES node's n
    lanes = max([3] + [int(a) for k, a, *_r in cg.prod.tolist()
                       if k == K_RBYTES])
    pushes = max(MAXC, 2)
    tables = {}

    def rand(hi, lo, n):
        return prng.rand_from_words(torch.stack([hi, lo], -1),
                                    n.to(torch.int64)).to(torch.int32)

    def step(st, t):
        """One step of every row of ``st``: pop, draw, emit, push,
        open or close sizer records; the state is updated in place."""
        lane, cwin, one, two, w65536 = t.consts
        # a float32 0-d tensor: the comparison runs in float32, as jnp's
        prob = t.prob if fuzz else None

        def below(u):
            """uniform_f32 of the key whose bits(k) is ``u``, < prob."""
            return (u >> 9).to(torch.float32) * (2.0 ** -23) < prob

        snode, saux, sp, out, pos, j = (st.snode, st.saux, st.sp, st.out,
                                        st.pos, st.j)
        recs, nrec, of = st.recs, st.nrec, st.of
        zero = torch.zeros_like(sp)
        active = sp > 0
        top = (sp - 1).clamp(min=0).long()[:, None]
        node = torch.where(active, snode.gather(1, top)[:, 0], 0)
        aux = torch.where(active, saux.gather(1, top)[:, 0], 0)
        p = t.prod[node.long()]
        kind = torch.where(active, p[:, 0], K_NOP)
        a, b, off, cnt = p[:, 1], p[:, 2], p[:, 3], p[:, 4]
        # repeat entries (loops) decrement in place instead of popping
        repeat = active & (kind != K_SZEND) & (aux > 1)
        saux.scatter_(1, top, torch.where(repeat, aux - 1, aux)[:, None])
        sp = torch.where(active & ~repeat, sp - 1, sp)

        hi, lo, u, log6 = _lane_words(st.skey, j, lanes, prob is not None)
        is_lit = (kind == K_STATIC) | (kind == K_VERB)
        is_range = kind == K_RANGE
        is_rb = kind == K_RBYTES
        is_sizer = kind == K_SIZER
        is_szend = kind == K_SZEND
        is_loop = kind == K_LOOP

        # the bytes a row emits: n of them from chunk, at pos
        lit = t.pool[(a[:, None] + lane).clamp(max=t.pool.shape[0] - 1)
                     .long()]
        if prob is None:
            rv = a + rand(hi[:, 0], lo[:, 0], b - a + 1)
            dj_range = one
            dj_lit = zero
        else:
            fuzzable = kind == K_STATIC  # K_VERB never fuzzes
            fire = below(u[:, 0]) & (b > 0) & fuzzable
            at = rand(hi[:, 1], lo[:, 1], b)
            v = (lo[:, 2] & 0xFF).to(torch.uint8)
            lit = torch.where(fire[:, None] & (lane == at[:, None]),
                              v[:, None], lit)
            dj_lit = torch.where(fuzzable, 1 + 2 * fire.to(torch.int32),
                                 0)
            rv = torch.where(below(u[:, 0]),
                             (lo[:, 1] & 0xFF).to(torch.int32),
                             a + rand(hi[:, 1], lo[:, 1], b - a + 1))
            dj_range = two
        rbytes = (lo & 0xFF).to(torch.uint8)
        if lanes < EMIT:
            rbytes = torch.nn.functional.pad(rbytes, (0, EMIT - lanes))
        chunk = torch.where(is_lit[:, None], lit, rbytes[:, :EMIT])
        chunk = torch.where(is_range[:, None] & (lane == 0),
                            rv.to(torch.uint8)[:, None], chunk)
        chunk = torch.where(is_sizer[:, None], 0, chunk)
        n = torch.where(is_lit, b, torch.where(
            is_range, 1, torch.where(is_rb | is_sizer, a, 0)))
        wp = pos.clamp(max=W)[:, None] + lane
        keep = (lane < n[:, None]) & (wp < W)
        out.scatter_(1, torch.where(keep, wp, W).long(), chunk)
        field_pos = pos
        pos = pos + n

        # draws j moves past
        dj = torch.where(is_lit, dj_lit, 0)
        dj = torch.where(is_range, dj_range, dj)
        dj = torch.where(is_rb, a, dj)
        dj = torch.where((kind == K_PICK) | (kind == K_PICKP), 1, dj)

        # what each row pushes, in push order: the pick, the pick_pref
        # clause, the loop body, the sizer's end marker and body, or a
        # sequence's children last to first (child 0 lands on top)
        pick = rand(hi[:, 0], lo[:, 0], cnt)
        drawn = rand(hi[:, 0], lo[:, 0], b)
        under = drawn[:, None] < t.cweights[(off[:, None] + cwin).long()]
        sel = torch.where(under.any(1), under.to(torch.int32).argmax(1), 0)
        times = rand(hi[:, 0], lo[:, 0], a) + 1
        dj_loop = one
        if prob is not None:
            fire = below(u[:, 1])
            blow = 1 + log6.to(torch.int32)
            times = torch.where(fire, times * blow, times)
            dj_loop = 2 + fire.to(torch.int32)
        dj = torch.where(is_loop, dj_loop, dj)
        avail = nrec < R
        child = torch.where(kind == K_PICK, off + pick, off)
        child = torch.where(kind == K_PICKP, off + sel, child)
        child = torch.where(is_sizer, off + 1, child)
        first = (kind == K_PICK) | (kind == K_PICKP) | is_loop | (
            is_sizer & avail)
        slot_child = [child] + [off] * (pushes - 1)
        slot_aux = [torch.where(is_loop, times,
                                torch.where(is_sizer, nrec, 1))]
        slot_aux += [torch.ones_like(off)] * (pushes - 1)
        valid = [first, is_sizer] + [torch.zeros_like(first)] * (
            pushes - 2)
        is_seq = kind == K_SEQ
        for s in range(MAXC):
            i = MAXC - 1 - s
            slot_child[s] = torch.where(is_seq, off + i, slot_child[s])
            slot_aux[s] = torch.where(is_seq, 1, slot_aux[s])
            valid[s] = torch.where(is_seq, i < cnt, valid[s])
        kids = t.children[torch.stack(slot_child, 1).long()]
        valid = torch.stack(valid, 1)
        at = sp[:, None] + valid.to(torch.int32).cumsum(1) - valid.to(
            torch.int32)
        at = torch.where(valid, at, S).long()
        snode.scatter_(1, at, kids)
        saux.scatter_(1, at, torch.stack(slot_aux, 1))
        sp = sp + valid.sum(1, dtype=torch.int32)

        # sizer records: open (field pos, body start, width, endian),
        # close (the body's length, or a fuzzed lie, as lo/hi halves)
        rslot = torch.where(is_sizer & avail, nrec, R).long()[:, None]
        for f, val in enumerate((field_pos, pos, zero, a, b)):
            recs[f].scatter_(1, rslot, val[:, None])
        of = of | (is_sizer & ~avail)
        nrec = nrec + (is_sizer & avail).to(torch.int32)
        ra = torch.where(is_szend, aux, R).clamp(0, R).long()[:, None]
        width = recs[3].gather(1, ra)[:, 0]
        blen = pos - recs[1].gather(1, ra)[:, 0]
        rlo, rhi = blen & 0xFFFF, blen >> 16
        if prob is not None:
            fire = below(u[:, 0])
            wide = width == 4
            d1 = rand(hi[:, 1], lo[:, 1],
                      torch.where(width == 1, 256, 65536))
            d2 = rand(hi[:, 2], lo[:, 2], w65536)
            rlo = torch.where(fire, torch.where(wide, d2, d1), rlo)
            rhi = torch.where(fire, torch.where(wide, d1, 0), rhi)
            dj = torch.where(is_szend, 1 + fire.to(torch.int32)
                             * torch.where(wide, 2, 1), dj)
        recs[1].scatter_(1, ra, rlo[:, None])
        recs[2].scatter_(1, ra, rhi[:, None])
        for x, new in ((st.sp, sp), (st.pos, pos), (st.j, j + dj),
                       (st.nrec, nrec), (st.of, of)):
            x.copy_(new)

    def run_eager(t, skey):
        """Step a fresh state of skey's rows to the end (the CPU path):
        every CHECK_EVERY steps, rows whose stacks emptied are parked and
        the rest stepped on. Returns (final state, steps)."""
        B = skey.shape[0]
        st = _State(B, S, W, R, root, skey.device)
        st.reset(skey)
        done = _State(B, S, W, R, root, skey.device)  # rows as they ended
        rows = torch.arange(B, device=skey.device)  # st's rows among the B
        steps = 0
        while steps < STEPS:
            if steps and steps % CHECK_EVERY == 0:
                live = st.sp > 0
                left = int(live.sum())
                if left == 0:
                    break
                if 2 * left <= len(rows):
                    done.put(rows, st, ~live)
                    rows = rows[live]
                    st = st.take(live)
            steps += 1
            step(st, t)
        done.put(rows, st, torch.ones_like(rows, dtype=torch.bool))
        return done, steps

    def run_graphed(t, skey):
        """Step skey's rows to the end on the card: CHECK_EVERY steps are
        one CUDA graph, captured once per row count (rounded up to a
        power of two, the extra rows repeating the first) and replayed
        over a state reset in place; the host launches one graph where
        eager steps launch some 700 kernels each. Returns (the rows'
        final state, steps)."""
        B = skey.shape[0]
        rows = max(8, 1 << (B - 1).bit_length())
        if rows not in t.graphs:
            st = _State(rows, S, W, R, root, skey.device)
            st.reset(skey[:1].expand(rows, 2))
            side = torch.cuda.Stream(skey.device)
            side.wait_stream(torch.cuda.current_stream(skey.device))
            with torch.cuda.stream(side):
                step(st, t)  # warm-up, outside the capture
            torch.cuda.current_stream(skey.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(CHECK_EVERY):
                    step(st, t)
            t.graphs[rows] = (st, graph)
        st, graph = t.graphs[rows]
        st.reset(torch.cat([skey, skey[:1].expand(rows - B, 2)]))
        steps = 0
        while steps < STEPS:
            if steps and not bool((st.sp > 0).any()):
                break
            if STEPS - steps >= CHECK_EVERY:
                graph.replay()
                steps += CHECK_EVERY
            else:
                step(st, t)
                steps += 1
        return st.take(slice(0, B)), steps

    def expand(base, case_idx, slots):
        dev = base.device
        if dev not in tables:
            tables[dev] = _Tables(cg, dev)
        t = tables[dev]
        slots = torch.as_tensor(slots, dtype=torch.int64).reshape(-1).to(dev)
        B = slots.shape[0]
        cases = torch.as_tensor(case_idx, dtype=torch.int64).to(dev)
        skey = prng.fold_in(gen_case_key(base, gid, cases).reshape(-1, 2),
                            slots)
        fin, steps = (run_graphed if dev.type == "cuda" else run_eager)(
            t, skey)
        # copies: a graph's state is reused by the next call
        out, pos, sp, of, nrec, recs = (fin.out.clone(), fin.pos.clone(),
                                        fin.sp, fin.of, fin.nrec,
                                        fin.recs.clone())

        # backpatch every closed record's length field; fields of distinct
        # records never share a byte inside the panel, so one scatter does
        fp, rlo, rhi, width, endian = (recs[f][:, :R] for f in range(5))
        le = torch.stack([rlo & 0xFF, (rlo >> 8) & 0xFF, rhi & 0xFF,
                          (rhi >> 8) & 0xFF], -1)
        k4 = torch.arange(4, device=dev)
        src = torch.where((endian == ENDIAN_LITTLE)[..., None], k4,
                          width[..., None] - 1 - k4).clamp(0, 3)
        vals = le.gather(2, src.long()).to(torch.uint8)
        where_ = fp.clamp(max=W)[..., None] + k4
        live = ((torch.arange(R, device=dev)[None, :] < nrec[:, None])
                [..., None] & (k4 < width[..., None]) & (where_ < W))
        out.scatter_(1, torch.where(live, where_, W).reshape(B, -1).long(),
                     vals.reshape(B, -1))
        truncated = (of | (sp > 0) | (pos > W)).to(torch.int32)
        expand.steps = steps
        return out[:, :W], pos.clamp(max=W), truncated

    expand.steps = 0
    return expand
