"""Case rounds: every mutation round of a case, for a batch of rows, in
one call (the ``ERLAMSA_PALLAS=2`` stream).

The port's counterpart of the JAX package's Pallas whole-case kernel
(erlamsa_tpu/ops/pallas_rounds.py::case_rounds_single, portable build).
Per row and round: the tables (line starts, digit runs, widenable and
binarish bytes, tail length-field candidates, the fuse context match),
the weighted pick over the 31 device mutators, the applied mutator's
edit program, its apply (splice, swap, mask, byte permute or line
permute) and the score update. A row pays only its own ``rounds``.

Random words: the row's key is ``sub(sample_key, TAG_SITE)``. Round r
reads the scalar draws ``bits(sub(key, TAG_SITE), (16, 64))[r]`` and the
vector draws ``bits(sub(key, TAG_PERM), (16, 6, L))[r]``; both are
computed here word by word (``prng.bits_at``), only where they are read.
The int32-pair arithmetic the TPU kernel needed for its 64-bit number
path is native int64 here, with the same wraparound.

Two versions compute the same function: the CUDA kernel
(csrc/case_rounds.cu) for tensors on a GPU, and ``case_rounds_plain``,
plain PyTorch, for tensors on the CPU (and as the kernel's yardstick).
``case_rounds`` takes the plain version only because its tensors lie on
the CPU; on a CUDA tensor it launches the kernel or raises. The kernel
holds a row in shared memory for the whole case when L <= SMEM_MAX_L
and works on it in device memory otherwise (``round_apply.path``); it
takes rows whose width is a multiple of 16, as every capacity class is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import ABSMAX_BINARY_BLOCK, MAX_BURST_MUTATIONS, MAX_SCORE, MIN_SCORE
from . import cuda_build, payloads, prng
from .fuse_mutators import MATCH_DEPTH
from .num_mutators import _INTERESTING_NP, _MAX_PARSE_DIGITS, _SCRATCH
from .num_mutators import INT64_MAX, _device_binarish, _render_decimal
from .payload_mutators import _AAA_COUNTS, payload_tables
from .registry import DEVICE_CODES, NUM_DEVICE_MUTATORS, PRED_INDEX_NP
from .round_apply import (
    K_MASK,
    K_NONE,
    K_PERM_BYTES,
    K_PERM_LINES,
    K_SPLICE,
    K_SWAP,
    SCRATCH,
    SMEM_MAX_L,
    SRC_LIT,
    SRC_SPAN,
    aligned,
    path,
)
from .rows import argmax_first, const, positions, select, take, take_table
from .utf8_mutators import funny_tables

R_MAX = MAX_BURST_MUTATIONS
M = NUM_DEVICE_MUTATORS
PERM_WINDOW = 256  # byte-permute window cap (fused.PERM_WINDOW)
PERM_LINES_W = 64  # line-permute window

_IDX = {c: k for k, c in enumerate(DEVICE_CODES)}

# scalar-draw slots of the per-round row of 64 words (pallas_rounds.py
# _SB_*): 0..M-1 are the weighted pick's draws, the rest are shared by
# purpose between the generators (only the applied one is read)
SB_POS, SB_VAL, SB_LEN, SB_AUX, SB_DELTA = M, M + 1, M + 2, M + 3, M + 4
SB_MASKOP, SB_PROB, SB_LOG2, SB_NUM = M + 5, M + 6, M + 7, M + 8
SB_PAYV, SB_PAYROW, SB_PAYREP, SB_PAYAUX = M + 18, M + 19, M + 20, M + 21
SB_LENT, SB_LENV, SB_LENPICK, SB_LENR = M + 22, M + 23, M + 24, M + 25
SB_LENF0, SB_LENF1 = M + 26, M + 27
SB_FUSEP, SB_FUSEDEP, SB_FUSEPICK, SB_FUSEFB = M + 28, M + 29, M + 30, M + 31
SB_FUSELEN = M + 32
SB_ROW = 64

# rows of the per-round [6, L] vector draws
VB_MASK0, VB_MASK1, VB_MASK2, VB_FY, VB_WIDE, VB_LPERM = range(6)
VB_ROWS = 6

_FIELDS = ("kind", "pos", "drop", "src", "src_start", "src_len", "reps",
           "lit_len", "a1", "l1", "l2", "ps", "pl", "mask_op", "mask_prob",
           "delta")

_lib = None
# kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# --- raw-word draw helpers (erlamsa_rnd distribution shapes) --------------
# A word is a uint32 held in int64; every count is an int64 tensor.


def _krand(b, n):
    """[0, n) by one modulo draw; 0 when n <= 0."""
    return torch.where(n <= 0, 0, torch.remainder(b, n.clamp(min=1)))


def _kerand(b, n):
    """[1, n]; 0 when n <= 0."""
    return torch.where(n <= 0, 0, _krand(b, n) + 1)


def _krand_range(b, lo, hi):
    """[lo, hi); lo when hi == lo; 0 when hi < lo."""
    v = _krand(b, hi - lo) + lo
    return torch.where(hi > lo, v, torch.where(hi == lo, lo, 0))


def _krand_log(b1, b2, n: int):
    """2^rand(n)-scale magnitude: 0 for a 0-bit draw."""
    bits = _krand(b1, torch.full_like(b1, n))
    hi = 1 << (bits - 1).clamp(min=0)
    v = hi | _krand(b2, hi)
    return torch.where(bits == 0, 0, v)


def _kdelta(b):
    """+1 / -1 from the low bit."""
    return torch.where((b & 1) == 1, -1, 1)


# --- 64-bit helpers of the number path -------------------------------------


def _word_pair(hi, lo):
    """The int64 bit pattern of the pair (hi, lo) of uint32 words."""
    return (hi << 32) | lo


def _mutate_num_bits(sb, v):
    """num_mutators._mutate_num on the round's scalar words: 12
    strategies (erlamsa_mutations.erl:95-112) in wrapping int64."""
    tbl = const(tuple(_INTERESTING_NP.tolist()), v.device)
    t = _krand(sb[:, SB_NUM], torch.full_like(v, 12))
    ntbl = torch.full_like(v, tbl.shape[0])
    interesting = take_table(tbl, _krand(sb[:, SB_NUM + 1], ntbl))
    interesting2 = take_table(tbl, _krand(sb[:, SB_NUM + 2], ntbl))
    half_max = INT64_MAX // 2
    absv = torch.where(v < 0, -v, v)  # INT64_MIN stays INT64_MIN
    absv2 = torch.where(absv > half_max, half_max, absv) << 1
    u = _word_pair(sb[:, SB_NUM + 3], sb[:, SB_NUM + 4])
    rnd_abs = prng.umod(u, torch.where(absv2 == 0, 1, absv2))
    strat9 = torch.where(v < 0, v + rnd_abs, v - rnd_abs)
    n129 = _krand(sb[:, SB_NUM + 5], torch.full_like(v, 128)) + 1
    bits = _krand(sb[:, SB_NUM + 6], n129).clamp(max=62)
    hi_p = 1 << (bits - 1).clamp(min=0)
    lo_p = prng.umod(_word_pair(sb[:, SB_NUM + 7], sb[:, SB_NUM + 8]), hi_p)
    lg = torch.where(bits <= 0, 0, hi_p | lo_p)
    s3 = _krand(sb[:, SB_NUM + 9], torch.full_like(v, 3))
    catch_all = torch.where(s3 == 0, v - lg, v + lg)
    return select(
        [t == 0, t == 1, t == 2, t == 3, (t == 4) | (t == 5), t == 7,
         t == 8, t == 9, t == 10],
        [v + 1, v - 1, torch.zeros_like(v), torch.ones_like(v), interesting,
         v + interesting2, v - interesting2, strat9, -v],
        catch_all)


# --- per-round tables ------------------------------------------------------


def _binarish(d, n):
    """erlamsa_utils:binarish on the first bytes; the TPU kernel reads
    byte min(k, L-1) for k < 10, so rows under 10 bytes wide clamp."""
    L = d.shape[1]
    idx = positions(10, d.device).clamp(max=L - 1)
    return _device_binarish(d[:, idx], n)


def _first_idx(mask, none_val):
    """First True index of each row, ``none_val`` where there is none."""
    return torch.where(mask.any(-1), argmax_first(mask), none_val)


def _sizer_candidates(di, i, n):
    """The five tail/near-tail length-field kinds (u8, u16be, u16le,
    u32be, u32le): (masks, values, widths), kind-major. Forward bytes
    wrap modulo L as the TPU kernel's rolls do; values are int32."""
    b1, b2, b3 = (torch.roll(di, -s, dims=1) for s in (1, 2, 3))
    vals = (di, prng.wrap32(di * 256 + b1), prng.wrap32(b1 * 256 + di),
            prng.wrap32(((di * 256 + b1) * 256 + b2) * 256 + b3),
            prng.wrap32(((b3 * 256 + b2) * 256 + b1) * 256 + di))
    widths = (1, 2, 2, 4, 4)
    nn = n[:, None]
    cands = []
    for vv, ww in zip(vals, widths):
        dlt = prng.wrap32(nn - (vv + i + ww))
        if ww == 1:
            near = (dlt >= 0) & (dlt <= 8)
        else:
            near = (dlt == 0) | (dlt == 1) | (dlt == 2) | (dlt == 4) | (dlt == 8)
        cands.append((vv > 2) & near & (i + ww <= nn) & (i < nn))
    return cands, vals, widths


class _Round:
    """One round's tables for a batch of rows: d uint8[b, L], n int64[b]."""

    def __init__(self, d, n):
        self.n = n
        L = d.shape[1]
        self.i = i = positions(L, d.device)[None, :]
        valid = i < n[:, None]
        self.di = di = d.to(torch.int64)
        is_nl = (di == 10) & valid
        prev_nl = torch.roll(is_nl, 1, dims=1) & (i > 0)
        start_mask = valid & ((i == 0) | prev_nl)
        self.nlines = start_mask.sum(-1)
        # line k starts at starts[k] (k < nlines), 0 past the last line
        rank = torch.cumsum(start_mask, -1) - 1
        slot = torch.where(start_mask, rank, L)
        starts = torch.zeros(d.shape[0], L + 1, dtype=torch.int64,
                             device=d.device)
        starts.scatter_(1, slot, i.expand_as(slot).contiguous())
        self.starts = starts[:, :L]
        self.is_digit = (di >= 48) & (di <= 57) & valid
        prev_digit = torch.roll(self.is_digit, 1, dims=1) & (i > 0)
        self.digit_starts = self.is_digit & ~prev_digit
        self.run_count = self.digit_starts.sum(-1)
        self.widenable = ((di & 0x3F) == di) & valid
        self.binarish = _binarish(d, n)

    def line_span(self, k):
        return _line_span(self.starts, self.nlines, self.n, k)


def _start_of(starts, nlines, k):
    """Start of line k; 0 when there is no line k."""
    has = (k >= 0) & (k < nlines)
    return torch.where(has, take(starts, k.clamp(min=0)), 0)


def _line_span(starts, nlines, n, k):
    """(start, length) of line k, k clamped to the lines there are."""
    k = torch.minimum(k.clamp(min=0), (nlines - 1).clamp(min=0))
    s = _start_of(starts, nlines, k)
    e = torch.where(k == nlines - 1, n, _start_of(starts, nlines, k + 1))
    return s, (e - s).clamp(min=0)


# --- one round ---------------------------------------------------------------


def _round(d, n, scores, pri, sb, vwords, words):
    """One mutation event on rows d uint8[b, L] (pallas_rounds._round).
    n int64[b], scores / pri int64[b, M], sb int64[b, 64] the round's
    scalar words, vwords(rows, vrow, idx) the round's vector words.
    ``words`` counts the threefry words the CUDA kernel computes (see
    case_rounds_plain). Returns (d', n', scores', applied or -1)."""
    b, L = d.shape
    dev = d.device
    t = _Round(d, n)
    i, di = t.i, t.di
    nonempty = n > 0
    text = nonempty & ~t.binarish
    s = lambda slot: sb[:, slot]  # noqa: E731

    # length-field candidates: one uniform draw over all of them, in
    # kind-major order (every u8 candidate by position, then u16be, ...)
    cands, vals, widths = _sizer_candidates(di, i, n)
    counts = [c.sum(-1) for c in cands]
    sz_total = sum(counts)
    sizer_any = sz_total > 0
    r_sz = _krand(s(SB_LENPICK), sz_total)
    running = torch.zeros_like(n)
    len_a, len_w = torch.zeros_like(n), torch.ones_like(n)
    len_kind, len_val = torch.zeros_like(n), torch.zeros_like(n)
    for kk, (ck, vv, ww) in enumerate(zip(cands, vals, widths)):
        hit = ck & (torch.cumsum(ck, -1) + running[:, None]
                    == (r_sz + 1)[:, None])
        anyh = hit.any(-1)
        len_a = torch.where(anyh, _first_idx(hit, 0), len_a)
        len_w = torch.where(anyh, ww, len_w)
        len_kind = torch.where(anyh, kk, len_kind)
        len_val = torch.where(anyh, torch.where(hit, vv, 0).sum(-1), len_val)
        running = running + counts[kk]
    len_end = torch.minimum(prng.wrap32(len_val + len_a + len_w), n)

    # fuse jump pair: context match of the bytes at p_f, wrapping mod L
    p_f = _krand(s(SB_FUSEP), n)
    k_f = (1 + _krand_log(s(SB_FUSEDEP), s(SB_LOG2), 3)).clamp(max=MATCH_DEPTH)
    match_f = torch.ones_like(t.widenable)
    for dd in range(MATCH_DEPTH):
        probe = take(d, (p_f + dd).clamp(0, L - 1)).to(torch.int64)
        fwd = torch.roll(di, -dd, dims=1)
        match_f &= (dd >= k_f)[:, None] | (fwd == probe[:, None])
    match_f &= (i < n[:, None]) & (i != p_f[:, None])
    tot_f = match_f.sum(-1)
    r_f = _krand(s(SB_FUSEPICK), tot_f)
    q_hit = _first_idx(match_f & (torch.cumsum(match_f, -1)
                                  == (r_f + 1)[:, None]), 0)
    q_fb = _krand(s(SB_FUSEFB), (n - 1).clamp(min=1))
    q_fb = q_fb + (q_fb >= p_f).to(torch.int64)
    q_f = torch.where(tot_f > 0, q_hit, q_fb)

    # applicability + weighted pick (first index among equal draws)
    preds = torch.stack([
        nonempty, n >= 2, (t.run_count > 0) & nonempty, text,
        text & (t.nlines >= 2), text & (t.nlines >= 3),
        t.widenable.any(-1) & nonempty, torch.zeros_like(nonempty),
        sizer_any, n >= 4], dim=-1)
    applicable = preds[:, const(tuple(PRED_INDEX_NP.tolist()), dev)] & (pri > 0)
    midx = positions(M, dev)[None, :]
    draws = torch.remainder(sb[:, :M], (scores * pri).clamp(min=1))
    best = torch.where(applicable, draws, -1).amax(-1, keepdim=True)
    any_app = applicable.any(-1)
    applied = torch.where(any_app, _first_idx(applicable & (draws == best), M),
                          0)
    d_app = take(draws, applied)[:, None]
    app_col = applied[:, None]
    tried_before = ((draws > d_app) | ((draws == d_app) & (midx < app_col))) \
        & any_app[:, None]

    # ---- every generator's program, as [b, M] columns -----------------
    P = {f: torch.zeros(b, M, dtype=torch.int64, device=dev) for f in _FIELDS}

    def setp(code, **kw):
        k = _IDX[code]
        for f, v in kw.items():
            P[f][:, k] = v

    delta_c = _kdelta(s(SB_DELTA))
    pos_u = _krand(s(SB_POS), n)
    b_at = take(d, pos_u.clamp(0, L - 1)).to(torch.int64)
    s_sp = pos_u
    l_sp = _krand(s(SB_LEN), n - s_sp) + 1

    # byte ops
    setp("bd", kind=K_SPLICE, pos=pos_u, drop=1, delta=delta_c)
    nb_flip = b_at ^ (1 << _krand(s(SB_VAL), torch.full_like(n, 8)))
    nb_rand = _krand(s(SB_VAL), torch.full_like(n, 256))
    for code in ("bei", "bed", "bf", "ber"):
        setp(code, kind=K_SPLICE, pos=pos_u, drop=1, src=SRC_LIT, lit_len=1,
             delta=delta_c)
    setp("bi", kind=K_SPLICE, pos=pos_u, drop=1, src=SRC_LIT, lit_len=2,
         delta=delta_c)
    setp("br", kind=K_SPLICE, pos=pos_u, drop=0, src=SRC_SPAN,
         src_start=pos_u, src_len=1, reps=1, delta=delta_c)

    # seq ops
    W = min(PERM_WINDOW, L)
    setp("sp", kind=K_PERM_BYTES, ps=pos_u,
         pl=_krand(s(SB_LEN), (n - pos_u).clamp(max=W)) + 1, delta=delta_c)
    reps_sr = _krand_log(s(SB_VAL), s(SB_LOG2), 10).clamp(min=2)
    setp("sr", kind=K_SPLICE, pos=s_sp, drop=l_sp, src=SRC_SPAN,
         src_start=s_sp, src_len=l_sp, reps=reps_sr, delta=delta_c)
    setp("sd", kind=K_SPLICE, pos=s_sp, drop=l_sp, delta=delta_c)
    prob = _kerand(s(SB_PROB), torch.full_like(n, 100))
    setp("snand", kind=K_MASK, ps=s_sp, pl=l_sp,
         mask_op=_krand(s(SB_MASKOP), torch.full_like(n, 3)),
         mask_prob=prob, delta=delta_c)
    setp("srnd", kind=K_MASK, ps=s_sp, pl=l_sp, mask_op=3, mask_prob=prob,
         delta=delta_c)

    # utf8: uw widens the first byte holding the largest key among the
    # widenable ones (position 0 when none is)
    pos_uw = torch.zeros_like(n)
    rows = torch.nonzero(applied == _IDX["uw"]).flatten()
    if rows.numel():
        keys = torch.where(t.widenable[rows],
                           vwords(rows, VB_WIDE, i.expand(rows.numel(), L)), 0)
        words[0] += int(t.widenable[rows].sum())
        pos_uw[rows] = _first_idx(keys == keys.amax(-1, keepdim=True), 0)
    b_uw = take(d, pos_uw.clamp(0, L - 1)).to(torch.int64)
    setp("uw", kind=K_SPLICE, pos=pos_uw, drop=1, src=SRC_LIT, lit_len=2,
         delta=delta_c)
    funny_t, funny_l = funny_tables(dev)
    row_ui = _krand(s(SB_VAL), torch.full_like(n, funny_t.shape[0]))
    setp("ui", kind=K_SPLICE, pos=pos_u + 1, src=SRC_LIT,
         lit_len=take_table(funny_l, row_ui), delta=delta_c)

    # num: parse the chosen digit run (with its dashes) -> mutate -> render
    which = _krand(s(SB_POS), t.run_count)
    target = t.run_count - 1 - which
    a_num = _first_idx(t.digit_starts & (torch.cumsum(t.digit_starts, -1)
                                         == (target + 1)[:, None]), 0)
    ac = a_num[:, None]
    b_end = _first_idx((i >= ac) & ~t.is_digit, n)
    last_non_dash = torch.where((i < ac) & (di != 45), i, -1).amax(-1)
    dash_count = a_num - 1 - last_non_dash
    a_ext = a_num - dash_count
    mag = torch.zeros_like(n)
    for k in range(_MAX_PARSE_DIGITS):
        dig = take(di, torch.remainder(a_num + k, L)) - 48
        mag = torch.where(a_num + k < b_end, mag * 10 + dig, mag)
    num_digits, len_num = _render_decimal(
        _mutate_num_bits(sb, torch.where(dash_count > 0, -mag, mag)))
    setp("num", kind=K_SPLICE, pos=a_ext, drop=b_end - a_ext, src=SRC_LIT,
         lit_len=len_num, delta=2)  # the real delta is scored after

    # line ops
    k_ld = _kerand(s(SB_POS), t.nlines) - 1
    s_ld, l_ld = t.line_span(k_ld)
    setp("ld", kind=K_SPLICE, pos=s_ld, drop=l_ld, delta=1)
    start_lds = _kerand(s(SB_POS), t.nlines)
    cnt_lds = _kerand(s(SB_LEN), t.nlines - start_lds + 1)
    s0_lds, _ = t.line_span(start_lds - 1)
    s2_lds, l2_lds = t.line_span(start_lds - 1 + cnt_lds - 1)
    setp("lds", kind=K_SPLICE, pos=s0_lds, drop=s2_lds + l2_lds - s0_lds,
         delta=1)
    setp("lr2", kind=K_SPLICE, pos=s_ld, drop=0, src=SRC_SPAN,
         src_start=s_ld, src_len=l_ld, reps=1, delta=1)
    fs_lri, fl_lri = t.line_span(_kerand(s(SB_POS), t.nlines) - 1)
    ts_lri, tl_lri = t.line_span(_kerand(s(SB_VAL), t.nlines) - 1)
    setp("lri", kind=K_SPLICE, pos=ts_lri, drop=tl_lri, src=SRC_SPAN,
         src_start=fs_lri, src_len=fl_lri, reps=1, delta=1)
    reps_lr = _krand_log(s(SB_VAL), s(SB_LOG2), 10).clamp(min=2)
    setp("lr", kind=K_SPLICE, pos=s_ld, drop=l_ld, src=SRC_SPAN,
         src_start=s_ld, src_len=l_ld, reps=reps_lr, delta=1)
    nl1 = (t.nlines - 1).clamp(min=0)
    k_ls = _kerand(s(SB_POS), nl1) - 1
    s1_ls, l1_ls = t.line_span(k_ls)
    _s2_ls, l2_ls = t.line_span(k_ls + 1)
    setp("ls", kind=K_SWAP, a1=s1_ls, l1=l1_ls, l2=l2_ls, delta=1)
    frm_lp = _kerand(s(SB_POS), nl1) - 1
    a_lp = _krand_range(s(SB_LEN), torch.full_like(n, 2),
                        (t.nlines - frm_lp - 1).clamp(min=2))
    b_lp = _krand_log(s(SB_VAL), s(SB_LOG2), 10)
    cnt_lp = torch.minimum(a_lp, b_lp).clamp(min=2).clamp(0, PERM_LINES_W)
    setp("lp", kind=K_PERM_LINES, ps=frm_lp, pl=cnt_lp, delta=1)
    ds_lis, dl_lis = t.line_span(_kerand(s(SB_AUX), t.nlines) - 1)
    ts_lis, tl_lis = t.line_span(_kerand(s(SB_POS), t.nlines) - 1)
    setp("lis", kind=K_SPLICE, pos=ts_lis, drop=0, src=SRC_SPAN,
         src_start=ds_lis, src_len=dl_lis, reps=1, delta=1)
    setp("lrs", kind=K_SPLICE, pos=ts_lis, drop=tl_lis, src=SRC_SPAN,
         src_start=ds_lis, src_len=dl_lis, reps=1, delta=1)

    # ab / ad: payload-table rows
    pay_t, pay_l = payload_tables(dev)
    full = lambda v: torch.full_like(n, v)  # noqa: E731
    v_ab = _krand(s(SB_PAYV), full(5))
    silly_row = payloads.SILLY0 + _krand(s(SB_PAYROW), full(payloads.N_SILLY))
    silly_reps = _krand(s(SB_PAYREP), full(20)) + 1
    t_aaa = _krand(s(SB_PAYREP), full(11))
    aaa_reps = torch.where(t_aaa < 10,
                           take_table(const(_AAA_COUNTS, dev), t_aaa.clamp(max=9)),
                           _krand(s(SB_PAYAUX), full(1024)))
    trav_row = payloads.TRAV0 + _krand(s(SB_PAYROW), full(2))
    trav_reps = _kerand(s(SB_PAYAUX), full(10))
    row_ab = select([v_ab <= 1, v_ab == 2, v_ab == 3],
                    [silly_row, full(payloads.AAA_ROW), trav_row],
                    full(payloads.NULL_ROW))
    reps_ab = select([v_ab <= 1, v_ab == 2, v_ab == 3],
                     [silly_reps, aaa_reps, trav_reps], full(1))
    ll_ab = take_table(pay_l, row_ab)
    setp("ab", kind=K_SPLICE, pos=torch.where(v_ab == 4, n, pos_u),
         drop=torch.where(v_ab == 1, ll_ab * reps_ab, 0), src=SRC_LIT,
         lit_len=ll_ab, reps=reps_ab, delta=delta_c)
    v_ad = _krand(s(SB_PAYV), full(4))
    row_ad = torch.where(
        v_ad < 3,
        payloads.DELIM0 + _krand(s(SB_PAYROW), full(payloads.N_DELIM)),
        payloads.SHELL0 + _krand(s(SB_PAYAUX), full(payloads.N_SHELL)))
    setp("ad", kind=K_SPLICE, pos=pos_u, drop=0, src=SRC_LIT,
         lit_len=take_table(pay_l, row_ad), reps=1, delta=delta_c)

    # len: rewrite / saturate / zero / expand the picked length field
    t_len = _krand(s(SB_LENT), full(7))
    new_len = ((s(SB_LENV) >> 2) * 2 & 0x7FFFFFFF).clamp(
        max=ABSMAX_BINARY_BLOCK)
    len_expand = t_len == 2
    setp("len", kind=torch.where(sizer_any, K_SPLICE, K_NONE),
         pos=torch.where(len_expand, len_end, len_a),
         drop=torch.where(len_expand, 0,
                          torch.where(t_len == 3, len_end - len_a, len_w)),
         src=SRC_LIT, lit_len=torch.where(len_expand, 8, len_w),
         reps=torch.where(len_expand,
                          1 + _krand_log(s(SB_LENR), s(SB_LOG2), 8), 1),
         delta=torch.where(sizer_any, 1, -1))

    # ft fn fo over the jump pair
    setp("ft", kind=K_SPLICE, pos=p_f, drop=n - p_f, src=SRC_SPAN,
         src_start=q_f, src_len=(n - q_f).clamp(min=1), reps=1, delta=delta_c)
    l_fuse = 1 + _krand(s(SB_FUSELEN), (n - q_f).clamp(min=1))
    setp("fn", kind=K_SPLICE, pos=p_f, drop=0, src=SRC_SPAN, src_start=q_f,
         src_len=l_fuse, reps=1, delta=delta_c)
    setp("fo", kind=K_SPLICE, pos=p_f,
         drop=_kerand(s(SB_AUX), (n - p_f).clamp(min=1)), src=SRC_SPAN,
         src_start=q_f, src_len=l_fuse, reps=1, delta=delta_c)
    # nil: the all-zero program (K_NONE)

    sel = {f: take(P[f], applied) for f in _FIELDS}
    kind = torch.where(any_app, sel["kind"], K_NONE)

    # ---- the applied splice's literal bytes --------------------------
    lit = torch.zeros(b, SCRATCH, dtype=torch.int64, device=dev)
    byte0 = select(
        [applied == _IDX["bei"], applied == _IDX["bed"],
         applied == _IDX["bf"], applied == _IDX["ber"]],
        [torch.remainder(b_at + 1, 256), torch.remainder(b_at - 1, 256),
         nb_flip, nb_rand], nb_rand)  # bi inserts the same random byte
    lit[:, 0] = byte0
    lit[:, 1] = torch.where(applied == _IDX["bi"], b_at, 0)
    ap = app_col
    lit = torch.where(ap == _IDX["uw"], 0, lit)
    lit[:, :2] = torch.where(ap == _IDX["uw"],
                             torch.stack([full(0xC0), b_uw | 0x80], -1),
                             lit[:, :2])
    ui = torch.zeros_like(lit)
    ui[:, :funny_t.shape[1]] = take_table(funny_t, row_ui)
    lit = torch.where(ap == _IDX["ui"], ui, lit)
    num_lit = torch.zeros_like(lit)
    num_lit[:, :_SCRATCH] = num_digits
    lit = torch.where(ap == _IDX["num"], num_lit, lit)
    row_pay = torch.where(applied == _IDX["ab"], row_ab, row_ad)
    lit = torch.where((ap == _IDX["ab"]) | (ap == _IDX["ad"]),
                      take_table(pay_t, row_pay)[:, :SCRATCH].to(torch.int64),
                      lit)
    # len: the field's new bytes (zeros, 0xFF, or the new length in the
    # field's byte order) or, to expand, 8 random fill bytes
    k4 = positions(4, dev)[None, :]
    le = ((len_kind == 2) | (len_kind == 4))[:, None]
    shift = torch.where(le, k4 * 8, (len_w[:, None] - 1 - k4) * 8)
    field = select([t_len[:, None] == 0, t_len[:, None] == 1],
                   [torch.zeros_like(shift), torch.full_like(shift, 0xFF)],
                   (new_len[:, None] >> shift.clamp(0, 31)) & 0xFF)
    k8 = positions(8, dev)[None, :]
    fill_word = torch.where(k8 < 4, s(SB_LENF0)[:, None], s(SB_LENF1)[:, None])
    fill = (fill_word >> ((k8 % 4) * 8)) & 0xFF
    len_lit = torch.zeros_like(lit)
    len_lit[:, :8] = torch.where(len_expand[:, None], fill, 0)
    len_lit[:, :4] = torch.where(len_expand[:, None], fill[:, :4], field)
    lit = torch.where(ap == _IDX["len"], len_lit, lit)

    # ---- the apply ---------------------------------------------------
    out, n1 = _apply(d, n, kind, sel, lit, t, vwords, words)

    # ---- score update (scheduler.adjust_scores) ----------------------
    bin2 = _binarish(out, n1)
    delta_f = torch.where(applied == _IDX["num"], torch.where(bin2, -1, 2),
                          sel["delta"])
    deltas = torch.where(tried_before, -1, 0) + torch.where(
        (midx == app_col) & any_app[:, None], delta_f[:, None], 0)
    scores1 = (scores + deltas).clamp(int(MIN_SCORE), int(MAX_SCORE))
    return out, n1, scores1, torch.where(any_app, applied, -1)


def _apply(d, n, kind, p, lit, t: _Round, vwords, words):
    """Each row's program on its row: (out, n'). Rolls of the TPU kernel
    index modulo L."""
    b, L = d.shape
    i = t.i
    col = lambda x: x[:, None]  # noqa: E731

    def at(idx):
        return torch.gather(d, 1, torch.remainder(idx, L))

    # SPLICE
    pos_c = torch.minimum(p["pos"].clamp(min=0), n)
    drop_c = torch.minimum(p["drop"].clamp(min=0), n - pos_c)
    rlen = select([p["src"] == SRC_SPAN, p["src"] == SRC_LIT],
                  [p["src_len"] * p["reps"],
                   p["lit_len"] * p["reps"].clamp(min=1)],
                  torch.zeros_like(n)).clamp(0, L)
    o = i - col(pos_c)
    cur = at(col(p["src_start"]) + torch.remainder(
        o.clamp(min=0), col(p["src_len"].clamp(min=1))))
    omod = torch.remainder(o.clamp(min=0), col(p["lit_len"].clamp(min=1)))
    lit_at = torch.where(omod < SCRATCH,
                         torch.gather(lit, 1, omod.clamp(max=SCRATCH - 1)), 0)
    repl = torch.where(col(p["src"] == SRC_LIT), lit_at, cur.to(torch.int64))
    tail = at(i - col(rlen) + col(drop_c))
    n_sp = (n - drop_c + rlen).clamp(0, L)
    sp = torch.where(i < col(pos_c), t.di,
                     torch.where(i < col(pos_c + rlen), repl, tail))
    sp = torch.where(i < col(n_sp), sp, 0)

    # SWAP
    a1, l1, l2 = col(p["a1"]), col(p["l1"]), col(p["l2"])
    sw = torch.where((i >= a1) & (i < a1 + l2), at(i + l1),
                     torch.where((i >= a1 + l2) & (i < a1 + l2 + l1),
                                 at(i - l2), d))

    out = select([col(kind == K_SPLICE), col(kind == K_SWAP)],
                 [sp, sw.to(torch.int64)], t.di).to(torch.uint8)

    # MASK: words of rows 0-2 only for the rows that mask
    rows = torch.nonzero(kind == K_MASK).flatten()
    if rows.numel():
        ir = i.expand(rows.numel(), L)
        occ_n = torch.remainder(vwords(rows, VB_MASK0, ir), 100)
        prob = col(p["mask_prob"][rows])
        occurs = torch.where(prob == 1, occ_n != 0, occ_n < prob)
        one = (1 << torch.remainder(vwords(rows, VB_MASK1, ir), 8)).to(
            torch.uint8)
        rnd = (vwords(rows, VB_MASK2, ir) & 0xFF).to(torch.uint8)
        dm, op = d[rows], col(p["mask_op"][rows])
        masked = select([op == 0, op == 1, op == 2],
                        [dm & ~one, dm | one, dm ^ one], rnd)
        ps, pl = col(p["ps"][rows]), col(p["pl"][rows])
        in_span = (i >= ps) & (i < ps + pl)
        out[rows] = torch.where(in_span & occurs, masked, dm)
        words[0] += int(in_span.sum() + (in_span & occurs).sum())

    # PERM_LINES
    rows = torch.nonzero(kind == K_PERM_LINES).flatten()
    if rows.numel():
        out[rows] = _perm_lines(d[rows], n[rows], p["ps"][rows],
                                p["pl"][rows], t, rows, vwords)
        words[0] += rows.numel() * min(PERM_LINES_W, L)

    # PERM_BYTES: the serial Fisher-Yates, batched over the rows that permute
    rows = torch.nonzero(kind == K_PERM_BYTES).flatten()
    if rows.numel():
        wf = min(PERM_WINDOW, L)
        w = positions(wf, d.device)[None, :]
        psr = col(p["ps"][rows])
        span = p["pl"][rows].clamp(0, wf)
        win = torch.gather(d[rows], 1, torch.remainder(psr + w, L))
        vrow = vwords(rows, VB_FY, w.expand(rows.numel(), wf))
        words[0] += int(span.sum())
        ar = torch.arange(rows.numel(), device=d.device)
        for step in range(int(span.max()) - 1):
            j = span - 1 - step
            live = j >= 1
            jc = j.clamp(min=0)
            r = torch.remainder(vrow[ar, jc], jc + 1)
            vj, vr = win[ar, jc], win[ar, r]
            win[ar, jc] = torch.where(live, vr, vj)
            win[ar, r] = torch.where(live, vj, vr)
        inwin = (i >= psr) & (i < psr + col(span))
        src = torch.remainder(i - psr, L).clamp(max=wf - 1)
        out[rows] = torch.where(inwin, torch.gather(win, 1, src), d[rows])

    n1 = torch.where(kind == K_SPLICE, n_sp, n)
    return out, n1


def _perm_lines(d, n, f, cnt, t: _Round, rows, vwords):
    """Permute up to 64 whole lines of the window starting at line f: the
    output's w-th segment is source line order[w], where order sorts the
    window's words descending (first index among equal words)."""
    b, L = d.shape
    dev = d.device
    Wl = PERM_LINES_W
    nlines = t.nlines[rows]
    f = torch.minimum(f.clamp(min=0), (nlines - 1).clamp(min=0))
    cnt = torch.minimum(cnt.clamp(min=0), (nlines - f).clamp(0, Wl))
    w = positions(Wl, dev)[None, :]
    line = f[:, None] + w
    starts = t.starts[rows]
    starts_w = _start_of(starts, nlines[:, None], line)
    nxt = _start_of(starts, nlines[:, None], line + 1)
    has_w = line < nlines[:, None]
    lens_w = torch.where(w < cnt[:, None],
                         torch.where(line == (nlines - 1)[:, None],
                                     n[:, None] - starts_w, nxt - starts_w), 0)
    lens_w = torch.where(has_w, lens_w.clamp(min=0), 0)
    wk = min(Wl, L)  # rows narrower than the window pad the keys with 0
    keys = torch.zeros(b, Wl, dtype=torch.int64, device=dev)
    keys[:, :wk] = vwords(rows, VB_LPERM, w[:, :wk].expand(b, wk))
    active = w < cnt[:, None]
    srt = torch.argsort(-torch.where(active, keys, -1), dim=-1, stable=True)
    order = torch.where(active, srt, w)
    plens = torch.gather(lens_w, 1, order)
    pstarts = torch.gather(starts_w, 1, order)
    cum = torch.cumsum(plens, -1)
    win_start = _line_span(starts, nlines, n, f)[0]
    total = torch.where(cnt > 0, take(cum, (cnt - 1).clamp(min=0)), 0)
    rel = t.i - win_start[:, None]
    j = torch.searchsorted(cum, rel.contiguous(), right=True).clamp(max=Wl - 1)
    prev = torch.gather(cum - plens, 1, j)
    src = t.i - win_start[:, None] - prev + torch.gather(pstarts, 1, j)
    moved = torch.gather(d, 1, torch.remainder(src, L))
    in_win = (rel >= 0) & (rel < total[:, None]) & (cnt > 0)[:, None]
    return torch.where(in_win, moved, d)


# --- the wrapper, the plain version and the kernel -----------------------


def _check(keys, data, n, scores, pri, rounds):
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("case_rounds: data must be uint8[B, L]")
    B = data.shape[0]
    want = ((keys, (torch.int64,), (B, 2), "keys"),
            (n, (torch.int32, torch.int64), (B,), "n"),
            (scores, (torch.int32, torch.int64), (B, M), "scores"),
            (pri, (torch.int32, torch.int64), (M,), "pri"),
            (rounds, (torch.int32, torch.int64), (B,), "rounds"))
    for x, dts, shape, name in want:
        if x.dtype not in dts or tuple(x.shape) != shape:
            raise ValueError(f"case_rounds: {name} must be {dts[0]}"
                             f"{list(shape)}, got {x.dtype}{list(x.shape)}")
        if x.device != data.device:
            raise ValueError("case_rounds: all operands on one device")


def case_rounds(keys, data, n, scores, pri, rounds):
    """All rounds of every row: (out uint8[B, L], n' int32[B], scores'
    int32[B, M], log int32[B, 16]; -1 for a round that applied nothing
    or did not run).

    keys int64[B, 2]: sub(sample_key, TAG_SITE) per row; data uint8[B, L];
    n [B]; scores [B, M]; pri [M]; rounds [B] (clamped to [0, 16])."""
    global launches
    _check(keys, data, n, scores, pri, rounds)
    if data.device.type == "cpu":
        return case_rounds_plain(keys, data, n, scores, pri, rounds)
    if data.device.type != "cuda":
        raise RuntimeError(f"case_rounds: unsupported device {data.device}")
    B, L = data.shape
    if L % 16:
        raise ValueError("case_rounds: the kernel takes rows whose width is a "
                         f"multiple of 16, got {L}")
    dev = data.device
    out = torch.empty_like(data)
    # the device-memory path ping-pongs between out and a scratch row
    scratch = torch.empty_like(data) if path(L) == "device" else None
    n_out = torch.empty(B, dtype=torch.int32, device=dev)
    sc_out = torch.empty(B, M, dtype=torch.int32, device=dev)
    log = torch.empty(B, R_MAX, dtype=torch.int32, device=dev)
    if B == 0:
        return out, n_out, sc_out, log
    c = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    keys, data = keys.contiguous(), aligned(data.contiguous())
    n_in, sc_in, pri_in, rd_in = c(n), c(scores), c(pri), c(rounds)
    # CTAs start in the order of their rows' round counts, most first
    order = torch.argsort(rd_in, descending=True, stable=True).to(torch.int32)
    funny_t, funny_l, itbl, pay_t, pay_l, layout = _tables(dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.case_rounds_launch(
            keys.data_ptr(), data.data_ptr(), n_in.data_ptr(),
            sc_in.data_ptr(), pri_in.data_ptr(), rd_in.data_ptr(),
            order.data_ptr(), funny_t.data_ptr(), funny_l.data_ptr(),
            funny_t.shape[0], itbl.data_ptr(), itbl.shape[0], pay_t.data_ptr(),
            pay_l.data_ptr(), pay_t.shape[0], pay_t.shape[1],
            layout.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n_out.data_ptr(), sc_out.data_ptr(), log.data_ptr(), B, L,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"case_rounds: kernel launch failed (cuda error {rc})")
    launches += 1
    return out, n_out, sc_out, log


@functools.lru_cache(maxsize=None)
def _tables(dev):
    """The constant tables as the kernel reads them, on ``dev``: funny
    table and lengths, interesting numbers, payload table and lengths,
    and the payload rows' layout."""
    funny_t, funny_l = funny_tables(dev)
    if funny_t.shape[1] != 4 or payloads.PAY_W < SCRATCH:
        raise RuntimeError("case_rounds: table widths differ from the kernel's")
    pay_t, pay_l = payload_tables(dev)
    itbl = const(tuple(_INTERESTING_NP.tolist()), dev)
    layout = const((payloads.SILLY0, payloads.N_SILLY, payloads.AAA_ROW,
                    payloads.TRAV0, payloads.NULL_ROW, payloads.DELIM0,
                    payloads.N_DELIM, payloads.SHELL0, payloads.N_SHELL), dev)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return (funny_t.contiguous(), i32(funny_l), itbl.contiguous(),
            pay_t.contiguous(), i32(pay_l), i32(layout))


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("case_rounds"))
        fn = lib.case_rounds_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 9 + [i, p, i, p, p, i, i] + [p] * 6
                       + [i, i, p])
        fn.restype = ctypes.c_int
        if lib.case_rounds_smem_max_l() != SMEM_MAX_L:
            raise RuntimeError("case_rounds: the kernel's shared-memory cap "
                               "differs from SMEM_MAX_L")
        _lib = lib
    return _lib


def ctas_per_sm(L: int) -> int:
    """Resident CTAs per SM of the kernel for rows of L bytes (the CUDA
    occupancy calculator, on the current card)."""
    n = _load().case_rounds_ctas_per_sm(L)
    if n < 0:
        raise RuntimeError(
            f"case_rounds: occupancy query failed (cuda error {-n})")
    return n


def case_rounds_plain(keys, data, n, scores, pri, rounds):
    """The same function in plain PyTorch, on any device."""
    return _case_rounds(keys, data, n, scores, pri, rounds, [0])


def kernel_words(keys, data, n, scores, pri, rounds) -> int:
    """The number of threefry words the CUDA kernel computes for these
    inputs: the two subkeys of every row, the 64 scalar words of every
    round, and the vector words of the applied mutator that it reads.
    It runs the plain version and counts; the count is an input to the
    kernel's bound (``chip_smoke.py``) and changes no output."""
    words = [0]
    _case_rounds(keys, data, n, scores, pri, rounds, words)
    return words[0]


def _case_rounds(keys, data, n, scores, pri, rounds, words):
    words[0] += 2 * data.shape[0]
    B, L = data.shape
    dev = data.device
    ks = prng.sub(keys, prng.TAG_SITE)
    kv = prng.sub(keys, prng.TAG_PERM)
    d = data.clone()
    n = n.to(torch.int64).clone()
    sc = scores.to(torch.int64).clone()
    pri = pri.to(torch.int64)[None, :]
    rounds = rounds.to(torch.int64).clamp(0, R_MAX)
    log = torch.full((B, R_MAX), -1, dtype=torch.int64, device=dev)
    slots = positions(SB_ROW, dev)[None, :]
    for r in range(int(rounds.max()) if B else 0):
        act = torch.nonzero(rounds > r).flatten()
        sb = prng.bits_at(ks[act], r * SB_ROW + slots)
        words[0] += SB_ROW * act.numel()
        kva = kv[act]

        def vwords(rows, vrow, idx, r=r, kva=kva):
            return prng.bits_at(kva[rows], (r * VB_ROWS + vrow) * L + idx)

        d[act], n[act], sc[act], log[act, r] = _round(
            d[act], n[act], sc[act], pri.expand(act.numel(), M), sb, vwords,
            words)
    return (d, n.to(torch.int32), sc.to(torch.int32), log.to(torch.int32))
