// The apply of one edit program to one row, shared by the round kernel
// (round_apply.cu) and the case kernel (case_rounds.cu): splice, swap,
// mask and byte permute, as fused._splice_geometry and the TPU kernels'
// rolls define them (every roll indexes modulo L).
//
// A row is 16-byte aligned and L is a multiple of 16 (every capacity
// class is), so a thread assembles 16 consecutive output bytes at a time
// and stores them with one 16-byte store. The row it reads may lie in
// shared or in device memory (a generic pointer). Every per-byte index is
// 32-bit: the program's 64-bit geometry is reduced once per row to bounds
// inside [0, L] and to offsets taken modulo L once, so that a per-byte
// source index lies in [0, 2L) and wraps by one conditional subtract.
// Domain: 0 <= n <= L <= 1,000,000 (what the engine passes).

#pragma once

#include <cstdint>

#include "threefry.cuh"

namespace erl {

constexpr int K_NONE = 0, K_SPLICE = 1, K_SWAP = 2, K_PERM_BYTES = 3,
              K_PERM_LINES = 4, K_MASK = 5;
constexpr int SRC_SPAN = 1, SRC_LIT = 2;
constexpr int SCRATCH = 48;       // literal row
constexpr int PERM_WINDOW = 256;  // Fisher-Yates window cap

__device__ __forceinline__ long long pymod(long long a, long long m) {
  if (a >= 0 && a < m) return a;  // the usual case, without a division
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// x mod L for x in [0, 2L)
__device__ __forceinline__ int wrap_hi(int x, int L) {
  return x >= L ? x - L : x;
}

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(uint8_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// bytes s .. s+3 of the row, modulo L (s in [0, L))
__device__ __forceinline__ uint32_t window4(const uint8_t* row, int L,
                                            int s) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int k = s >> 2, nw = L >> 2;
  const uint32_t lo = w[k], hi = w[k + 1 < nw ? k + 1 : 0];
  return __funnelshift_r(lo, hi, (uint32_t)(s & 3) * 8u);
}

// bytes s .. s+15 of the row, modulo L (s in [0, L)): five aligned words
// and four funnel shifts
__device__ __forceinline__ uint4 window16(const uint8_t* row, int L, int s) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int nw = L >> 2;
  int k = s >> 2;
  uint32_t x[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    x[t] = w[k];
    k = k + 1 < nw ? k + 1 : 0;
  }
  const uint32_t sh = (uint32_t)(s & 3) * 8u;
  return make_uint4(__funnelshift_r(x[0], x[1], sh),
                    __funnelshift_r(x[1], x[2], sh),
                    __funnelshift_r(x[2], x[3], sh),
                    __funnelshift_r(x[3], x[4], sh));
}

__device__ __forceinline__ void put_byte(uint32_t (&o)[4], int j, uint32_t v) {
  o[j >> 2] |= (v & 0xFFu) << ((j & 3) * 8);
}

__device__ __forceinline__ uint32_t get_byte(const uint4& v, int j) {
  const uint32_t w = (j >> 2) == 0 ? v.x
                     : (j >> 2) == 1 ? v.y : (j >> 2) == 2 ? v.z : v.w;
  return (w >> ((j & 3) * 8)) & 0xFFu;
}

// One program, reduced to 32-bit bounds and offsets for a row of L bytes.
struct Apply {
  int kind, L, n_out;
  // splice: [0, pos_c) copies, [pos_c, end_ins) inserts, [end_ins, n_sp)
  // reads the tail at i + tail_shift, [n_sp, L) is zero
  int pos_c, end_ins, n_sp, tail_shift, src, s0, sl, ll, lit_cap;
  // swap: [a, m) reads i + l1m, else [m, e) reads i - l2m (modulo L);
  // both lie in [sw_lo, sw_hi)
  int sw_a, sw_m, sw_e, sw_lo, sw_hi, l1m, l2m;
  // mask span / byte-permute window [lo, hi); the window's start
  int lo, hi, ps, mask_op, mask_prob;
  // random words: row v of the program's draws is at wbase + v * L + i
  uint32_t k0, k1, wbase;
};

// Every argument as the engine's int32 program holds it (fused.PARAM_FIELDS
// order), widened to 64 bits: the products and sums are exact here.
__device__ __forceinline__ Apply make_apply(
    long long kind, long long pos, long long drop, long long src,
    long long src_start, long long src_len, long long reps, long long lit_len,
    long long a1, long long l1, long long l2, long long ps, long long pl,
    long long mask_op, long long mask_prob, long long n, int L, int lit_cap) {
  Apply a;
  const long long LL = L;
  a.kind = (int)kind;
  a.L = L;
  a.src = (int)src;
  a.lit_cap = lit_cap;
  a.mask_op = (int)clampll(mask_op, -1, 3);  // 0-2 bit ops, else replace
  a.mask_prob = (int)clampll(mask_prob, -1, 101);
  a.n_out = (int)n;
  // splice geometry (fused._splice_geometry)
  const long long pos_c = clampll(pos, 0, n);
  const long long drop_c = clampll(drop, 0, n - pos_c);
  long long rlen = src == SRC_SPAN ? src_len * reps
                   : (src == SRC_LIT ? lit_len * (reps > 1 ? reps : 1) : 0);
  rlen = clampll(rlen, 0, LL);
  const long long n_sp = clampll(n - drop_c + rlen, 0, LL);
  a.pos_c = (int)pos_c;
  a.end_ins = (int)(pos_c + rlen < n_sp ? pos_c + rlen : n_sp);
  a.n_sp = (int)n_sp;
  // tail: i in [end_ins, n_sp) reads i - rlen + drop_c, which lies in
  // [pos_c + drop_c, n) inside [0, L): no wrap
  a.tail_shift = (int)(drop_c - rlen);
  a.s0 = (int)pymod(src_start, LL);
  a.sl = (int)clampll(src_len, 1, 0x7FFFFFFF);
  a.ll = (int)clampll(lit_len, 1, 0x7FFFFFFF);
  if (kind == K_SPLICE) a.n_out = (int)n_sp;
  // swap
  a.sw_a = (int)clampll(a1, 0, LL);
  a.sw_m = (int)clampll(a1 + l2, 0, LL);
  a.sw_e = (int)clampll(a1 + l2 + l1, 0, LL);
  a.sw_lo = a.sw_a < a.sw_m ? a.sw_a : a.sw_m;
  a.sw_hi = a.sw_m > a.sw_e ? a.sw_m : a.sw_e;
  a.l1m = (int)pymod(l1, LL);
  a.l2m = (int)pymod(l2, LL);
  // mask span; the byte permute sets its window with perm_window
  a.lo = (int)clampll(ps, 0, LL);
  a.hi = (int)clampll(ps + pl, 0, LL);
  a.ps = 0;
  a.k0 = a.k1 = a.wbase = 0;
  return a;
}

__device__ __forceinline__ uint32_t draw(const Apply& a, int v, int i) {
  return threefry_word(a.k0, a.k1,
                       (uint64_t)(a.wbase + (uint32_t)v * (uint32_t)a.L +
                                  (uint32_t)i));
}

// Byte permute: stage the window d[(ps + w) mod L], w < min(256, L), in
// `win` and shuffle its first span bytes with the serial Fisher-Yates of
// the TPU kernel (one thread; the draws of row 3 in `vrow`). Every thread
// of the block calls it; it sets a.lo / a.hi / a.ps to the output window.
template <int THREADS>
__device__ void perm_window(Apply& a, const uint8_t* cur, long long ps,
                            long long pl, uint8_t* win, uint32_t* vrow) {
  const int L = a.L;
  const int wf = L < PERM_WINDOW ? L : PERM_WINDOW;
  const int span = (int)clampll(pl, 0, wf);
  const int p0 = (int)pymod(ps, L);
  for (int w = threadIdx.x; w < wf; w += THREADS) {
    win[w] = cur[wrap_hi(p0 + w, L)];  // p0 + w < 2L
    if (w < span) vrow[w] = draw(a, 3, w);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = span - 1; j >= 1; --j) {
      const uint32_t r = vrow[j] % (uint32_t)(j + 1);
      const uint8_t t = win[j];
      win[j] = win[r];
      win[r] = t;
    }
  }
  __syncthreads();
  // output bytes i in [ps, ps + span) read win[i - ps]
  a.lo = (int)clampll(ps, 0, L);
  a.hi = (int)clampll(ps + span, 0, L);
  a.ps = (int)clampll(ps, -PERM_WINDOW, L);
}

__device__ __forceinline__ uint32_t mask_byte(const Apply& a, int i,
                                              uint32_t v) {
  const uint32_t occ = draw(a, 0, i) % 100u;
  const bool occurs = a.mask_prob == 1 ? occ != 0 : (int)occ < a.mask_prob;
  if (!occurs) return v;
  if (a.mask_op >= 0 && a.mask_op <= 2) {
    const uint32_t one = 1u << (draw(a, 1, i) % 8u);
    return a.mask_op == 0 ? (v & ~one) : (a.mask_op == 1 ? (v | one)
                                                         : (v ^ one));
  }
  return draw(a, 2, i) & 0xFFu;
}

// The 16 output bytes at i0 (a multiple of 16) of program a on row cur.
// lit: the literal row (48 bytes), win: the permuted window.
__device__ uint4 apply_chunk(const Apply& a, const uint8_t* cur, int i0,
                             const uint8_t* lit, const uint8_t* win) {
  const int L = a.L, i1 = i0 + 16;
  if (a.kind == K_SPLICE) {
    if (i1 <= a.pos_c) return load16(cur + i0);
    if (i0 >= a.n_sp) return make_uint4(0, 0, 0, 0);
    if (i0 >= a.end_ins && i1 <= a.n_sp)
      return window16(cur, L, i0 + a.tail_shift);
    // mixed chunk or inside the insert: byte by byte, the repeat
    // positions advancing by one with a wrap (one modulo per chunk)
    const int off0 = i0 > a.pos_c ? i0 - a.pos_c : 0;
    int ms = (int)((uint32_t)off0 % (uint32_t)a.sl);
    int ml = (int)((uint32_t)off0 % (uint32_t)a.ll);
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j;
      uint32_t v = 0;
      if (i < a.pos_c) {
        v = cur[i];
      } else if (i < a.end_ins) {
        // ms <= i - pos_c < L, so s0 + ms < 2L
        v = a.src == SRC_LIT ? (ml < a.lit_cap ? lit[ml] : 0u)
                             : cur[wrap_hi(a.s0 + ms, L)];
        ms = ms + 1 == a.sl ? 0 : ms + 1;
        ml = ml + 1 == a.ll ? 0 : ml + 1;
      } else if (i < a.n_sp) {
        v = cur[i + a.tail_shift];
      }
      put_byte(o, j, v);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
  if (a.kind == K_SWAP) {
    if (i1 <= a.sw_lo || i0 >= a.sw_hi) return load16(cur + i0);
    // i < L and l1m, l2m in [0, L): both sources lie in [0, 2L)
    if (i0 >= a.sw_a && i1 <= a.sw_m)
      return window16(cur, L, wrap_hi(i0 + a.l1m, L));
    if (i0 >= a.sw_m && i1 <= a.sw_e)
      return window16(cur, L, wrap_hi(i0 - a.l2m + L, L));
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j;
      uint32_t v;
      if (i >= a.sw_a && i < a.sw_m)
        v = cur[wrap_hi(i + a.l1m, L)];
      else if (i >= a.sw_m && i < a.sw_e)
        v = cur[wrap_hi(i - a.l2m + L, L)];
      else
        v = cur[i];
      put_byte(o, j, v);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
  if (a.kind == K_MASK || a.kind == K_PERM_BYTES) {
    const uint4 c = load16(cur + i0);
    if (i1 <= a.lo || i0 >= a.hi) return c;
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = i0 + j;
      uint32_t v = get_byte(c, j);
      if (i >= a.lo && i < a.hi)
        v = a.kind == K_MASK ? mask_byte(a, i, v) : win[i - a.ps];
      put_byte(o, j, v);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
  return load16(cur + i0);  // every other kind copies
}

}  // namespace erl
