// Case rounds: every mutation round of a case for every row of a batch,
// in one launch.
//
// Replaces: erlamsa_tpu/ops/pallas_rounds.py::case_rounds_single, the
// Pallas whole-case kernel (_run -> _round) in its portable build. Each
// round of a row: the per-round tables (line starts, digit runs,
// widenable and binarish bytes, tail length-field candidates, the fuse
// context match), the weighted pick over the 31 device mutators, the
// applied mutator's edit program, its apply (splice, swap, mask, byte
// permute, line permute) and the score update. The random words are
// those of the portable build's operands, computed where they are read:
//   scalar words  bits(fold_in(key, TAG_SITE), (16, 64))[r, slot]
//   vector words  bits(fold_in(key, TAG_PERM), (16, 6, L))[r, row, i]
// (threefry.cuh). The TPU build's hardware-PRNG stream has no
// reproducible counterpart and is not a target.
//
// Bound on an H100: bytes. The row must cross device memory twice, read
// once and written once; the threefry words are 64 per round plus those
// of the applied mutator's span or window.
//
// Design: one CTA per row, looping over the row's own rounds, so a row
// pays only its own draw. Rows run from 0 to 16 rounds, so the CTAs are
// launched in the order of their rows' round counts, most first (the
// wrapper sorts them): the longest rows do not start last and set the
// launch's tail.
// - A row of L <= SMEM_MAX_L bytes (the 65536 class and below) lives in
//   shared memory for the whole case: loaded once with 16-byte loads,
//   ping-ponged between two shared buffers of L bytes, written once with
//   16-byte stores. Device memory sees the bound's own traffic.
// - Wider rows (262144, 1,000,000) ping-pong between the output row and a
//   scratch row in device memory (the parity makes the last round write
//   the output). The same code runs over both, through a generic row
//   pointer; the template parameter only chooses where the two buffers
//   are. The choice depends on L alone.
// - One fused table pass over [0, n): each thread takes a 4-byte word of
//   the row and the next one, and counts the line starts, digit-run
//   starts, widenable bytes and the five sizer kinds of its four
//   positions, the sizer value read from a funnel-shifted 4-byte window
//   (wrapping modulo L as the TPU kernel's rolls do). The eight counts are
//   reduced in one block reduction.
// - "The k-th position where p holds" (line starts, digit runs, sizer
//   candidates, fuse matches): each warp counts its slice of [0, n) by
//   ballots over consecutive positions, a scan of the warp counts finds
//   the warp that holds rank k, and that warp walks its slice again.
// - Index math is 32-bit (L <= 1,000,000); the apply (row_apply.cuh,
//   shared with the round kernel) assembles 16 output bytes per thread
//   and store, with the program's geometry reduced once per round.
// - The weighted pick is one warp: lane m draws for mutator m and a warp
//   reduction keeps the first index among the largest draws. The line
//   permute ranks its <= 64 keys in parallel, one thread per line.
// - Only the applied mutator's program is computed (every draw is
//   addressed by slot or word index, so skipping the others is exact).
//   Scalar decisions are made by every thread alike from shared values,
//   so control flow stays uniform across the block. The first-index tie
//   rules and the modulo-L reads of the TPU kernel are kept.
// - 128 threads a CTA and at most 128 registers a thread (ptxas spills
//   nothing): 4 CTAs per SM. The per-round work is short, serial in
//   parts and ends in barriers, so small CTAs and the longest-first
//   launch order keep the SMs busy.
// L must be a multiple of 16 (every capacity class is); 0 <= n <= L.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_apply.cuh"

namespace {

using namespace erl;

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;  // <= 128 registers: ptxas spills nothing
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX_L = 65536;
constexpr int M = 31;
constexpr int R_MAX = 16;
constexpr int SB_ROW = 64;
constexpr int VB_ROWS = 6;
constexpr int RENDER = 24;
constexpr int MAX_PARSE_DIGITS = 18;
constexpr int PERM_LINES_W = 64;
constexpr int MIN_SCORE = 2;
constexpr int MAX_SCORE = 10;
constexpr long long ABSMAX_BINARY_BLOCK = 1000000;
constexpr long long INT64_MAX_ = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr uint32_t TAG_PERM = 0x07;
constexpr uint32_t TAG_SITE = 0x09;

// mutator indices (registry.DEVICE_CODES order)
enum {
  UW, UI, NUM, BD, BEI, BED, BF, BI, BER, BR, SP, SR, SD, SNAND, SRND, LD,
  LDS, LR2, LRI, LR, LS, LP, LIS, LRS, AB, AD, LEN, FT, FN, FO, NIL
};

// predicate of each mutator (registry._DEVICE_MUTATORS)
enum {
  P_NONEMPTY, P_PAIR, P_HAS_DIGIT, P_TEXT, P_TEXT_2L, P_TEXT_3L,
  P_WIDENABLE, P_NEVER, P_SIZERQ, P_N4
};
__constant__ int PRED_OF[M] = {
    P_WIDENABLE, P_NONEMPTY, P_HAS_DIGIT, P_NONEMPTY, P_NONEMPTY,
    P_NONEMPTY,  P_NONEMPTY, P_NONEMPTY,  P_NONEMPTY, P_NONEMPTY,
    P_PAIR,      P_NONEMPTY, P_NONEMPTY,  P_NONEMPTY, P_NONEMPTY,
    P_TEXT,      P_TEXT,     P_TEXT,      P_TEXT,     P_TEXT,
    P_TEXT_2L,   P_TEXT_3L,  P_TEXT,      P_TEXT,     P_TEXT,
    P_TEXT,      P_SIZERQ,   P_N4,        P_N4,       P_N4,
    P_NEVER};

// interesting 'aaaa...' lengths of ab (erlamsa_mutations.erl:486-501)
__constant__ int AAA_COUNTS[10] = {127,   128,   255,   256,   16383,
                                   16384, 32767, 32768, 65535, 65536};

__constant__ uint32_t POW10[10] = {1u,      10u,      100u,      1000u,
                                   10000u,  100000u,  1000000u, 10000000u,
                                   100000000u, 1000000000u};

// scalar-word slots (pallas_rounds.py _SB_*)
constexpr int SB_POS = M, SB_VAL = M + 1, SB_LEN = M + 2, SB_AUX = M + 3,
              SB_DELTA = M + 4, SB_MASKOP = M + 5, SB_PROB = M + 6,
              SB_LOG2 = M + 7, SB_NUM = M + 8, SB_PAYV = M + 18,
              SB_PAYROW = M + 19, SB_PAYREP = M + 20, SB_PAYAUX = M + 21,
              SB_LENT = M + 22, SB_LENV = M + 23, SB_LENPICK = M + 24,
              SB_LENR = M + 25, SB_LENF0 = M + 26, SB_LENF1 = M + 27,
              SB_FUSEP = M + 28, SB_FUSEDEP = M + 29, SB_FUSEPICK = M + 30,
              SB_FUSEFB = M + 31, SB_FUSELEN = M + 32;

// vector-word rows (the apply reads rows 0-3 through row_apply.cuh)
constexpr int VB_WIDE = 4, VB_LPERM = 5;

// payload-table layout, as ops/payloads.py lays the rows out
enum {
  PL_SILLY0, PL_N_SILLY, PL_AAA_ROW, PL_TRAV0, PL_NULL_ROW, PL_DELIM0,
  PL_N_DELIM, PL_SHELL0, PL_N_SHELL, PL_FIELDS
};

struct Tables {
  const uint8_t* funny_t;  // [n_funny, funny_w]
  const int32_t* funny_l;
  int n_funny, funny_w;
  const int64_t* itbl;  // interesting numbers
  int n_itbl;
  const uint8_t* pay_t;  // [n_pay, pay_w]
  const int32_t* pay_l;
  int n_pay, pay_w;
  const int32_t* layout;  // PL_FIELDS entries
};

struct Prog {
  long long kind, pos, drop, src, src_start, src_len, reps, lit_len, a1, l1,
      l2, ps, pl, mask_op, mask_prob, delta;
};

struct Shared {
  uint32_t sb[SB_ROW];
  int scores[M];
  int pri[M];
  int log[R_MAX];
  uint32_t draws[M];
  int pick;
  int red[WARPS][8];
  int wcount[WARPS];
  unsigned long long warp64[WARPS];
  int sel[PERM_LINES_W + 1];
  uint8_t lit[SCRATCH];
  uint8_t win[PERM_WINDOW];
  uint32_t vrow[PERM_WINDOW];
  int lens_w[PERM_LINES_W];
  uint32_t keys[PERM_LINES_W];
  int order[PERM_LINES_W];
  int cum[PERM_LINES_W];
  int pstart[PERM_LINES_W];
  int plen[PERM_LINES_W];
};

// --- scalar helpers -------------------------------------------------------

__device__ __forceinline__ long long maxll(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ long long minll(long long a, long long b) {
  return a < b ? a : b;
}

// int32 two's-complement wrap of an exact value
__device__ __forceinline__ long long wrap32(long long x) {
  return (long long)(int32_t)(uint32_t)(unsigned long long)x;
}

// rand: [0, n) by one modulo draw, 0 when n <= 0
__device__ __forceinline__ long long krand(uint32_t b, long long n) {
  return n <= 0 ? 0 : (long long)(b % (uint32_t)n);
}

__device__ __forceinline__ long long kerand(uint32_t b, long long n) {
  return n <= 0 ? 0 : krand(b, n) + 1;
}

__device__ __forceinline__ long long krand_range(uint32_t b, long long lo,
                                                 long long hi) {
  return hi > lo ? krand(b, hi - lo) + lo : (hi == lo ? lo : 0);
}

__device__ __forceinline__ long long krand_log(uint32_t b1, uint32_t b2,
                                               long long n) {
  const long long bits = krand(b1, n);
  const long long hi = 1LL << maxll(bits - 1, 0);
  const long long v = hi | krand(b2, hi);
  return (bits == 0 || n <= 0) ? 0 : v;
}

__device__ __forceinline__ long long kdelta(uint32_t b) {
  return (b & 1u) ? -1 : 1;
}

__device__ __forceinline__ bool is_digit(uint32_t c) { return c - 48u < 10u; }

// erlamsa_utils:binarish on the first 8 bytes (bytes min(k, L-1), k < 10)
__device__ bool binarish(const uint8_t* d, int n, int L) {
  int b[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) b[k] = d[k < L - 1 ? k : L - 1];
  int first_bad = 8, first_bom = 8;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    const bool v = k < n;
    const bool bad = (b[k] == 0 || b[k] >= 128) && v;
    const bool bom = ((b[k] == 0xEF && b[k + 1] == 0xBB && b[k + 2] == 0xBF) ||
                      (b[k] == 0xFE && b[k + 1] == 0x0F)) &&
                     v;
    if (bad) first_bad = k;
    if (bom) first_bom = k;
  }
  return first_bad < 8 && first_bad < first_bom;
}

// --- the tail length-field kinds (u8, u16be, u16le, u32be, u32le) --------

__device__ __forceinline__ int sz_width(int kk) {
  return kk == 0 ? 1 : (kk <= 2 ? 2 : 4);
}

// the field's value from the 4-byte window at its position (int32 bits)
__device__ __forceinline__ uint32_t sz_value(int kk, uint32_t win) {
  switch (kk) {
    case 0: return win & 0xFFu;
    case 1: return __byte_perm(win, 0u, 0x4401u);  // c * 256 + b1
    case 2: return win & 0xFFFFu;                  // b1 * 256 + c
    case 3: return __byte_perm(win, 0u, 0x0123u);  // big endian
    default: return win;
  }
}

// whether position i (< n) holds a candidate of kind kk: the value is
// above 2 and ends the row within a small slack (int32 arithmetic, which
// the uint32 wrap below reproduces)
__device__ __forceinline__ bool sz_cand(int kk, uint32_t win, int i, int n) {
  const int w = sz_width(kk);
  if (i + w > n) return false;
  const uint32_t v = sz_value(kk, win);
  if ((int32_t)v <= 2) return false;
  const uint32_t dlt = (uint32_t)n - v - (uint32_t)i - (uint32_t)w;
  // u8: slack 0..8; wider kinds: slack 0, 1, 2, 4 or 8
  return dlt <= 8u && (kk == 0 || ((0x117u >> dlt) & 1u));
}

// --- block-wide reductions --------------------------------------------------
// Every thread of the block calls these, with the same arguments where
// they are scalars; each returns its result to every thread.

// eight counts summed over the block: one set of shuffles, one barrier pair
__device__ void block_sum8(int (&v)[8], Shared& sh) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(FULL, v[k], o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) sh.red[threadIdx.x >> 5][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int t = 0;
    for (int w = 0; w < WARPS; ++w) t += sh.red[w][k];
    v[k] = t;
  }
}

__device__ int block_sum(int v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5][0] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < WARPS; ++w) t += sh.red[w][0];
  return t;
}

__device__ unsigned long long block_max64(unsigned long long v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_down_sync(FULL, v, o);
    v = u > v ? u : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.warp64[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long t = 0;
  for (int w = 0; w < WARPS; ++w) t = sh.warp64[w] > t ? sh.warp64[w] : t;
  return t;
}

// Positions of the trues of pred over [0, n) whose rank (0-based, in
// position order) lies in [k0, k0 + count): sh.sel[rank - k0] = position;
// entries without such a true hold `none`. count <= PERM_LINES_W + 1.
// Warp w takes the slice [w * per, (w + 1) * per), 32 consecutive
// positions per ballot; the warp counts are scanned and the warps whose
// ranks meet [k0, k0 + count) walk their slice again.
template <class Pred>
__device__ void select_range(const Pred& pred, int n, int k0, int count,
                             int none, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if ((int)threadIdx.x < count) sh.sel[threadIdx.x] = none;
  const int per = (n + THREADS - 1) / THREADS * 32;
  const int lo = min(w * per, n), hi = min(lo + per, n);
  int c = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    c += __popc(__ballot_sync(FULL, i < hi && pred(i)));
  }
  __syncthreads();  // sel is filled, wcount free
  if (lane == 0) sh.wcount[w] = c;
  __syncthreads();
  int excl = 0;
  for (int j = 0; j < w; ++j) excl += sh.wcount[j];
  if (excl < k0 + count && excl + c > k0) {  // uniform over the warp
    int rank = excl;
    for (int base = lo; base < hi && rank < k0 + count; base += 32) {
      const int i = base + lane;
      const unsigned bal = __ballot_sync(FULL, i < hi && pred(i));
      const int rr = rank + __popc(bal & ((1u << lane) - 1u));
      if (((bal >> lane) & 1u) && rr >= k0 && rr < k0 + count)
        sh.sel[rr - k0] = i;
      rank += __popc(bal);
    }
  }
  __syncthreads();
}

// the k-th true of pred over [0, n), `none` when there is none
template <class Pred>
__device__ int select_kth(const Pred& pred, int n, int k, int none,
                          Shared& sh) {
  select_range(pred, n, k, 1, none, sh);
  const int r = sh.sel[0];
  __syncthreads();
  return r;
}

// --- the number path (num_mutators._mutate_num on raw words) --------------

__device__ long long mutate_num(const uint32_t* sb, long long v,
                                const Tables& tb) {
  typedef unsigned long long u64;
  const long long t = krand(sb[SB_NUM], 12);
  const long long interesting = tb.itbl[krand(sb[SB_NUM + 1], tb.n_itbl)];
  const long long interesting2 = tb.itbl[krand(sb[SB_NUM + 2], tb.n_itbl)];
  const long long half_max = INT64_MAX_ / 2;
  const long long absv = v < 0 ? (long long)(0ULL - (u64)v) : v;
  const long long cap = absv > half_max ? half_max : absv;
  const u64 absv2 = (u64)cap << 1;  // INT64_MIN -> 0
  const u64 u = ((u64)sb[SB_NUM + 3] << 32) | sb[SB_NUM + 4];
  const long long rnd_abs = (long long)(u % (absv2 == 0 ? 1ULL : absv2));
  const long long strat9 = v < 0 ? (long long)((u64)v + (u64)rnd_abs)
                                 : (long long)((u64)v - (u64)rnd_abs);
  const long long n129 = krand(sb[SB_NUM + 5], 128) + 1;
  const long long bits = minll(krand(sb[SB_NUM + 6], n129), 62);
  const u64 hi_p = 1ULL << maxll(bits - 1, 0);
  const u64 u2 = ((u64)sb[SB_NUM + 7] << 32) | sb[SB_NUM + 8];
  const u64 lg = bits <= 0 ? 0ULL : (hi_p | (u2 & (hi_p - 1)));  // 2^k
  const long long s3 = krand(sb[SB_NUM + 9], 3);
  const u64 uv = (u64)v;
  switch (t) {
    case 0: return (long long)(uv + 1);
    case 1: return (long long)(uv - 1);
    case 2: return 0;
    case 3: return 1;
    case 4:
    case 5: return interesting;
    case 7: return (long long)(uv + (u64)interesting2);
    case 8: return (long long)(uv - (u64)interesting2);
    case 9: return strat9;
    case 10: return (long long)(0ULL - uv);
    default: return (long long)(s3 == 0 ? uv - lg : uv + lg);
  }
}

// decimal rendering (num_mutators._render_decimal): digit k of the
// literal, and the literal's length in *total. The magnitude (below
// 2^63) is cut into base-10^9 limbs once, so each digit takes 32-bit math.
__device__ uint32_t render_digit(long long v, int k, long long* total) {
  typedef unsigned long long u64;
  const bool neg = v < 0;
  const long long floored = v < -INT64_MAX_ ? -INT64_MAX_ : v;
  const u64 mag = neg ? (u64)(-floored) : (u64)v;
  const u64 q = mag / 1000000000ULL;
  const uint32_t r0 = (uint32_t)(mag - q * 1000000000ULL);
  const uint32_t r1 = (uint32_t)(q % 1000000000ULL);
  const uint32_t r2 = (uint32_t)(q / 1000000000ULL);  // below 10
  // the index of the highest nonzero digit, plus one (1 for zero)
  auto ndigits = [](uint32_t x) {
    int d = 1;
    for (int e = 1; e < 10; ++e) d = x >= POW10[e] ? e + 1 : d;
    return d;
  };
  const int ndig = r2 ? 19 : (r1 ? 9 + ndigits(r1) : ndigits(r0));
  *total = ndig + (neg ? 1 : 0);
  if (k >= *total) return 0;
  if (k == 0 && neg) return 45;
  const int j = (int)clampll(ndig - 1 - (k - (neg ? 1 : 0)), 0, 19);
  const uint32_t limb = j < 9 ? r0 : (j < 18 ? r1 : (j == 18 ? r2 : 0u));
  return 48 + (limb / POW10[j < 9 ? j : (j < 18 ? j - 9 : 0)]) % 10u;
}

// --- the kernel -------------------------------------------------------------

template <bool SMEM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
case_rounds_kernel(const int64_t* keys, const uint8_t* data,
                   const int32_t* n_in, const int32_t* scores_in,
                   const int32_t* pri, const int32_t* rounds_in,
                   const int32_t* order, Tables tb,
                   uint8_t* out, uint8_t* scratch, int32_t* n_out,
                   int32_t* scores_out, int32_t* log_out, int L) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) uint8_t rows_s[];
  const int tid = threadIdx.x;
  const int b = order[blockIdx.x];  // the rows with most rounds start first
  const size_t row0 = (size_t)b * (size_t)L;
  const uint8_t* in_row = data + row0;
  uint8_t* out_row = out + row0;
  uint8_t* scr_row = SMEM ? nullptr : scratch + row0;
  uint32_t ks0, ks1, kv0, kv1;
  fold_in((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1], TAG_SITE, ks0,
          ks1);
  fold_in((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1], TAG_PERM, kv0,
          kv1);
  if (tid < M) {
    sh.scores[tid] = scores_in[(size_t)b * M + tid];
    sh.pri[tid] = pri[tid];
  }
  if (tid < R_MAX) sh.log[tid] = -1;
  int n = (int)clampll(n_in[b], 0, L);
  const int R = (int)clampll(rounds_in[b], 0, R_MAX);
  const uint8_t* cur = in_row;
  if (SMEM) {
    for (int i0 = tid * 16; i0 < L; i0 += THREADS * 16)
      store16(rows_s + i0, load16(in_row + i0));
    cur = rows_s;
  }
  const uint32_t* sb = sh.sb;
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    uint8_t* dst = SMEM ? rows_s + ((r & 1) ? 0 : L)
                        : (((R - 1 - r) & 1) == 0 ? out_row : scr_row);
    const uint32_t vbase = (uint32_t)(r * VB_ROWS) * (uint32_t)L;
    auto vword = [&](int row, int i) {
      return threefry_word(
          kv0, kv1,
          (uint64_t)(vbase + (uint32_t)row * (uint32_t)L + (uint32_t)i));
    };
    if (tid < SB_ROW)
      sh.sb[tid] = threefry_word(ks0, ks1, (uint64_t)(r * SB_ROW + tid));

    // ---- tables, one pass: line starts, digit-run starts, widenable
    // bytes, the five sizer kinds (the barrier pair publishes sb too)
    const uint32_t* cur32 = reinterpret_cast<const uint32_t*>(cur);
    int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    {
      const int nw = L >> 2, nwn = (n + 3) >> 2;
      for (int k = tid; k < nwn; k += THREADS) {
        const uint32_t wk = cur32[k];
        const uint32_t wn = cur32[k + 1 < nw ? k + 1 : 0];  // wraps mod L
        const uint32_t wp = k > 0 ? cur32[k - 1] : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * k + j;
          if (i < n) {
            const uint32_t c = (wk >> (8 * j)) & 0xFFu;
            const uint32_t pv =
                j == 0 ? wp >> 24 : (wk >> (8 * (j - 1))) & 0xFFu;
            const uint32_t win =
                j == 0 ? wk : __funnelshift_r(wk, wn, 8u * j);
            cnt[0] += (i == 0 || pv == 10u);
            cnt[1] += is_digit(c) && !(i > 0 && is_digit(pv));
            cnt[2] += (c & 0x3Fu) == c;
#pragma unroll
            for (int kk = 0; kk < 5; ++kk)
              cnt[3 + kk] += sz_cand(kk, win, i, n);
          }
        }
      }
    }
    block_sum8(cnt, sh);
    const int nlines = cnt[0], run_count = cnt[1];
    const bool any_wide = cnt[2] > 0;
    int sz_total = 0;
#pragma unroll
    for (int kk = 0; kk < 5; ++kk) sz_total += cnt[3 + kk];
    const bool nonempty = n > 0;
    const bool text = nonempty && !binarish(cur, n, L);

    auto start_at = [&](int i) { return i == 0 || cur[i - 1] == 10; };
    auto digit_start_at = [&](int i) {
      return is_digit(cur[i]) && !(i > 0 && is_digit(cur[i - 1]));
    };

    // ---- weighted pick: the first index among the largest draws
    unsigned predm = 0;
    predm |= (unsigned)nonempty << P_NONEMPTY;
    predm |= (unsigned)(n >= 2) << P_PAIR;
    predm |= (unsigned)(run_count > 0 && nonempty) << P_HAS_DIGIT;
    predm |= (unsigned)text << P_TEXT;
    predm |= (unsigned)(text && nlines >= 2) << P_TEXT_2L;
    predm |= (unsigned)(text && nlines >= 3) << P_TEXT_3L;
    predm |= (unsigned)(any_wide && nonempty) << P_WIDENABLE;
    predm |= (unsigned)(sz_total > 0) << P_SIZERQ;
    predm |= (unsigned)(n >= 4) << P_N4;
    // warp 0: lane m draws for mutator m; a warp reduction keeps the first
    // index among the largest draws of the applicable ones
    if (tid < 32) {
      long long key = -1;
      int idx = tid;
      if (tid < M) {
        const long long bound =
            maxll((long long)sh.scores[tid] * sh.pri[tid], 1);
        const uint32_t dm = sb[tid] % (uint32_t)bound;
        sh.draws[tid] = dm;
        if (((predm >> PRED_OF[tid]) & 1u) && sh.pri[tid] > 0) key = dm;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const long long k2 = __shfl_down_sync(FULL, key, o);
        const int i2 = __shfl_down_sync(FULL, idx, o);
        if (k2 > key || (k2 == key && i2 < idx)) {
          key = k2;
          idx = i2;
        }
      }
      if (tid == 0) sh.pick = key >= 0 ? idx : M;
    }

    // ---- the applied mutator's program
    Prog p = {};
    if (tid < SCRATCH) sh.lit[tid] = 0;
    __syncthreads();  // the pick and the zeroed literal row
    const bool any_app = sh.pick < M;
    const int applied = any_app ? sh.pick : 0;
    const long long d_app = sh.draws[applied];
    auto line_start = [&](long long k) -> long long {
      if (k < 0 || k >= nlines) return 0;
      return select_kth(start_at, n, (int)k, 0, sh);
    };
    auto line_span = [&](long long k, long long& s, long long& len) {
      k = minll(maxll(k, 0), maxll(nlines - 1, 0));
      s = line_start(k);
      const long long e = k == nlines - 1 ? n : line_start(k + 1);
      len = maxll(e - s, 0);
    };
    if (any_app) {
      const long long delta_c = kdelta(sb[SB_DELTA]);
      const long long pos_u = krand(sb[SB_POS], n);
      const long long b_at = cur[clampll(pos_u, 0, L - 1)];
      const long long l_sp = krand(sb[SB_LEN], n - pos_u) + 1;
      switch (applied) {
        case BD:
          p.kind = K_SPLICE; p.pos = pos_u; p.drop = 1; p.delta = delta_c;
          break;
        case BEI: case BED: case BF: case BER: case BI: {
          p.kind = K_SPLICE; p.pos = pos_u; p.drop = 1; p.src = SRC_LIT;
          p.lit_len = applied == BI ? 2 : 1; p.delta = delta_c;
          const long long nb_rand = krand(sb[SB_VAL], 256);
          long long b0 = nb_rand;
          if (applied == BEI) b0 = (b_at + 1) & 255;
          if (applied == BED) b0 = (b_at + 255) & 255;
          if (applied == BF) b0 = b_at ^ (1LL << krand(sb[SB_VAL], 8));
          if (tid == 0) sh.lit[0] = (uint8_t)b0;
          if (tid == 1 && applied == BI) sh.lit[1] = (uint8_t)b_at;
          break;
        }
        case BR:
          p.kind = K_SPLICE; p.pos = pos_u; p.src = SRC_SPAN;
          p.src_start = pos_u; p.src_len = 1; p.reps = 1; p.delta = delta_c;
          break;
        case SP:
          p.kind = K_PERM_BYTES; p.ps = pos_u;
          p.pl = krand(sb[SB_LEN], minll(n - pos_u, minll(PERM_WINDOW, L))) + 1;
          p.delta = delta_c;
          break;
        case SR:
          p.kind = K_SPLICE; p.pos = pos_u; p.drop = l_sp; p.src = SRC_SPAN;
          p.src_start = pos_u; p.src_len = l_sp;
          p.reps = maxll(2, krand_log(sb[SB_VAL], sb[SB_LOG2], 10));
          p.delta = delta_c;
          break;
        case SD:
          p.kind = K_SPLICE; p.pos = pos_u; p.drop = l_sp; p.delta = delta_c;
          break;
        case SNAND: case SRND:
          p.kind = K_MASK; p.ps = pos_u; p.pl = l_sp;
          p.mask_op = applied == SNAND ? krand(sb[SB_MASKOP], 3) : 3;
          p.mask_prob = kerand(sb[SB_PROB], 100); p.delta = delta_c;
          break;
        case UW: {
          // first position of the largest key; a key is the byte's vector
          // word where the byte is widenable, else 0 (position 0 holds at
          // least key 0, so a row with no widenable byte widens at 0)
          unsigned long long best_key = 0xFFFFFFFFull;
          for (int i = tid; i < n; i += THREADS) {
            const uint32_t c = cur[i];
            if ((c & 0x3Fu) == c) {
              const unsigned long long packed =
                  ((unsigned long long)vword(VB_WIDE, i) << 32) |
                  (0xFFFFFFFFu - (uint32_t)i);
              best_key = packed > best_key ? packed : best_key;
            }
          }
          const long long pos_uw =
              0xFFFFFFFFu - (uint32_t)(block_max64(best_key, sh) & 0xFFFFFFFFu);
          p.kind = K_SPLICE; p.pos = pos_uw; p.drop = 1; p.src = SRC_LIT;
          p.lit_len = 2; p.delta = delta_c;
          if (tid == 0) sh.lit[0] = 0xC0;
          if (tid == 1) sh.lit[1] = cur[clampll(pos_uw, 0, L - 1)] | 0x80;
          break;
        }
        case UI: {
          const long long row = krand(sb[SB_VAL], tb.n_funny);
          p.kind = K_SPLICE; p.pos = pos_u + 1; p.src = SRC_LIT;
          p.lit_len = tb.funny_l[row]; p.delta = delta_c;
          if (tid < tb.funny_w && tid < 4)
            sh.lit[tid] = tb.funny_t[row * tb.funny_w + tid];
          break;
        }
        case NUM: {
          const long long target = run_count - 1 - krand(sb[SB_POS], run_count);
          const int a = select_kth(digit_start_at, n, (int)target, 0, sh);
          // first non-digit at or after a (n when the digits run to L)
          int b_loc = L;
          for (int i = a + tid; i < L; i += THREADS) {
            if (!(i < n && is_digit(cur[i]))) {
              b_loc = i;
              break;
            }
          }
          const int b_first = (int)(0xFFFFFFFFu - (uint32_t)(
              block_max64(0xFFFFFFFFu - (uint32_t)b_loc, sh) & 0xFFFFFFFFu));
          const int b_end = b_first >= L ? n : b_first;
          int dashes = 0;
          while (a - 1 - dashes >= 0 && cur[a - 1 - dashes] == 45) ++dashes;
          unsigned long long mag = 0;
          // a + k < b_end <= L: no wrap
          for (int k = 0; k < MAX_PARSE_DIGITS; ++k)
            if (a + k < b_end)
              mag = mag * 10ULL +
                    (unsigned long long)(long long)((int)cur[a + k] - 48);
          const long long value =
              dashes > 0 ? (long long)(0ULL - mag) : (long long)mag;
          const long long nv = mutate_num(sb, value, tb);
          long long total = 0;
          const uint32_t dig = render_digit(nv, tid < RENDER ? tid : RENDER,
                                            &total);
          if (tid < RENDER) sh.lit[tid] = (uint8_t)dig;
          p.kind = K_SPLICE; p.pos = a - dashes; p.drop = b_end - (a - dashes);
          p.src = SRC_LIT; p.lit_len = total; p.delta = 2;
          break;
        }
        case LD: case LR2: case LR: {
          long long s, len;
          line_span(kerand(sb[SB_POS], nlines) - 1, s, len);
          p.kind = K_SPLICE; p.pos = s; p.delta = 1;
          if (applied == LD) {
            p.drop = len;
          } else {
            p.src = SRC_SPAN; p.src_start = s; p.src_len = len; p.reps = 1;
            if (applied == LR) {
              p.drop = len;
              p.reps = maxll(2, krand_log(sb[SB_VAL], sb[SB_LOG2], 10));
            }
          }
          break;
        }
        case LDS: {
          const long long start = kerand(sb[SB_POS], nlines);
          const long long cnt_l = kerand(sb[SB_LEN], nlines - start + 1);
          long long s0, l0, s2, l2;
          line_span(start - 1, s0, l0);
          line_span(start - 1 + cnt_l - 1, s2, l2);
          p.kind = K_SPLICE; p.pos = s0; p.drop = s2 + l2 - s0; p.delta = 1;
          break;
        }
        case LRI: {
          long long fs, fl, ts, tl;
          line_span(kerand(sb[SB_POS], nlines) - 1, fs, fl);
          line_span(kerand(sb[SB_VAL], nlines) - 1, ts, tl);
          p.kind = K_SPLICE; p.pos = ts; p.drop = tl; p.src = SRC_SPAN;
          p.src_start = fs; p.src_len = fl; p.reps = 1; p.delta = 1;
          break;
        }
        case LS: {
          const long long k = kerand(sb[SB_POS], maxll(nlines - 1, 0)) - 1;
          long long s1, l1, s2, l2;
          line_span(k, s1, l1);
          line_span(k + 1, s2, l2);
          p.kind = K_SWAP; p.a1 = s1; p.l1 = l1; p.l2 = l2; p.delta = 1;
          break;
        }
        case LP: {
          const long long frm = kerand(sb[SB_POS], maxll(nlines - 1, 0)) - 1;
          const long long a =
              krand_range(sb[SB_LEN], 2, maxll(nlines - frm - 1, 2));
          const long long bb = krand_log(sb[SB_VAL], sb[SB_LOG2], 10);
          p.kind = K_PERM_LINES; p.ps = frm;
          p.pl = clampll(maxll(2, minll(a, bb)), 0, PERM_LINES_W);
          p.delta = 1;
          break;
        }
        case LIS: case LRS: {
          long long ds, dl, ts, tl;
          line_span(kerand(sb[SB_AUX], nlines) - 1, ds, dl);
          line_span(kerand(sb[SB_POS], nlines) - 1, ts, tl);
          p.kind = K_SPLICE; p.pos = ts; p.drop = applied == LRS ? tl : 0;
          p.src = SRC_SPAN; p.src_start = ds; p.src_len = dl; p.reps = 1;
          p.delta = 1;
          break;
        }
        case AB: case AD: {
          const int* lay = tb.layout;
          long long row, reps = 1;
          if (applied == AB) {
            const long long v = krand(sb[SB_PAYV], 5);
            if (v <= 1) {
              row = lay[PL_SILLY0] + krand(sb[SB_PAYROW], lay[PL_N_SILLY]);
              reps = krand(sb[SB_PAYREP], 20) + 1;
            } else if (v == 2) {
              row = lay[PL_AAA_ROW];
              const long long t_aaa = krand(sb[SB_PAYREP], 11);
              reps = t_aaa < 10 ? AAA_COUNTS[t_aaa]
                                : krand(sb[SB_PAYAUX], 1024);
            } else if (v == 3) {
              row = lay[PL_TRAV0] + krand(sb[SB_PAYROW], 2);
              reps = kerand(sb[SB_PAYAUX], 10);
            } else {
              row = lay[PL_NULL_ROW];
            }
            const long long ll = tb.pay_l[row];
            p.pos = v == 4 ? n : pos_u;
            p.drop = v == 1 ? ll * reps : 0;
          } else {
            const long long v = krand(sb[SB_PAYV], 4);
            row = v < 3 ? lay[PL_DELIM0] + krand(sb[SB_PAYROW], lay[PL_N_DELIM])
                        : lay[PL_SHELL0] + krand(sb[SB_PAYAUX], lay[PL_N_SHELL]);
            p.pos = pos_u;
          }
          p.kind = K_SPLICE; p.src = SRC_LIT; p.lit_len = tb.pay_l[row];
          p.reps = reps; p.delta = delta_c;
          if (tid < SCRATCH && tid < tb.pay_w)
            sh.lit[tid] = tb.pay_t[row * tb.pay_w + tid];
          break;
        }
        case LEN: {
          // one uniform draw over every candidate, kind-major
          const long long r_sz = krand(sb[SB_LENPICK], sz_total);
          long long a = 0, w = 1, kind = 0, val = 0, running = 0;
#pragma unroll
          for (int kk = 0; kk < 5; ++kk) {
            if (r_sz >= running && r_sz < running + cnt[3 + kk]) {
              auto cand = [&](int i) {
                return sz_cand(kk, window4(cur, L, i), i, n);
              };
              a = select_kth(cand, n, (int)(r_sz - running), 0, sh);
              w = sz_width(kk);
              kind = kk;
              val = (int32_t)sz_value(kk, window4(cur, L, (int)a));
            }
            running += cnt[3 + kk];
          }
          const bool found = sz_total > 0;
          const long long len_end = minll(wrap32(val + a + w), n);
          const long long t = krand(sb[SB_LENT], 7);
          const long long new_len = minll(
              ((long long)(sb[SB_LENV] >> 2) * 2) & 0x7FFFFFFF,
              ABSMAX_BINARY_BLOCK);
          const bool expand = t == 2;
          p.kind = found ? K_SPLICE : K_NONE;
          p.pos = expand ? len_end : a;
          p.drop = expand ? 0 : (t == 3 ? len_end - a : w);
          p.src = SRC_LIT;
          p.lit_len = expand ? 8 : w;
          p.reps = expand ? 1 + krand_log(sb[SB_LENR], sb[SB_LOG2], 8) : 1;
          p.delta = found ? 1 : -1;
          if (tid < 8) {
            const long long k = tid;
            const uint32_t fill_w = sb[k < 4 ? SB_LENF0 : SB_LENF1];
            const long long fill = (fill_w >> ((k % 4) * 8)) & 0xFF;
            long long field = 0;
            if (k < 4) {
              const bool le = kind == 2 || kind == 4;
              const long long shift = le ? k * 8 : (w - 1 - k) * 8;
              field = t == 0 ? 0
                      : (t == 1 ? 0xFF
                                : (new_len >> clampll(shift, 0, 31)) & 0xFF);
            }
            sh.lit[k] = (uint8_t)(expand ? fill : field);
          }
          break;
        }
        case FT: case FN: case FO: {
          const long long p_f = krand(sb[SB_FUSEP], n);
          const long long k_f =
              minll(1 + krand_log(sb[SB_FUSEDEP], sb[SB_LOG2], 3), 4);
          // the probe reads bytes p_f + dd clamped to the row; a match
          // compares the first k_f bytes of the window at i (mod L)
          uint32_t probe = 0;
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
            probe |= (uint32_t)cur[clampll(p_f + dd, 0, L - 1)] << (8 * dd);
          const uint32_t kmask =
              k_f >= 4 ? 0xFFFFFFFFu : (1u << (8 * k_f)) - 1u;
          auto match = [&](int i) {
            return i != p_f && ((window4(cur, L, i) ^ probe) & kmask) == 0;
          };
          int c = 0;
          for (int i = tid; i < n; i += THREADS) c += match(i);
          const long long tot = block_sum(c, sh);
          const long long r_f = krand(sb[SB_FUSEPICK], tot);
          long long q;
          if (tot > 0) {
            q = select_kth(match, n, (int)r_f, 0, sh);
          } else {
            q = krand(sb[SB_FUSEFB], maxll(n - 1, 1));
            q += q >= p_f ? 1 : 0;
          }
          p.kind = K_SPLICE; p.pos = p_f; p.src = SRC_SPAN; p.src_start = q;
          p.reps = 1; p.delta = delta_c;
          const long long l_fuse = 1 + krand(sb[SB_FUSELEN], maxll(n - q, 1));
          if (applied == FT) {
            p.drop = n - p_f;
            p.src_len = maxll(n - q, 1);
          } else {
            p.src_len = l_fuse;
            p.drop = applied == FO ? kerand(sb[SB_AUX], maxll(n - p_f, 1)) : 0;
          }
          break;
        }
        default:  // nil: the empty program
          break;
      }
    }
    __syncthreads();  // literal row written

    // ---- apply into dst, 16 bytes per thread and store
    Apply ap = make_apply(p.kind, p.pos, p.drop, p.src, p.src_start,
                          p.src_len, p.reps, p.lit_len, p.a1, p.l1, p.l2,
                          p.ps, p.pl, p.mask_op, p.mask_prob, n, L, SCRATCH);
    ap.k0 = kv0;
    ap.k1 = kv1;
    ap.wbase = vbase;
    if (p.kind == K_PERM_BYTES)
      perm_window<THREADS>(ap, cur, p.ps, p.pl, sh.win, sh.vrow);
    if (p.kind == K_PERM_LINES) {
      const int f = (int)clampll(p.ps, 0, maxll(nlines - 1, 0));
      const int cnt_w =
          (int)clampll(p.pl, 0, clampll(nlines - f, 0, PERM_LINES_W));
      // starts of window lines f .. f+64 (0 where there is no such line)
      select_range(start_at, n, f, PERM_LINES_W + 1, 0, sh);
      if (tid < PERM_LINES_W) {
        const int w = tid;
        int len = 0;
        if (w < cnt_w && f + w < nlines) {
          len = (f + w == nlines - 1 ? n : sh.sel[w + 1]) - sh.sel[w];
          len = len > 0 ? len : 0;
        }
        sh.lens_w[w] = len;
        sh.keys[w] = w < L ? vword(VB_LPERM, w) : 0u;
      }
      __syncthreads();
      if (tid < PERM_LINES_W) {
        // window line j of the output is the j-th largest key among the
        // first cnt_w lines (first index among equal keys): line w's rank
        // counts the keys before it; the lines past cnt_w keep their place
        const int w = tid;
        int rank = w;
        if (w < cnt_w) {
          rank = 0;
          const uint32_t kw = sh.keys[w];
          for (int v = 0; v < cnt_w; ++v)
            rank += sh.keys[v] > kw || (sh.keys[v] == kw && v < w);
        }
        sh.order[rank] = w;
      }
      __syncthreads();
      if (tid < PERM_LINES_W) {
        sh.plen[tid] = sh.lens_w[sh.order[tid]];
        sh.pstart[tid] = sh.sel[sh.order[tid]];
      }
      __syncthreads();
      if (tid == 0) {
        int acc = 0;
        for (int j = 0; j < PERM_LINES_W; ++j) {
          acc += sh.plen[j];
          sh.cum[j] = acc;
        }
      }
      __syncthreads();
      const int ws = sh.sel[0];
      const int we = ws + (cnt_w > 0 ? sh.cum[cnt_w - 1] : 0);
      for (int i0 = tid * 16; i0 < L; i0 += THREADS * 16) {
        if (i0 + 16 <= ws || i0 >= we) {
          store16(dst + i0, load16(cur + i0));
          continue;
        }
        uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = i0 + j;
          uint32_t v = cur[i];
          if (i >= ws && i < we) {
            const int rel = i - ws;
            int lo = 0, hi = PERM_LINES_W;  // first j with cum[j] > rel
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (sh.cum[mid] > rel) hi = mid; else lo = mid + 1;
            }
            const int jj = lo < PERM_LINES_W ? lo : PERM_LINES_W - 1;
            const int prev = sh.cum[jj] - sh.plen[jj];
            // a byte of line pstart[jj], inside [0, n): below 2L
            v = cur[wrap_hi(rel - prev + sh.pstart[jj], L)];
          }
          put_byte(o, j, v);
        }
        store16(dst + i0, make_uint4(o[0], o[1], o[2], o[3]));
      }
    } else {
      for (int i0 = tid * 16; i0 < L; i0 += THREADS * 16)
        store16(dst + i0, apply_chunk(ap, cur, i0, sh.lit, sh.win));
    }
    __syncthreads();  // dst complete

    // ---- score update (scheduler.adjust_scores)
    const int n1 = ap.n_out;
    const long long delta_f =
        applied == NUM ? (binarish(dst, n1, L) ? -1 : 2) : p.delta;
    if (tid < M) {
      const long long dm = sh.draws[tid];
      const bool tried =
          any_app && (dm > d_app || (dm == d_app && tid < applied));
      const long long delta =
          (tried ? -1 : 0) + ((tid == applied && any_app) ? delta_f : 0);
      sh.scores[tid] =
          (int)clampll(sh.scores[tid] + delta, MIN_SCORE, MAX_SCORE);
    }
    if (tid == 0) sh.log[r] = any_app ? applied : -1;
    n = n1;
    cur = dst;
    __syncthreads();  // scores, scalar words and rows free for the next round
  }

  if (SMEM || R == 0)
    for (int i0 = tid * 16; i0 < L; i0 += THREADS * 16)
      store16(out_row + i0, load16(cur + i0));
  if (tid < M) scores_out[(size_t)b * M + tid] = sh.scores[tid];
  if (tid < R_MAX) log_out[(size_t)b * R_MAX + tid] = sh.log[tid];
  if (tid == 0) n_out[b] = (int32_t)n;
}

// the shared-memory path's attribute, set once per process for the widest
// row it takes
cudaError_t configure() {
  static const cudaError_t set = cudaFuncSetAttribute(
      case_rounds_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * SMEM_MAX_L);
  return set;
}

}  // namespace

extern "C" int case_rounds_smem_max_l() { return SMEM_MAX_L; }

// resident CTAs per SM for rows of L bytes (negative: a CUDA error)
extern "C" int case_rounds_ctas_per_sm(int L) {
  int n = 0;
  cudaError_t e = configure();
  if (e == cudaSuccess)
    e = L <= SMEM_MAX_L
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, case_rounds_kernel<true>, THREADS, 2 * L)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, case_rounds_kernel<false>, THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// order: the rows in the order their CTAs are launched (a permutation);
// scratch: a second B x L buffer, read only when L > SMEM_MAX_L
extern "C" int case_rounds_launch(
    const void* keys, const void* data, const void* n, const void* scores,
    const void* pri, const void* rounds, const void* order,
    const void* funny_t,
    const void* funny_l, int n_funny, const void* itbl, int n_itbl,
    const void* pay_t, const void* pay_l, int n_pay, int pay_w,
    const void* layout, void* out, void* scratch, void* n_out,
    void* scores_out, void* log, int B, int L, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaGetLastError();
  if (L % 16 != 0 || (L > SMEM_MAX_L && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Tables tb;
  tb.funny_t = (const uint8_t*)funny_t;
  tb.funny_l = (const int32_t*)funny_l;
  tb.n_funny = n_funny;
  tb.funny_w = 4;
  tb.itbl = (const int64_t*)itbl;
  tb.n_itbl = n_itbl;
  tb.pay_t = (const uint8_t*)pay_t;
  tb.pay_l = (const int32_t*)pay_l;
  tb.n_pay = n_pay;
  tb.pay_w = pay_w;
  tb.layout = (const int32_t*)layout;
  const int64_t* k = (const int64_t*)keys;
  const uint8_t* d = (const uint8_t*)data;
  const int32_t* ni = (const int32_t*)n;
  const int32_t* si = (const int32_t*)scores;
  const int32_t* pr = (const int32_t*)pri;
  const int32_t* ri = (const int32_t*)rounds;
  const int32_t* od = (const int32_t*)order;
  uint8_t* o = (uint8_t*)out;
  uint8_t* sc = (uint8_t*)scratch;
  int32_t* no = (int32_t*)n_out;
  int32_t* so = (int32_t*)scores_out;
  int32_t* lo = (int32_t*)log;
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= SMEM_MAX_L) {
    const int dyn = 2 * L;
    const cudaError_t e = configure();
    if (e != cudaSuccess) return (int)e;
    case_rounds_kernel<true><<<B, THREADS, dyn, s>>>(
        k, d, ni, si, pr, ri, od, tb, o, sc, no, so, lo, L);
  } else {
    case_rounds_kernel<false><<<B, THREADS, 0, s>>>(
        k, d, ni, si, pr, ri, od, tb, o, sc, no, so, lo, L);
  }
  return (int)cudaGetLastError();
}
