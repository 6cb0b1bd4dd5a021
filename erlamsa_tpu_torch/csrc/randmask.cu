// Random mask: per row, a per-byte NAND / OR / XOR / replace over the span
// [s, s+l) with probability prob, when the row's `active` flag is set.
//
// Replaces: erlamsa_tpu/ops/pallas_kernels.py::pallas_randmask (:97) and
// randmask_single (:363), the same body _mask_logic, in their portable
// build, whose random bits are jax.random.bits(key, (3, L), uint32) of each
// row's key: row 0 draws the occurrence (mod 100; prob 1 fires on a
// nonzero draw), row 1 the bit to flip (mod 8, ops 0-2), row 2 the
// replacement byte (any other op). Word w is x0 ^ x1 of threefry2x32(key,
// (hi32(w), lo32(w))), so this kernel computes each word where it is read:
// row 0 inside the span, row 1 or 2 only where the mask fires. The span end
// s + l wraps in int32, as the reference computes it.
//
// Bound on an H100: operations, for spans that cover much of the row (one
// threefry word per span byte and one more per fired byte), else bytes (a
// row read and written). A threefry word is counted per pipe, in the SASS
// of this kernel's threefry code (chip_smoke.py): integer-ALU instructions
// (rotates, xors, 3-input adds) at 64 per clock per SM, IMADs on the FMA
// pipe at 64, and every instruction at the issue rate of 128; the busiest
// of the three sets the time of a word.
//
// Design: the grid covers tiles of 2048 bytes of a row, not whole rows, so
// the span work is split evenly however span lengths vary between rows. A
// warp owns 512 bytes of a tile and never waits on another warp; bytes
// outside the span, of an inactive row or with prob < 1 are copied 16 a
// lane. For its span bytes the warp stages the 512 bytes in shared memory
// and computes the occurrence words 32 consecutive bytes a step, each lane
// keeping a bit mask of its bytes that fire. A warp scan of the masks'
// popcounts gives each lane its slots in the warp's queue of fired bytes;
// the warp then draws their bit or replacement words 32 at a time, every
// lane busy (a draw under `if (occurs)` would run a second chain per warp
// wherever one lane fires), and writes them into the staged bytes. With
// prob >= 100 every span byte fires and the occurrence words are skipped.
// Index math is 32-bit and the key schedule is hoisted (erl::Threefry); the
// high counter word is 0 unless 3L >= 2^32 (the WIDE build). Rows whose
// width is a multiple of 16, with both rows 16-byte aligned, move 16 bytes
// a lane (VEC); any other width or alignment moves bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 512;  // bytes of a row per warp: 16 a lane
constexpr int TILE = WARPS * SEG;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(uint8_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// n <= SEG bytes from src to dst, one warp: 16 bytes a lane (VEC: n a
// multiple of 16, both pointers 16-byte aligned) or one byte a lane-step
template <bool VEC>
__device__ __forceinline__ void copy_seg(uint8_t* dst, const uint8_t* src,
                                         int n, int lane) {
  if (VEC) {
    if (lane * 16 < n) store16(dst + lane * 16, load16(src + lane * 16));
  } else {
    for (int j = lane; j < n; j += 32) dst[j] = src[j];
  }
}

template <bool VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS)
randmask_kernel(const int64_t* __restrict__ keys,
                const int32_t* __restrict__ params,
                const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                int L, unsigned tiles) {
  __shared__ __align__(16) uint8_t stage[WARPS][SEG];
  __shared__ uint16_t queue[WARPS][SEG];
  const unsigned b = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned useg0 = (blockIdx.x - b * tiles) * TILE + warp * SEG;
  if (useg0 >= (unsigned)L) return;
  // the warp's bytes [seg0, seg0 + n) of row b; j below is i - seg0
  const int seg0 = (int)useg0;
  const int n = L - seg0 < SEG ? L - seg0 : SEG;
  const size_t off = (size_t)b * (size_t)L + (size_t)seg0;
  const uint8_t* d = data + off;
  uint8_t* o = out + off;
  const int32_t* P = params + (size_t)b * 5;
  const int s = P[0], op = P[2], prob = P[3];
  // the reference's int32 span end; the warp's span bytes are i in
  // [max(s, seg0), min(end, seg1)), compared in 32 bits
  const int end = (int)((uint32_t)s + (uint32_t)P[1]);
  const int seg1 = seg0 + n;
  if (P[4] == 0 || prob < 1 || s >= end || s >= seg1 || end <= seg0) {
    copy_seg<VEC>(o, d, n, lane);  // uniform over the warp
    return;
  }
  const int jlo = (s > seg0 ? s : seg0) - seg0;
  const int jhi = (end < seg1 ? end : seg1) - seg0;
  uint8_t* row = stage[warp];
  copy_seg<VEC>(row, d, n, lane);
  const erl::Threefry tf((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1]);
  const bool bitop = op >= 0 && op <= 2;
  // byte j's bit word (row 1) or replacement word (row 2), applied
  auto fire = [&](int j) {
    const uint32_t i = (uint32_t)(seg0 + j);
    if (bitop) {  // L + i < 2^32
      const uint32_t one = 1u << (tf.word(0u, (uint32_t)L + i) % 8u);
      const uint32_t v = row[j];
      row[j] = (uint8_t)(op == 0 ? (v & ~one) : op == 1 ? (v | one)
                                                        : (v ^ one));
    } else if (WIDE) {
      const uint64_t c = 2ull * (uint64_t)L + i;
      row[j] = (uint8_t)tf.word((uint32_t)(c >> 32), (uint32_t)c);
    } else {
      row[j] = (uint8_t)tf.word(0u, 2u * (uint32_t)L + i);
    }
  };
  __syncwarp();
  if (prob >= 100) {  // occ < prob for every draw: the whole span fires
    for (int j = jlo + lane; j < jhi; j += 32) fire(j);
  } else {
    // occurrence words, 32 consecutive span bytes a step: bit t of fm is
    // set where the lane's byte j = 32 t + lane fires (steps wholly
    // outside [jlo, jhi) are skipped, the bounds being uniform)
    unsigned fm = 0;
    const int t1 = (jhi + 31) >> 5;
#pragma unroll 4
    for (int t = jlo >> 5; t < t1; ++t) {
      const int j = t * 32 + lane;
      if (j >= jlo && j < jhi) {
        const uint32_t occ = tf.word(0u, (uint32_t)(seg0 + j)) % 100u;
        if (prob == 1 ? occ != 0 : (int)occ < prob) fm |= 1u << t;
      }
    }
    // the fired bytes into the warp's queue: the lane's first slot is the
    // count of the lower lanes' (a warp scan of the popcounts)
    const int own = __popc(fm);
    int upto = own;
#pragma unroll
    for (int step = 1; step < 32; step <<= 1) {
      const int lower = __shfl_up_sync(FULL, upto, step);
      if (lane >= step) upto += lower;
    }
    const int nq = __shfl_sync(FULL, upto, 31);
    uint16_t* q = queue[warp];
    for (int at = upto - own; fm; fm &= fm - 1)
      q[at++] = (uint16_t)((__ffs(fm) - 1) * 32 + lane);
    __syncwarp();
    // their second words, 32 at a time, every lane busy
    for (int k = lane; k < nq; k += 32) fire(q[k]);
  }
  __syncwarp();
  copy_seg<VEC>(o, row, n, lane);
}

template <bool VEC, bool WIDE>
void launch(const int64_t* k, const int32_t* p, const uint8_t* d, uint8_t* o,
            int L, unsigned tiles, unsigned blocks, cudaStream_t s) {
  randmask_kernel<VEC, WIDE><<<blocks, THREADS, 0, s>>>(k, p, d, o, L, tiles);
}

}  // namespace

// resident CTAs per SM (negative: a CUDA error)
extern "C" int randmask_ctas_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, randmask_kernel<true, false>, THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int randmask_launch(const void* keys, const void* params,
                               const void* data, void* out, int B, int L,
                               void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaGetLastError();
  const unsigned tiles = ((unsigned)L + TILE - 1) / TILE;
  const unsigned long long blocks = (unsigned long long)B * tiles;
  if (blocks > 0x7FFFFFFFull) return (int)cudaErrorInvalidValue;
  const bool vec = L % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const bool wide = 3ull * (unsigned long long)L >= (1ull << 32);
  const int64_t* k = (const int64_t*)keys;
  const int32_t* p = (const int32_t*)params;
  const uint8_t* d = (const uint8_t*)data;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned n = (unsigned)blocks;
  if (vec && !wide) launch<true, false>(k, p, d, o, L, tiles, n, s);
  else if (vec) launch<true, true>(k, p, d, o, L, tiles, n, s);
  else if (!wide) launch<false, false>(k, p, d, o, L, tiles, n, s);
  else launch<false, true>(k, p, d, o, L, tiles, n, s);
  return (int)cudaGetLastError();
}
