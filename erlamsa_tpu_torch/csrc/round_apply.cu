// Round apply: one scheduler round's data movement for every sample of a
// batch, selected per sample by `kind` (SPLICE, SWAP, MASK, PERM_BYTES;
// any other kind copies the row).
//
// Replaces: erlamsa_tpu/ops/pallas_kernels.py::fused_round_single, the
// Pallas whole-round kernel (_round_logic) in its portable build, whose
// random bits are jax.random.bits(key, (1, 4, L), uint32). Word w of that
// array is x1 ^ x2 of threefry2x32(key, (hi32(w), lo32(w))) (jax's
// partitionable threefry), so this kernel computes each word it needs in
// registers: row 0-2 words only at MASK bytes inside the span, row 3 words
// only over the Fisher-Yates window. It never reads a bits operand.
//
// Bound on an H100: bytes. A row of L bytes is read and a row of L bytes
// written, plus 64 B of params, 48 B of literal and 16 B of key; the few
// threefry words a MASK or PERM_BYTES round needs are cheap next to that.
//
// Design (row_apply.cuh holds the apply, shared with the case kernel):
// one CTA per sample. Every thread assembles 16 consecutive output bytes
// and stores them with one 16-byte store; index math is 32-bit, the
// program's geometry reduced once per row, so a splice or swap source
// wraps by a conditional subtract and a repeat position advances by one
// with a wrap (one modulo per 16 bytes, none per byte). A row whose kind
// copies, masks or permutes a window reads its 16-byte chunks straight
// from device memory (MASK and PERM_BYTES change bytes in place; the
// <= 256-byte Fisher-Yates window and its draws live in shared memory,
// where one thread runs the serial swap sequence). A SPLICE or SWAP row
// reads its bytes out of order, so it is first staged in shared memory
// with 16-byte loads when L <= SMEM_MAX_L (the 65536 class and below);
// wider rows (262144, 1,000,000) read their sources from device memory
// through the same code. The choice depends on L alone. L must be a
// multiple of 16, as every capacity class is.
//
// Arithmetic: the params are int32 in the engine; the geometry is taken
// in 64 bits once per row and is exact for any int32 params. Domain:
// 0 <= n <= L (n is clamped there, as the engine guarantees it).

#include <cstdint>
#include <cuda_runtime.h>

#include "row_apply.cuh"

namespace {

using namespace erl;

constexpr int THREADS = 256;
constexpr int SMEM_MAX_L = 65536;

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
round_apply_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ params,
                   const uint8_t* __restrict__ lit,
                   const int64_t* __restrict__ keys,
                   uint8_t* __restrict__ out, int L) {
  extern __shared__ __align__(16) uint8_t row_s[];
  __shared__ uint8_t win[PERM_WINDOW];
  __shared__ uint32_t vrow[PERM_WINDOW];
  __shared__ uint8_t lit_s[SCRATCH];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t off = (size_t)b * (size_t)L;
  const uint8_t* d = data + off;
  uint8_t* o = out + off;
  const int32_t* P = params + (size_t)b * 16;
  Apply a = make_apply(P[0], P[1], P[2], P[3], P[4], P[5], P[6], P[7], P[8],
                       P[9], P[10], P[11], P[12], P[13], P[14],
                       clampll(P[15], 0, L), L, L < SCRATCH ? L : SCRATCH);
  a.k0 = (uint32_t)keys[2 * b];
  a.k1 = (uint32_t)keys[2 * b + 1];
  const uint8_t* cur = d;
  if (a.kind == K_PERM_BYTES) {  // uniform over the block
    perm_window<THREADS>(a, d, P[11], P[12], win, vrow);
  } else if (a.kind == K_SPLICE || a.kind == K_SWAP) {
    if (tid < SCRATCH) lit_s[tid] = lit[(size_t)b * SCRATCH + tid];
    if (SMEM) {
      for (int i0 = tid * 16; i0 < L; i0 += THREADS * 16)
        store16(row_s + i0, load16(d + i0));
      cur = row_s;
    }
    __syncthreads();
  }
  for (int i0 = tid * 16; i0 < L; i0 += THREADS * 16)
    store16(o + i0, apply_chunk(a, cur, i0, lit_s, win));
}

// the shared-memory path's attribute, set once per process for the widest
// row it takes
cudaError_t configure() {
  static const cudaError_t set = cudaFuncSetAttribute(
      round_apply_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX_L);
  return set;
}

}  // namespace

extern "C" int round_apply_smem_max_l() { return SMEM_MAX_L; }

// resident CTAs per SM for rows of L bytes (negative: a CUDA error)
extern "C" int round_apply_ctas_per_sm(int L) {
  int n = 0;
  cudaError_t e = configure();
  if (e == cudaSuccess)
    e = L <= SMEM_MAX_L
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, round_apply_kernel<true>, THREADS, L)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, round_apply_kernel<false>, THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int round_apply_launch(const void* data, const void* params,
                                  const void* lit, const void* keys,
                                  void* out, int B, int L, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaGetLastError();
  if (L % 16 != 0) return (int)cudaErrorInvalidValue;
  const uint8_t* d = (const uint8_t*)data;
  const int32_t* p = (const int32_t*)params;
  const uint8_t* l = (const uint8_t*)lit;
  const int64_t* k = (const int64_t*)keys;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= SMEM_MAX_L) {
    const cudaError_t e = configure();
    if (e != cudaSuccess) return (int)e;
    round_apply_kernel<true><<<B, THREADS, L, s>>>(d, p, l, k, o, L);
  } else {
    round_apply_kernel<false><<<B, THREADS, 0, s>>>(d, p, l, k, o, L);
  }
  return (int)cudaGetLastError();
}
