// threefry2x32 as jax.random computes it, for the port's CUDA kernels.
//
// Under jax's partitionable threefry (the JAX package runs jax 0.9 with
// jax_threefry_partitionable on), word w of jax.random.bits(key, shape,
// uint32) is x0 ^ x1 of threefry2x32(key, (hi32(w), lo32(w))) with w the
// flat row-major index, and fold_in(key, d) is the pair threefry2x32(key,
// (0, d)). A kernel therefore computes any word it needs in registers and
// never reads a bits operand.

#pragma once

#include <cstdint>

namespace erl {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// threefry2x32 (20 rounds) of the count pair (c0, c1) under key (k0, k1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// jax.random.bits word at flat index `idx` for key (k0, k1)
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint64_t idx) {
  uint32_t y0, y1;
  threefry2x32(k0, k1, (uint32_t)(idx >> 32), (uint32_t)idx, y0, y1);
  return y0 ^ y1;
}

// The same threefry2x32 under one fixed key, the key schedule and the ten
// injection constants taken once, so that a kernel drawing many words
// under one key keeps them in registers (the mask kernel). The round and
// case kernels keep the functions above.
struct Threefry {
  uint32_t ks0, ks1, inj0[5], inj1[5];

  __device__ __forceinline__ Threefry(uint32_t k0, uint32_t k1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    ks0 = k0;
    ks1 = k1;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      inj0[i] = ks[(i + 1) % 3];
      inj1[i] = ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
  }

  // jax.random.bits word at flat index (hi, lo): y0 ^ y1 of the pair
  __device__ __forceinline__ uint32_t word(uint32_t hi, uint32_t lo) const {
    uint32_t x0 = hi + ks0;
    uint32_t x1 = lo + ks1;
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x0 += x1;
        x1 = rotl32(x1, rot[i & 1][j]);
        x1 ^= x0;
      }
      x0 += inj0[i];
      x1 += inj1[i];
    }
    return x0 ^ x1;
  }
};

// jax.random.fold_in(key, d)
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t d,
                                        uint32_t& f0, uint32_t& f1) {
  threefry2x32(k0, k1, 0u, d, f0, f1);
}

}  // namespace erl
