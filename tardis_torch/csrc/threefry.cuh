// threefry2x32 counter-based random numbers, bit-exact with jax.random
// (jax_threefry_partitionable=True) and with tardis_torch/transport/rng.py.
//
//   fold_in(k, d)   = threefry2x32(k, (0, d))
//   bits(k, i)      = y0 ^ y1 of threefry2x32(k, (0, i))
//   uniform(bits)   = max(lo, (f - 1) * (hi - lo) + lo),
//                     f = bitcast_f32((bits >> 9) | 0x3F800000)
#pragma once
#include <cstdint>

namespace tardis {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(Key k, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k, x0, x1);
  return Key{x0, x1};
}

__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t counter) {
  uint32_t x0 = 0u, x1 = counter;
  threefry2x32(k, x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform's float conversion; the scaling is written with
// explicitly rounded operations so that no contraction can change it.
__device__ __forceinline__ float uniform_f32(uint32_t bits, float lo, float hi) {
  float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  float v = __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo);
  return fmaxf(lo, v);
}

}  // namespace tardis
