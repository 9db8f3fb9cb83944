// threefry.cuh — jax's threefry2x32 key stream, for Hopper kernels.
//
// Threefry-2x32 with 20 rounds, the function behind jax.random's default
// keys (psrsigsim_torch/utils/rng.py::threefry2x32 is the same in torch
// ops).  jax's partitionable split gives key i of split(k, n) as both
// output words of counter (0, i); its random bits of one draw from key k
// are the XOR of the words of counter (0, 0).  A kernel can derive any
// element's key in registers from its row key and its counter.
//
// Cost: 20 rounds of an add, a rotate (one funnel shift) and an XOR, five
// key injections of two adds, and the key-schedule XOR: 73 32-bit integer
// operations a call.

#pragma once

#include <stdint.h>

namespace pss {

constexpr int kThreefryOpsPerCall = 73;

__device__ __forceinline__ uint32_t tf_rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = tf_rotl(x1, r0) ^ x0;
    x0 += x1; x1 = tf_rotl(x1, r1) ^ x0;
    x0 += x1; x1 = tf_rotl(x1, r2) ^ x0;
    x0 += x1; x1 = tf_rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// key i of jax's split(k, n): both words of counter (0, i)
__device__ __forceinline__ void tf_split(uint32_t k0, uint32_t k1, uint32_t i,
                                         uint32_t& o0, uint32_t& o1) {
  threefry2x32(k0, k1, 0u, i, o0, o1);
}

// the 32 random bits of one jax draw from key (k0, k1)
__device__ __forceinline__ uint32_t tf_bits(uint32_t k0, uint32_t k1) {
  uint32_t o0, o1;
  threefry2x32(k0, k1, 0u, 0u, o0, o1);
  return o0 ^ o1;
}

}  // namespace pss
