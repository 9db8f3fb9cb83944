// rng_field.cu — the random-field sampler of the fold pipelines, for Hopper.
//
// Replaces the TPU kernel psrsigsim_tpu/ops/rng_pallas.py::_kernel (the
// repo's only Pallas kernel).  For every (batch element b, 8-channel group,
// 4096-sample RNG block) tile it derives two seed words from the key data
// and the GLOBAL channel group and block,
//
//     h0 = mix32(s0 ^ (cg * 0x9E3779B9 + 0x5851))
//     h1 = mix32(s1 ^ (blk * 0x85EBCA6B) ^ (cg * 0xC2B2AE35 + 0x7F4A))
//
// (mix32 is the murmur3 finalizer, as in the TPU kernel), draws
// Philox4x32-10 keyed by (h0, h1) with counter (index inside the 8x4096
// tile, 0, 0, 0) in place of the TPU's hardware PRNG, takes two 24-bit
// uniforms u1 in (0, 1] and u2 in [0, 1) from output words 0 and 1, and
// applies the TPU kernel's transforms unchanged: Box-Muller (cos branch),
// then z, z^2, Wilson-Hilferty, or the df==1 select.  The stream depends
// only on (key, global channel group, global block), so any split of the
// channels (at multiples of 8) or of time (at multiples of 4096) gives the
// same samples.
//
// Bound: the kernel writes B*nchan*length*4 bytes and reads nothing of
// size; on the main path (128 x 64 x 40960) that is 1.34 GB, 0.4 ms at
// 3.35 TB/s.  Each sample costs ~10 Philox rounds of two 32x32->64-bit
// multiplies plus log/cos/sqrt, about 150 operations, so at the card's
// non-tensor rate the kernel is bound by integer and float ALU work at
// roughly 1 ms, not by memory.  This first version is simple and right:
// one block per tile, 256 threads striding over its 32768 samples so
// stores coalesce.  The follow-up is to fuse the sampler into the fold
// body (multiply by the shifted portrait, add the noise field, quantize)
// so neither field reaches memory (ROADMAP K3).
//
// Built with nvcc for sm_90a, without --use_fast_math and with
// --fmad=false, so each float operation rounds as its counterpart does in
// the plain PyTorch version (psrsigsim_torch/ops/rng_hw.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChanGroup = 8;
constexpr int kRngBlock = 4096;
constexpr int kTile = kChanGroup * kRngBlock;
constexpr int kThreads = 256;

constexpr int kModeNormal = 0;
constexpr int kModeChi2One = 1;
constexpr int kModeChi2Wh = 2;
constexpr int kModeChi2Sel = 3;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Philox4x32-10 (Salmon et al. 2011) on counter (c0, 0, 0, 0); returns
// output words 0 and 1.
__device__ __forceinline__ void philox_2of4(uint32_t k0, uint32_t k1,
                                            uint32_t c0, uint32_t& o0,
                                            uint32_t& o1) {
  uint32_t x0 = c0, x1 = 0u, x2 = 0u, x3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * x0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, x0);
    const uint32_t lo1 = 0xCD9E8D57u * x2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x2);
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
  }
  o0 = x0;
  o1 = x1;
}

__global__ void __launch_bounds__(kThreads)
rng_field_kernel(const int32_t* __restrict__ seeds,
                 const float* __restrict__ dfs,
                 const int32_t* __restrict__ pos, float* __restrict__ out,
                 int nchan, int length, int mode) {
  const int lblk = blockIdx.x;  // RNG block within the span
  const int lgrp = blockIdx.y;  // channel group within the span
  const int b = blockIdx.z;     // batch element

  const uint32_t s0 = static_cast<uint32_t>(seeds[2 * b]);
  const uint32_t s1 = static_cast<uint32_t>(seeds[2 * b + 1]);
  const uint32_t cg = static_cast<uint32_t>(pos[2 * b]) + lgrp;
  const uint32_t gblk = static_cast<uint32_t>(pos[2 * b + 1]) + lblk;
  const uint32_t h0 = mix32(s0 ^ (cg * 0x9E3779B9u + 0x5851u));
  const uint32_t h1 =
      mix32(s1 ^ (gblk * 0x85EBCA6Bu) ^ (cg * 0xC2B2AE35u + 0x7F4Au));

  // Wilson-Hilferty constants, in the TPU kernel's order of operations
  const float k = dfs[b];
  const float c = 2.0f / (9.0f * k);
  const float sqrt_c = sqrtf(c);
  const float one_minus_c = 1.0f - c;

  const float inv24 = 5.9604644775390625e-08f;  // 2^-24
  const float two_pi = static_cast<float>(6.283185307179586);
  float* __restrict__ ob = out + static_cast<size_t>(b) * nchan * length;

  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int ch = lgrp * kChanGroup + e / kRngBlock;
    const int col = lblk * kRngBlock + e % kRngBlock;
    if (ch >= nchan || col >= length) continue;
    uint32_t w0, w1;
    philox_2of4(h0, h1, static_cast<uint32_t>(e), w0, w1);
    const float u1 = (static_cast<float>(w0 & 0x00FFFFFFu) + 1.0f) * inv24;
    const float u2 = static_cast<float>(w1 & 0x00FFFFFFu) * inv24;
    const float z = sqrtf(-2.0f * logf(u1)) * cosf(two_pi * u2);
    float val;
    if (mode == kModeNormal) {
      val = z;
    } else if (mode == kModeChi2One) {
      val = z * z;
    } else {
      const float t = one_minus_c + z * sqrt_c;
      const float wh = fmaxf(k * (t * (t * t)), 0.0f);
      val = (mode == kModeChi2Sel && k == 1.0f) ? z * z : wh;
    }
    ob[static_cast<size_t>(ch) * length + col] = val;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// seeds (B, 2) int32 key-data words, dfs (B,) float32, pos (B, 2) int32
// (first global channel group, first global RNG block), out (B, nchan,
// length) float32, all contiguous on the device.
extern "C" int rng_field_launch(const void* seeds, const void* dfs,
                                const void* pos, void* out, int batch,
                                int nchan, int length, int mode,
                                void* stream) {
  if (mode < kModeNormal || mode > kModeChi2Sel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || nchan <= 0 || length <= 0) return 0;
  const dim3 grid((length + kRngBlock - 1) / kRngBlock,
                  (nchan + kChanGroup - 1) / kChanGroup, batch);
  rng_field_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), static_cast<const float*>(dfs),
      static_cast<const int32_t*>(pos), static_cast<float*>(out), nchan,
      length, mode);
  return static_cast<int>(cudaGetLastError());
}
