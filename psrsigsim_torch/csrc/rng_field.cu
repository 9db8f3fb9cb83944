// rng_field.cu — whole random fields from the port's sampler, for Hopper.
//
// Replaces the TPU kernel psrsigsim_tpu/ops/rng_pallas.py::_kernel (the
// repo's only Pallas kernel): (B, nchan, length) float32 fields in the
// modes normal, chi2_1, chi2_wh and chi2_sel, drawn from the stream that
// philox_field.cuh defines (seeded per batch element, GLOBAL 8-channel
// group and GLOBAL 4096-sample block).
//
// Bound.  The kernel writes 4 bytes per sample and reads nothing of size:
// 1.34 GB on the main path (128 x 64 x 40960), 0.40 ms at 3.35 TB/s.  Its
// instructions are mostly 32-bit integer work, which Hopper issues at 64
// per SM per clock: Philox4x32-10 needs 78 integer operations per call (10
// rounds of 4 multiplies and 2 three-input XORs, 9 key bumps of 2 adds), so
// one call per sample would hold a field at >= 1.6 ms of integer issue.
// The kernel keeps all four output words: one call makes two Box-Muller
// pairs and both branches of each, four samples, a quarter of the integer
// work per sample, and the thread stores the four contiguous samples of
// one channel as one 16-byte float4 (scalar stores where the row is not
// 16-byte aligned or at its ragged end).
//
// Grid: one block of 256 threads per (batch element, channel group, RNG
// block) tile; each thread takes tile counters threadIdx.x, +256, ..., so a
// warp stores 512 contiguous bytes of a row.
//
// Output layouts (rng_field_layout_launch):
// - rows: (B, nchan, length), sample s of channel c at c * length + s;
// - flat: the SEARCH-mode flat stream of channel group pos[b][0], whole
//   8 x 4096 tiles flattened in (block, channel, sample) order — sample s
//   of channel c in block b0 + t sits at flat index (t * 8 + c) * 4096 + s
//   — of which each batch element keeps the span [skip, skip + length):
//   (B, length).  The JAX package draws these rows and transposes them
//   (psrsigsim_tpu/ops/stats.py::flat_normal_field); storing them in flat
//   order saves that pass over the field.  The chi^2 map stays in
//   registers, as in the rows layout.
//
// box_muller_selftest proves the header's specialised Box-Muller sequences
// bit-identical to the CUDA math library on all 2^24 inputs of each.
//
// Built with nvcc for sm_90a, --fmad=false, no fast math (see the header).

#include <cuda_runtime.h>

#include "philox_field.cuh"

namespace {

using namespace pss;

constexpr int kThreads = 256;

template <bool kFlat>
__global__ void __launch_bounds__(kThreads)
rng_field_kernel(const int32_t* __restrict__ seeds,
                 const float* __restrict__ dfs,
                 const int32_t* __restrict__ pos, float* __restrict__ out,
                 int nchan, int length, int mode, int skip) {
  const int lblk = blockIdx.x;  // RNG block within the span
  const int lgrp = blockIdx.y;  // channel group within the span
  const int b = blockIdx.z;     // batch element

  const uint32_t s1 = static_cast<uint32_t>(seeds[2 * b + 1]);
  const uint32_t cg = static_cast<uint32_t>(pos[2 * b]) + lgrp;
  const uint32_t h0 = seed_h0(static_cast<uint32_t>(seeds[2 * b]), cg);
  const uint32_t h1 =
      seed_h1(s1, cg, static_cast<uint32_t>(pos[2 * b + 1]) + lblk);
  const Chi2Map map = make_chi2_map(mode, dfs[b]);

  if constexpr (kFlat) {
    // one channel group; sample (ch, col) of this tile lands at flat
    // index (lblk * 8 + ch) * 4096 + col - skip of the element's span
    float* __restrict__ ob = out + static_cast<size_t>(b) * length;
    const bool aligned = ((length | skip) & 3) == 0;
    for (int q = threadIdx.x; q < kQuadsPerTile; q += kThreads) {
      const int g = (lblk * kChanGroup + q / kQuadsPerRow) * kRngBlock +
                    (q % kQuadsPerRow) * kLanes - skip;
      if (g + kLanes <= 0 || g >= length) continue;
      const float4 v = draw4(h0, h1, static_cast<uint32_t>(q), map);
      if (aligned && g >= 0 && g + kLanes <= length) {
        *reinterpret_cast<float4*>(ob + g) = v;
      } else {
        if (g >= 0) ob[g] = v.x;
        if (g + 1 >= 0 && g + 1 < length) ob[g + 1] = v.y;
        if (g + 2 >= 0 && g + 2 < length) ob[g + 2] = v.z;
        if (g + 3 < length) ob[g + 3] = v.w;
      }
    }
  } else {
    const bool aligned = (length & 3) == 0;
    float* __restrict__ ob = out + static_cast<size_t>(b) * nchan * length;
    for (int q = threadIdx.x; q < kQuadsPerTile; q += kThreads) {
      const int ch = lgrp * kChanGroup + q / kQuadsPerRow;
      const int col = lblk * kRngBlock + (q % kQuadsPerRow) * kLanes;
      if (ch >= nchan || col >= length) continue;
      const float4 v = draw4(h0, h1, static_cast<uint32_t>(q), map);
      float* dst = ob + static_cast<size_t>(ch) * length + col;
      if (aligned && col + kLanes <= length) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        dst[0] = v.x;
        if (col + 1 < length) dst[1] = v.y;
        if (col + 2 < length) dst[2] = v.z;
        if (col + 3 < length) dst[3] = v.w;
      }
    }
  }
}

// Every 24-bit word m once: the header's Box-Muller sequences against the
// CUDA math library calls they specialise, bit for bit.  miss[0] counts
// radii that differ, miss[1] sines, miss[2] cosines.
__global__ void __launch_bounds__(kThreads)
box_muller_selftest_kernel(unsigned long long* __restrict__ miss) {
  const uint32_t m = blockIdx.x * kThreads + threadIdx.x;
  const float u1 = (static_cast<float>(m) + 1.0f) * 5.9604644775390625e-08f;
  const float u2 = static_cast<float>(m) * 5.9604644775390625e-08f;
  const float r_lib = sqrtf(-2.0f * logf(u1));
  float s_lib, c_lib, s, c;
  sincosf(static_cast<float>(6.283185307179586) * u2, &s_lib, &c_lib);
  bm_sincos(m, &s, &c);
  const int dr = __syncthreads_count(__float_as_uint(bm_radius(m)) !=
                                     __float_as_uint(r_lib));
  const int ds =
      __syncthreads_count(__float_as_uint(s) != __float_as_uint(s_lib));
  const int dc =
      __syncthreads_count(__float_as_uint(c) != __float_as_uint(c_lib));
  if (threadIdx.x == 0) {
    if (dr) atomicAdd(miss, static_cast<unsigned long long>(dr));
    if (ds) atomicAdd(miss + 1, static_cast<unsigned long long>(ds));
    if (dc) atomicAdd(miss + 2, static_cast<unsigned long long>(dc));
  }
}

}  // namespace

// Launch the self-test over all 2^24 words on `stream`; `miss` is three
// zeroed uint64 counters on the device.  Returns the cudaError_t.
extern "C" int box_muller_selftest(void* miss, void* stream) {
  box_muller_selftest_kernel<<<(1u << 24) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(miss));
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// seeds (B, 2) int32 key-data words, dfs (B,) float32, pos (B, 2) int32
// (first global channel group, first global RNG block), all contiguous on
// the device.  layout 0 (rows): out (B, nchan, length) float32, skip 0.
// layout 1 (flat): nchan must be 8 (one channel group), out (B, length)
// float32 holding flat indices [skip, skip + length) of the stream of
// whole tiles from block pos[b][1], 0 <= skip < 8 * 4096.
extern "C" int rng_field_layout_launch(const void* seeds, const void* dfs,
                                       const void* pos, void* out, int batch,
                                       int nchan, int length, int mode,
                                       int layout, int skip, void* stream) {
  if (mode < kModeNormal || mode > kModeChi2Sel || layout < 0 ||
      layout > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || nchan <= 0 || length <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sp = static_cast<const int32_t*>(seeds);
  const float* dp = static_cast<const float*>(dfs);
  const int32_t* pp = static_cast<const int32_t*>(pos);
  float* op = static_cast<float*>(out);
  if (layout == 1) {
    if (nchan != kChanGroup || skip < 0 || skip >= kTile) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long tiles =
        (static_cast<long long>(skip) + length + kTile - 1) / kTile;
    if (tiles * kTile > 0x7FFFFFFFLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned>(tiles), 1, batch);
    rng_field_kernel<true><<<grid, kThreads, 0, st>>>(sp, dp, pp, op, nchan,
                                                     length, mode, skip);
  } else {
    if (skip != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((length + kRngBlock - 1) / kRngBlock,
                    (nchan + kChanGroup - 1) / kChanGroup, batch);
    rng_field_kernel<false><<<grid, kThreads, 0, st>>>(sp, dp, pp, op, nchan,
                                                      length, mode, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
