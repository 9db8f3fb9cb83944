// fold_quantize.cu — the fused fold -> quantize -> pack kernel, for Hopper.
//
// Computes, in one pass and without the float block ever reaching device
// memory, what the JAX package's ensemble program computes in one XLA
// fusion (psrsigsim_tpu/simulate/pipeline.py:272-314 followed by
// psrsigsim_tpu/parallel/ensemble.py:284-322) and the port's unfused path
// computes in ~15 passes:
//
//   x = pulse * prof_shifted[b, c, bin]  (* draw_norm when it is not 1)
//       + noise * noise_norm[b]
//
// with the pulse and noise chi^2 samples drawn from philox_field.cuh at the
// sample's GLOBAL (channel, time) index, so they equal the fields the
// sampler kernel (rng_field.cu) draws; then, per (observation, subint,
// channel) row, the PSRFITS int16 quantization of ops/quantize.py:
//
//   scl = span * f32(1/65534) (1 for a constant row), offs = (hi + lo) / 2,
//   code = clamp(rint((x - offs) * (65534 / span)), -32767, 32767)
//
// written straight into the packed (B, nsub, C, nph + 4) int16 layout of
// ops/quantize.py::pack_triple (codes optionally byte-swapped for
// big-endian PSRFITS, then scl and offs as native-order int16 halves), plus
// a per-row all-finite flag.
//
// Layout: one block per (channel group of 8, subint, observation); warp w
// owns row (channel) w of the group, so each row is reduced with warp
// shuffles and no state crosses warps.  A lane draws four consecutive
// samples of its row from one Philox call per field (rows need not line
// up with the 4096-sample RNG blocks or with 4-sample quads: a quad that
// straddles two rows is drawn by both).  The row is kept in shared memory
// between the reduction and the quantization (8 x nph floats, 64 KB on the
// main path); a row too long for the 227 KB a block can hold is drawn
// twice instead, once to reduce and once to quantize — counter-based draws
// make the second pass free of state.
//
// Bound: two draws per output sample, ~46 32-bit integer operations at 64
// per SM per clock, against 2 bytes written per sample: operations, not
// bytes (chip_smoke.py states both per instruction class).
//
// Built with nvcc for sm_90a, --fmad=false, no fast math: every float
// operation rounds as its counterpart in the unfused PyTorch path does.

#include <cuda_runtime.h>

#include "philox_field.cuh"

namespace {

using namespace pss;

constexpr int kRows = kChanGroup;  // one warp per row
constexpr int kThreads = 32 * kRows;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Row {
  uint32_t h0p, h0n, s1p, s1n, cg, w;
  Chi2Map mp, mn;
  const float* prof;  // this row's shifted portrait, nph bins
  float nn, draw_norm;
  bool apply_dn;
  long long r0;  // global first sample of the row
  int nph;
  uint32_t cur_blk;
  uint32_t h1p, h1n;

  // The folded values of quad q (global samples 4q .. 4q+3); out-of-row
  // lanes are left as they are.  bins[i] is the lane's bin, or -1.
  __device__ __forceinline__ void fold4(long long q, float v[kLanes],
                                        int bins[kLanes]) {
    const long long tq = q * kLanes;
    const uint32_t blk = static_cast<uint32_t>(tq / kRngBlock);
    if (blk != cur_blk) {
      cur_blk = blk;
      h1p = seed_h1(s1p, cg, blk);
      h1n = seed_h1(s1n, cg, blk);
    }
    const uint32_t ctr = w * kQuadsPerRow +
                         static_cast<uint32_t>((tq % kRngBlock) / kLanes);
    const float4 p4 = draw4(h0p, h1p, ctr, mp);
    const float4 n4 = draw4(h0n, h1n, ctr, mn);
    const float p[kLanes] = {p4.x, p4.y, p4.z, p4.w};
    const float n[kLanes] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const long long bin = tq + i - r0;
      bins[i] = (bin >= 0 && bin < nph) ? static_cast<int>(bin) : -1;
      if (bins[i] < 0) continue;
      float x = p[i] * prof[bins[i]];
      if (apply_dn) x = x * draw_norm;
      v[i] = x + n[i] * nn;
    }
  }
};

__device__ __forceinline__ uint16_t code16(float x, float offs, float inv,
                                           bool big) {
  float q = rintf((x - offs) * inv);
  q = fminf(fmaxf(q, -32767.0f), 32767.0f);
  const uint16_t u =
      static_cast<uint16_t>(static_cast<int16_t>(static_cast<int>(q)));
  return big ? static_cast<uint16_t>((u >> 8) | (u << 8)) : u;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
fold_quantize_kernel(const int32_t* __restrict__ seeds,
                     const float* __restrict__ dfs, int mode_p, int mode_n,
                     const float* __restrict__ prof,
                     const float* __restrict__ noise_norm, float draw_norm,
                     int apply_dn, int16_t* __restrict__ out,
                     uint8_t* __restrict__ flags, int batch, int nchan,
                     int nsub, int nph, uint32_t cg0, long long t0, int big) {
  extern __shared__ float rows[];
  const int grp = blockIdx.x;
  const int sub = blockIdx.y;
  const int b = blockIdx.z;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = grp * kChanGroup + w;
  if (c >= nchan) return;  // warps are independent: no block barrier

  Row r;
  r.cg = cg0 + grp;
  r.w = w;
  r.h0p = seed_h0(static_cast<uint32_t>(seeds[2 * b]), r.cg);
  r.s1p = static_cast<uint32_t>(seeds[2 * b + 1]);
  r.h0n = seed_h0(static_cast<uint32_t>(seeds[2 * (batch + b)]), r.cg);
  r.s1n = static_cast<uint32_t>(seeds[2 * (batch + b) + 1]);
  r.mp = make_chi2_map(mode_p, dfs[b]);
  r.mn = make_chi2_map(mode_n, dfs[batch + b]);
  r.prof = prof + (static_cast<size_t>(b) * nchan + c) * nph;
  r.nn = noise_norm[b];
  r.draw_norm = draw_norm;
  r.apply_dn = apply_dn != 0;
  r.r0 = t0 + static_cast<long long>(sub) * nph;
  r.nph = nph;
  r.cur_blk = 0xFFFFFFFFu;
  r.h1p = r.h1n = 0u;
  const long long q0 = r.r0 / kLanes;
  const long long q1 = (r.r0 + nph - 1) / kLanes;
  float* row = rows + static_cast<size_t>(w) * nph;
  // every quad lies whole in the row, 16-byte aligned in shared memory
  const bool whole_quads = (nph % kLanes) == 0 && (r.r0 % kLanes) == 0;

  // pass 1: draw, fold, keep (staged), reduce
  float lo = INFINITY, hi = -INFINITY;
  bool fin = true;
  for (long long q = q0 + lane; q <= q1; q += 32) {
    float v[kLanes];
    int bins[kLanes];
    r.fold4(q, v, bins);
    if (kStaged && whole_quads) {
      *reinterpret_cast<float4*>(row + bins[0]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (bins[i] < 0) continue;
      if (kStaged && !whole_quads) row[bins[i]] = v[i];
      lo = fminf(lo, v[i]);
      hi = fmaxf(hi, v[i]);
      fin = fin && isfinite(v[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  }
  fin = __all_sync(kFull, fin);
  const float span = hi - lo;
  const bool live = span > 0.0f;
  const float scl = live ? span * 0x1.0002p-16f : 1.0f;  // f32(1/65534)
  const float offs = (hi + lo) * 0.5f;
  const float inv = live ? 65534.0f / span : 1.0f;
  const bool swap = big != 0;

  // pass 2: codes into the packed row
  int16_t* dst =
      out + ((static_cast<size_t>(b) * nsub + sub) * nchan + c) * (nph + 4);
  if (kStaged) {
    __syncwarp();
    if ((nph % 4) == 0) {  // rows start 8-byte aligned: 4 codes per store
      for (int j = lane; j < nph / 4; j += 32) {
        const float4 x = *reinterpret_cast<const float4*>(row + 4 * j);
        const uint32_t lo2 =
            code16(x.x, offs, inv, swap) |
            (static_cast<uint32_t>(code16(x.y, offs, inv, swap)) << 16);
        const uint32_t hi2 =
            code16(x.z, offs, inv, swap) |
            (static_cast<uint32_t>(code16(x.w, offs, inv, swap)) << 16);
        *reinterpret_cast<uint2*>(dst + 4 * j) = make_uint2(lo2, hi2);
      }
    } else {
      for (int i = lane; i < nph; i += 32) {
        dst[i] = static_cast<int16_t>(code16(row[i], offs, inv, swap));
      }
    }
  } else {
    for (long long q = q0 + lane; q <= q1; q += 32) {
      float v[kLanes];
      int bins[kLanes];
      r.fold4(q, v, bins);
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        if (bins[i] >= 0) {
          dst[bins[i]] = static_cast<int16_t>(code16(v[i], offs, inv, swap));
        }
      }
    }
  }
  if (lane == 0) {
    const uint32_t sb = __float_as_uint(scl);
    const uint32_t ob = __float_as_uint(offs);
    dst[nph] = static_cast<int16_t>(sb & 0xFFFFu);
    dst[nph + 1] = static_cast<int16_t>(sb >> 16);
    dst[nph + 2] = static_cast<int16_t>(ob & 0xFFFFu);
    dst[nph + 3] = static_cast<int16_t>(ob >> 16);
    flags[(static_cast<size_t>(b) * nsub + sub) * nchan + c] = fin ? 1 : 0;
  }
}

int max_dynamic_smem() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      bytes = -1;
      return 0;
    }
  }
  return bytes;
}

}  // namespace

// 1 when rows of nph bins are kept in shared memory, 0 when they are drawn
// twice, -1 when the device cannot be queried.
extern "C" int fold_quantize_staged(int nph) {
  const int limit = max_dynamic_smem();
  if (limit <= 0) return -1;
  return static_cast<size_t>(kRows) * nph * sizeof(float) <=
                 static_cast<size_t>(limit)
             ? 1
             : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// seeds (2, B, 2) int32 key-data words of the pulse and noise fields, dfs
// (2, B) float32, prof (B, nchan, nph) float32, noise_norm (B,) float32,
// out (B, nsub, nchan, nph + 4) int16, flags (B, nsub, nchan) uint8, all
// contiguous on the device.  cg0 is the global channel group of channel 0
// and t0 the global sample of subint 0's first bin.
extern "C" int fold_quantize_launch(const void* seeds, const void* dfs,
                                    int mode_p, int mode_n, const void* prof,
                                    const void* noise_norm, float draw_norm,
                                    int apply_dn, void* out, void* flags,
                                    int batch, int nchan, int nsub, int nph,
                                    int cg0, long long t0, int big,
                                    void* stream) {
  if (mode_p < kModeNormal || mode_p > kModeChi2Sel || mode_n < kModeNormal ||
      mode_n > kModeChi2Sel || t0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || nchan <= 0 || nsub <= 0 || nph <= 0) return 0;
  const int staged = fold_quantize_staged(nph);
  if (staged < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid((nchan + kChanGroup - 1) / kChanGroup, nsub, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sd = static_cast<const int32_t*>(seeds);
  const auto* df = static_cast<const float*>(dfs);
  const auto* pr = static_cast<const float*>(prof);
  const auto* nn = static_cast<const float*>(noise_norm);
  auto* o = static_cast<int16_t*>(out);
  auto* f = static_cast<uint8_t*>(flags);
  if (staged) {
    const size_t smem = static_cast<size_t>(kRows) * nph * sizeof(float);
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          fold_quantize_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic_smem());
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in = true;
    }
    fold_quantize_kernel<true><<<grid, kThreads, smem, s>>>(
        sd, df, mode_p, mode_n, pr, nn, draw_norm, apply_dn, o, f, batch,
        nchan, nsub, nph, static_cast<uint32_t>(cg0), t0, big);
  } else {
    fold_quantize_kernel<false><<<grid, kThreads, 0, s>>>(
        sd, df, mode_p, mode_n, pr, nn, draw_norm, apply_dn, o, f, batch,
        nchan, nsub, nph, static_cast<uint32_t>(cg0), t0, big);
  }
  return static_cast<int>(cudaGetLastError());
}
