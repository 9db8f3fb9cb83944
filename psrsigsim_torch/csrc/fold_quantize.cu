// fold_quantize.cu — the fused fold -> quantize -> pack kernel, for Hopper.
//
// Computes, in one pass and without the float block ever reaching device
// memory, what the JAX package's ensemble program computes in one XLA
// fusion (psrsigsim_tpu/simulate/pipeline.py:272-314 followed by
// psrsigsim_tpu/parallel/ensemble.py:284-322) and the port's unfused path
// computes in ~15 passes:
//
//   x = pulse * prof_shifted[b, c, bin]  (* draw_norm when it is not 1)
//       (* gain[b, c, sub]) (* energy[b, sub])
//       + noise * noise_norm[b]  (+ level[b, c, sub])
//
// where the bracketed scenario factors (scintillation gain, single-pulse
// energy, RFI level; psrsigsim_tpu/simulate/pipeline.py:289-324) are row
// constants present only when the launch passes them: a compile-time flag
// set selects the instantiation, so a scenario-free launch runs the same
// code as before the factors existed.
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
// Bound: two draws per output sample.  Each Philox call costs ~20 wide
// multiplies and 20 three-input XORs; Box-Muller and the chi^2 map are ~60
// float operations per pair; the rows kernel issues 385 instructions per
// quad of a row on the main path (its SASS), so it is bound by instruction
// issue (one warp instruction per scheduler per clock), not by the 2 bytes
// it writes per sample (chip_smoke.py states the per-class bound).
//
// Two kernels, one function:
//
// - fold_quantize_rows_kernel, the main path's: rows that are a whole
//   number of 4-sample quads and lie inside one 4096-sample RNG block, both
//   fields chi2_wh (chip_smoke's BASELINE config 1: nph 2048, t0 0).  The
//   mode pair is a template argument (no branch in the chi^2 map); each row
//   seeds its two Philox keys once and advances a 32-bit counter, with no
//   64-bit index arithmetic and no per-sample bounds test; the portrait is
//   read as one float4 per quad.  One warp owns a row and reduces it with
//   warp shuffles; a lane quantizes the quads it drew, from shared memory,
//   so no lane waits on another.  min/max propagate NaN, so
//   the row is finite exactly when its min and max are (no per-sample
//   test).  The code is rint by the 1.5 * 2^23 rounding constant after the
//   clamp (the two commute: the bounds are integers), its low 16 bits taken
//   with the byte swap in one byte permute.
// - fold_quantize_kernel, every other shape: one block per (channel group
//   of 8, subint, observation), one warp per row; a lane draws four
//   consecutive samples of its row from one Philox call per field at the
//   quad's global index (rows need not line up with quads or RNG blocks: a
//   quad that straddles two rows is drawn by both).  The row waits in
//   shared memory between the reduction and the quantization; a row too
//   long for the 227 KB a block can hold is drawn twice instead —
//   counter-based draws make the second pass free of state.
//
// Built with nvcc for sm_90a, --fmad=false, no fast math: every float
// operation rounds as its counterpart in the unfused PyTorch path does.

#include <cuda_runtime.h>

#include "philox_field.cuh"

namespace {

using namespace pss;

constexpr int kThreads = 256;
constexpr int kRows = kChanGroup;  // general kernel: one warp per row
constexpr unsigned kFull = 0xFFFFFFFFu;

// rows kernel: one warp per row, kRowsPerBlock rows per block
constexpr int kRowsPerBlock = 4;
constexpr int kRowsThreads = 32 * kRowsPerBlock;
// its largest staging: rows of up to one RNG block
constexpr int kRowsBytes = kRowsPerBlock * kRngBlock * sizeof(float);

// min and max that return NaN when either input is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The quantizer of a row with extremes lo, hi.
struct Quant {
  float scl, offs, inv;
  __device__ __forceinline__ Quant(float lo, float hi) {
    const float span = hi - lo;
    const bool live = span > 0.0f;
    scl = live ? span * 0x1.0002p-16f : 1.0f;  // f32(1/65534)
    offs = (hi + lo) * 0.5f;
    inv = live ? 65534.0f / span : 1.0f;
  }
  // The code of x in the low 16 bits: clamp, then rint by the rounding
  // constant, whose float bits end in the integer.
  __device__ __forceinline__ uint32_t code(float x) const {
    float q = (x - offs) * inv;
    q = fminf(fmaxf(q, -32767.0f), 32767.0f);
    return __float_as_uint(q + 12582912.0f);
  }
  // Four codes as two words, byte-swapped when sel says so.
  __device__ __forceinline__ uint2 code4(float4 x, uint32_t sel) const {
    return make_uint2(__byte_perm(code(x.x), code(x.y), sel),
                      __byte_perm(code(x.z), code(x.w), sel));
  }
};

// byte_perm selectors: two codes' low halves, as they are or byte-swapped
__device__ __forceinline__ uint32_t code_sel(int big) {
  return big ? 0x4501u : 0x5410u;
}

// scenario factor flags (template argument kFx)
constexpr int kGain = 1;    // x *= gain[b, c, sub]
constexpr int kEnergy = 2;  // x *= energy[b, sub]
constexpr int kLevel = 4;   // x += level[b, c, sub], after the noise

// A row's scenario constants (identity values where a flag is unset).
struct Factors {
  float g, e, l;
  template <int kFx>
  __device__ __forceinline__ static Factors load(const float* gain,
                                                 const float* energy,
                                                 const float* level, int b,
                                                 int c, int sub, int nchan,
                                                 int nsub) {
    const size_t rc = (static_cast<size_t>(b) * nchan + c) * nsub + sub;
    Factors f{1.0f, 1.0f, 0.0f};
    if (kFx & kGain) f.g = gain[rc];
    if (kFx & kEnergy) f.e = energy[static_cast<size_t>(b) * nsub + sub];
    if (kFx & kLevel) f.l = level[rc];
    return f;
  }
};

// One sample, one rounding per operation in the unfused order.
template <int kFx>
__device__ __forceinline__ float fold(float p, float prof, float n, float nn,
                                      float draw_norm, bool apply_dn,
                                      const Factors& fx) {
  float x = p * prof;
  if (apply_dn) x = x * draw_norm;
  if (kFx & kGain) x = x * fx.g;
  if (kFx & kEnergy) x = x * fx.e;
  x = x + n * nn;
  if (kFx & kLevel) x = x + fx.l;
  return x;
}

// scl and offs as native-order int16 halves after the codes, and the flag
__device__ __forceinline__ void write_tail(int16_t* dst, int nph,
                                          const Quant& q, uint8_t* flag,
                                          bool fin) {
  const uint32_t sb = __float_as_uint(q.scl);
  const uint32_t ob = __float_as_uint(q.offs);
  dst[nph] = static_cast<int16_t>(sb & 0xFFFFu);
  dst[nph + 1] = static_cast<int16_t>(sb >> 16);
  dst[nph + 2] = static_cast<int16_t>(ob & 0xFFFFu);
  dst[nph + 3] = static_cast<int16_t>(ob >> 16);
  *flag = fin ? 1 : 0;
}

// -- the main path's rows --------------------------------------------------

template <int kModeP, int kModeN, int kFx>
__global__ void __launch_bounds__(kRowsThreads)
fold_quantize_rows_kernel(const int32_t* __restrict__ seeds,
                          const float* __restrict__ dfs,
                          const float* __restrict__ prof,
                          const float* __restrict__ noise_norm,
                          float draw_norm, int apply_dn,
                          int16_t* __restrict__ out,
                          uint8_t* __restrict__ flags, int batch, int nchan,
                          int nsub, int nph, uint32_t cg0, long long t0,
                          int big, const float* __restrict__ gain,
                          const float* __restrict__ energy,
                          const float* __restrict__ level) {
  extern __shared__ float4 stage[];
  const int rb = threadIdx.x / 32;  // row within the block
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kRowsPerBlock + rb;
  const int sub = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= nchan) return;  // warps are independent: no block barrier

  // the row's keys and its first counter, once
  const uint32_t cg = cg0 + static_cast<uint32_t>(c / kChanGroup);
  const long long r0 = t0 + static_cast<long long>(sub) * nph;
  const uint32_t blk = static_cast<uint32_t>(r0 / kRngBlock);
  const uint32_t ctr0 =
      static_cast<uint32_t>(c % kChanGroup) * kQuadsPerRow +
      static_cast<uint32_t>(r0 % kRngBlock) / kLanes;
  const uint32_t h0p = seed_h0(static_cast<uint32_t>(seeds[2 * b]), cg);
  const uint32_t h1p =
      seed_h1(static_cast<uint32_t>(seeds[2 * b + 1]), cg, blk);
  const uint32_t h0n =
      seed_h0(static_cast<uint32_t>(seeds[2 * (batch + b)]), cg);
  const uint32_t h1n =
      seed_h1(static_cast<uint32_t>(seeds[2 * (batch + b) + 1]), cg, blk);
  const Chi2Map mp = make_chi2_map(kModeP, dfs[b]);
  const Chi2Map mn = make_chi2_map(kModeN, dfs[batch + b]);
  const float nn = noise_norm[b];
  const bool dn = apply_dn != 0;
  const Factors fx =
      Factors::load<kFx>(gain, energy, level, b, c, sub, nchan, nsub);
  const int nq = nph / kLanes;
  const float4* __restrict__ pq = reinterpret_cast<const float4*>(
      prof + (static_cast<size_t>(b) * nchan + c) * nph);
  float4* row = stage + static_cast<size_t>(rb) * nq;

  // pass 1: draw, fold, keep, reduce (two quads in flight per lane)
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll 2
  for (int i = lane; i < nq; i += 32) {
    const float4 p = draw4<kModeP>(h0p, h1p, ctr0 + i, mp);
    const float4 n = draw4<kModeN>(h0n, h1n, ctr0 + i, mn);
    const float4 w = __ldg(pq + i);
    const float4 v =
        make_float4(fold<kFx>(p.x, w.x, n.x, nn, draw_norm, dn, fx),
                    fold<kFx>(p.y, w.y, n.y, nn, draw_norm, dn, fx),
                    fold<kFx>(p.z, w.z, n.z, nn, draw_norm, dn, fx),
                    fold<kFx>(p.w, w.w, n.w, nn, draw_norm, dn, fx));
    row[i] = v;
    lo = min_nan(min_nan(min_nan(min_nan(lo, v.x), v.y), v.z), v.w);
    hi = max_nan(max_nan(max_nan(max_nan(hi, v.x), v.y), v.z), v.w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(kFull, hi, off));
  }
  const bool fin = isfinite(lo) && isfinite(hi);
  const Quant q(lo, hi);

  // pass 2: each lane codes the quads it drew
  const size_t r = (static_cast<size_t>(b) * nsub + sub) * nchan + c;
  int16_t* dst = out + r * (nph + 4);
  uint2* d2 = reinterpret_cast<uint2*>(dst);  // rows start 8-byte aligned
  const uint32_t sel = code_sel(big);
  for (int i = lane; i < nq; i += 32) d2[i] = q.code4(row[i], sel);
  if (lane == 0) write_tail(dst, nph, q, flags + r, fin);
}

// -- every other shape -------------------------------------------------------

template <int kFx>
struct Row {
  uint32_t h0p, h0n, s1p, s1n, cg, w;
  Chi2Map mp, mn;
  const float* prof;  // this row's shifted portrait, nph bins
  float nn, draw_norm;
  bool apply_dn;
  Factors fx;
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
      v[i] = fold<kFx>(p[i], prof[bins[i]], n[i], nn, draw_norm, apply_dn,
                       fx);
    }
  }
};

template <bool kStaged, int kFx>
__global__ void __launch_bounds__(kThreads)
fold_quantize_kernel(const int32_t* __restrict__ seeds,
                     const float* __restrict__ dfs, int mode_p, int mode_n,
                     const float* __restrict__ prof,
                     const float* __restrict__ noise_norm, float draw_norm,
                     int apply_dn, int16_t* __restrict__ out,
                     uint8_t* __restrict__ flags, int batch, int nchan,
                     int nsub, int nph, uint32_t cg0, long long t0, int big,
                     const float* __restrict__ gain,
                     const float* __restrict__ energy,
                     const float* __restrict__ level) {
  extern __shared__ float rows[];
  const int grp = blockIdx.x;
  const int sub = blockIdx.y;
  const int b = blockIdx.z;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = grp * kChanGroup + w;
  if (c >= nchan) return;  // warps are independent: no block barrier

  Row<kFx> r;
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
  r.fx = Factors::load<kFx>(gain, energy, level, b, c, sub, nchan, nsub);
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
  const Quant qz(lo, hi);
  const uint32_t sel = code_sel(big);

  // pass 2: codes into the packed row
  const size_t ri = (static_cast<size_t>(b) * nsub + sub) * nchan + c;
  int16_t* dst = out + ri * (nph + 4);
  if (kStaged) {
    __syncwarp();
    if ((nph % 4) == 0) {  // rows start 8-byte aligned: 4 codes per store
      for (int j = lane; j < nph / 4; j += 32) {
        reinterpret_cast<uint2*>(dst)[j] =
            qz.code4(*reinterpret_cast<const float4*>(row + 4 * j), sel);
      }
    } else {
      for (int i = lane; i < nph; i += 32) {
        dst[i] = static_cast<int16_t>(
            static_cast<uint16_t>(__byte_perm(qz.code(row[i]), 0, sel)));
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
          dst[bins[i]] = static_cast<int16_t>(
              static_cast<uint16_t>(__byte_perm(qz.code(v[i]), 0, sel)));
        }
      }
    }
  }
  if (lane == 0) write_tail(dst, nph, qz, flags + ri, fin);
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

// Whether every row is a whole number of quads inside one RNG block.
bool rows_in_blocks(int nph, int nsub, long long t0) {
  if (nph % kLanes != 0 || t0 % kLanes != 0 || nph > kRngBlock) return false;
  for (int s = 0; s < nsub; ++s) {
    if ((t0 + static_cast<long long>(s) * nph) % kRngBlock + nph > kRngBlock) {
      return false;
    }
  }
  return true;
}

// The kernel a shape takes: 2 the rows kernel, 1 the general kernel with
// rows kept in shared memory, 0 the general kernel drawing rows twice, -1
// when the device cannot be queried.
int route(int mode_p, int mode_n, int nph, int nsub, long long t0) {
  const int limit = max_dynamic_smem();
  if (limit <= 0) return -1;
  if (mode_p == kModeChi2Wh && mode_n == kModeChi2Wh &&
      rows_in_blocks(nph, nsub, t0)) {
    return 2;  // kRowsBytes of shared memory at most
  }
  return static_cast<size_t>(kRows) * nph * sizeof(float) <=
                 static_cast<size_t>(limit)
             ? 1
             : 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory, once.
template <typename K>
cudaError_t opt_in(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace

// The route of a launch with these arguments (see route above).
extern "C" int fold_quantize_route(int mode_p, int mode_n, int nph, int nsub,
                                   long long t0) {
  return route(mode_p, mode_n, nph, nsub, t0);
}

namespace {

// One launch's arguments, as fold_quantize_launch receives them.
struct Launch {
  const int32_t* seeds;
  const float* dfs;
  int mode_p, mode_n;
  const float* prof;
  const float* noise_norm;
  float draw_norm;
  int apply_dn;
  int16_t* out;
  uint8_t* flags;
  int batch, nchan, nsub, nph;
  uint32_t cg0;
  long long t0;
  int big;
  const float *gain, *energy, *level;
  cudaStream_t stream;
};

// The instantiation for factor set kFx on route `how` (see route above).
template <int kFx>
int launch(const Launch& a, int how) {
  if (how == 2) {
    static bool opted = false;
    const auto kernel =
        fold_quantize_rows_kernel<kModeChi2Wh, kModeChi2Wh, kFx>;
    const cudaError_t err = opt_in(kernel, kRowsBytes, &opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.nchan + kRowsPerBlock - 1) / kRowsPerBlock, a.nsub,
                    a.batch);
    const size_t smem =
        static_cast<size_t>(kRowsPerBlock) * a.nph * sizeof(float);
    kernel<<<grid, kRowsThreads, smem, a.stream>>>(
        a.seeds, a.dfs, a.prof, a.noise_norm, a.draw_norm, a.apply_dn, a.out,
        a.flags, a.batch, a.nchan, a.nsub, a.nph, a.cg0, a.t0, a.big, a.gain,
        a.energy, a.level);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((a.nchan + kChanGroup - 1) / kChanGroup, a.nsub, a.batch);
  if (how == 1) {
    static bool opted = false;
    const cudaError_t err = opt_in(fold_quantize_kernel<true, kFx>,
                                   max_dynamic_smem(), &opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = static_cast<size_t>(kRows) * a.nph * sizeof(float);
    fold_quantize_kernel<true, kFx><<<grid, kThreads, smem, a.stream>>>(
        a.seeds, a.dfs, a.mode_p, a.mode_n, a.prof, a.noise_norm, a.draw_norm,
        a.apply_dn, a.out, a.flags, a.batch, a.nchan, a.nsub, a.nph, a.cg0,
        a.t0, a.big, a.gain, a.energy, a.level);
  } else {
    fold_quantize_kernel<false, kFx><<<grid, kThreads, 0, a.stream>>>(
        a.seeds, a.dfs, a.mode_p, a.mode_n, a.prof, a.noise_norm, a.draw_norm,
        a.apply_dn, a.out, a.flags, a.batch, a.nchan, a.nsub, a.nph, a.cg0,
        a.t0, a.big, a.gain, a.energy, a.level);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// seeds (2, B, 2) int32 key-data words of the pulse and noise fields, dfs
// (2, B) float32, prof (B, nchan, nph) float32, noise_norm (B,) float32,
// out (B, nsub, nchan, nph + 4) int16, flags (B, nsub, nchan) uint8, all
// contiguous on the device.  cg0 is the global channel group of channel 0
// and t0 the global sample of subint 0's first bin.  The scenario factors
// gain (B, nchan, nsub), energy (B, nsub) and level (B, nchan, nsub)
// float32 are each optional (null: the factor is absent).
extern "C" int fold_quantize_launch(const void* seeds, const void* dfs,
                                    int mode_p, int mode_n, const void* prof,
                                    const void* noise_norm, float draw_norm,
                                    int apply_dn, void* out, void* flags,
                                    int batch, int nchan, int nsub, int nph,
                                    int cg0, long long t0, int big,
                                    void* stream, const void* gain,
                                    const void* energy, const void* level) {
  if (mode_p < kModeNormal || mode_p > kModeChi2Sel || mode_n < kModeNormal ||
      mode_n > kModeChi2Sel || t0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || nchan <= 0 || nsub <= 0 || nph <= 0) return 0;
  const int how = route(mode_p, mode_n, nph, nsub, t0);
  if (how < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Launch a{static_cast<const int32_t*>(seeds),
                 static_cast<const float*>(dfs),
                 mode_p,
                 mode_n,
                 static_cast<const float*>(prof),
                 static_cast<const float*>(noise_norm),
                 draw_norm,
                 apply_dn,
                 static_cast<int16_t*>(out),
                 static_cast<uint8_t*>(flags),
                 batch,
                 nchan,
                 nsub,
                 nph,
                 static_cast<uint32_t>(cg0),
                 t0,
                 big,
                 static_cast<const float*>(gain),
                 static_cast<const float*>(energy),
                 static_cast<const float*>(level),
                 static_cast<cudaStream_t>(stream)};
  const int fx = (gain ? kGain : 0) | (energy ? kEnergy : 0) |
                 (level ? kLevel : 0);
  switch (fx) {
    case 0: return launch<0>(a, how);
    case 1: return launch<1>(a, how);
    case 2: return launch<2>(a, how);
    case 3: return launch<3>(a, how);
    case 4: return launch<4>(a, how);
    case 5: return launch<5>(a, how);
    case 6: return launch<6>(a, how);
    default: return launch<7>(a, how);
  }
}
