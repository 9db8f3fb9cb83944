// scenario_draws.cu — the scenario engine's factors, drawn on the card from
// the observations' keys (K10).
//
// Replaces the JAX package's scenario draws, psrsigsim_tpu/ops/scenario.py
// (scint_gain, rfi_levels, pulse_energies, reached from its
// scenarios/registry.py for every scenario batch).  That is not a Pallas
// kernel: XLA compiles each effect to a fusion.  The port's host code,
// psrsigsim_torch/ops/scenario.py, writes the same arithmetic out in torch
// CPU ops (DIVERGENCES P13); this kernel gives its bits for keys that lie
// on the card, one thread per output element:
//
// * scenario_scint_launch — one thread per (observation, channel, subint)
//   cell: the scintle cell ids cell_f and cell_t as ops/scenario.py's
//   scint_cells rounds them (the per-channel powers x^-3.4 and x^1.2 come
//   from the wrapper, rounded once from the float64 power), the key
//   fold_in(fold_in(stage key, cell_f), cell_t), one exponential
//   -log1p(-u) and 1 + m (e - 1) as one fused multiply-add.  Each cell
//   draws its own key: the same draws as the host's de-duplicated keys.
// * scenario_rfi_launch — one thread per cell: the burst of its subint
//   (fold_in(fold_in(k, 0), 0) for the selection, fold_in(fold_in(k, 0), 1)
//   for the energy, word s of each) and the tone of its global channel id
//   (fold_in(fold_in(fold_in(k, 1), chan), 0 or 1), word 0), the level
//   imp_snr e_s burst + nb_snr e_c tone, times the observation's noise
//   level where one is given, and the truth mask burst | tone.
// * scenario_stage_launch — one thread per (observation, effect): the
//   effect's stage key stage_key(k, stage, 0) = fold_in(fold_in(k, stage),
//   0) of the observation's key, so the host sends the observation keys.
// * scenario_energy_launch — one thread per (observation, subint): the
//   log-normal exp(fma(sigma sqrt2, erf_inv(u), -(sigma/2) sigma)) with
//   XLA's Cephes exp, the power law (alpha-1)/alpha u^(-1/alpha) with the
//   power rounded once from float64, or the FRB's one burst at jax's
//   randint(k, (), 0, nsub).
//
// Every operation rounds as the host's does: the fused multiply-adds are
// explicit fmaf, every other operation rounds on its own (--fmad=false;
// the cell ids' arithmetic spelled out in __fmul_rn/__fdiv_rn/__fadd_rn),
// divisions and square roots are IEEE, subnormals are kept, as torch keeps
// them on the host.  The one function that is not XLA's own is the
// power law's float64 pow: the host's and CUDA's are each within an ulp of
// float64 or two, so the two float32 results can part only where the exact
// power lies within ~2^-52 of a float32 rounding midpoint (DIVERGENCES
// P13 gives the measured rate).
//
// Bound.  The output is ~1.5 MB a 128 x 64 x 20 chunk (gains, levels,
// mask, energies): 0.45 us at 3.35 TB/s, the larger bound.  The draws the
// chunk needs, each once, are threefry calls of 73 integer operations
// (threefry.cuh): 3 a distinct scintle key (~26,000 of the 163,840
// cells), 2 an (observation, subint) burst, 5 an (observation, channel)
// tone, 1 an energy, 2 a stage key, with ~15 float32 operations a cell:
// ~1.3e7 operations, 0.4 us at the issue limit (132 SMs x 128 a clock x
// 1.98 GHz).  This kernel repeats the shared draws in every cell's thread
// (no de-duplication, no sort), so it stays far from that bound.
//
// Built with nvcc for sm_90a, --fmad=false, no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

using namespace pss;

constexpr int kThreads = 256;
constexpr int kMaxCols = 5;
constexpr int kMaxStages = 8;
constexpr float kMaxCell = 16777216.0f;  // cell ids clip at 2^24

// one float32 parameter per observation: element r * step (step 0: one
// value for every observation)
struct Cols {
  const float* p[kMaxCols];
  long long step[kMaxCols];
};

__device__ __forceinline__ float col(const Cols& c, int j, long long r) {
  return c.p[j][r * c.step[j]];
}

// the observation's stage key: the low words of two int64 key-data words
__device__ __forceinline__ void key_of(const long long* __restrict__ keys,
                                       long long stride, long long r,
                                       uint32_t& k0, uint32_t& k1) {
  k0 = static_cast<uint32_t>(keys[r * stride]);
  k1 = static_cast<uint32_t>(keys[r * stride + 1]);
}

// torch.clamp_min(x, lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.clamp(x, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// clip(floor(x), 0, 2^24) as the 32-bit word fold_in takes: a NaN cell is
// word 0 on the host (the low word of its int64) and here
__device__ __forceinline__ uint32_t cell_id(float x) {
  const float c = clamp_nan(floorf(x), 0.0f, kMaxCell);
  return c == c ? static_cast<uint32_t>(c) : 0u;
}

// jax's exponential of one key: -log1p(-u), u its uniform in [0, 1)
__device__ __forceinline__ float exponential_of(uint32_t k0, uint32_t k1) {
  return -xla_log1p(-uniform01(tf_bits(k0, k1)));
}

// the 32 random bits of word i of a jax draw from key (k0, k1)
__device__ __forceinline__ uint32_t word(uint32_t k0, uint32_t k1,
                                         uint32_t i) {
  uint32_t o0, o1;
  threefry2x32(k0, k1, 0u, i, o0, o1);
  return o0 ^ o1;
}

// jax's float32 uniform in [lo, 1) of 32 random bits: the top 23 bits as a
// mantissa in [1, 2), minus 1, scaled by one fused multiply-add, clamped
// at lo (ops/stats.py::_bits_uniform)
__device__ __forceinline__ float uniform_lo(uint32_t bits, float lo) {
  const float f = __fsub_rn(as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, fmaf(f, __fsub_rn(1.0f, lo), lo));
}

// XLA CPU's float32 exp (Cephes/Eigen; ops/stats.py::exp): x = n ln2 + r,
// a degree-5 polynomial in r, n put into the exponent, a subnormal result
// flushed to zero
__device__ float xla_exp(float x) {
  x = clamp_nan(x, -0x1.5f3334p+6f, 0x1.633334p+6f);  // -87.8, 88.8
  float n = floorf(fmaf(x, 0x1.715476p+0f, 0.5f));  // log2(e)
  n = clamp_nan(n, -127.0f, 127.0f);
  float r = fmaf(n, -0.693359375f, x);
  r = fmaf(n, 0x1.bd0106p-13f, r);  // 2.12194440e-4
  float y = fmaf(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  y = fmaf(y, r, 0x1.111210p-7f);
  y = fmaf(y, r, 0x1.555382p-5f);
  y = fmaf(y, r, 0x1.555554p-3f);
  y = fmaf(y, r, 0.5f);
  y = __fadd_rn(fmaf(y, __fmul_rn(r, r), r), 1.0f);
  y = __fmul_rn(y, __int_as_float((static_cast<int>(n) + 127) << 23));
  return y < kFltMin ? 0.0f : y;
}

// the stage numbers of a batch's effects, as one kernel argument
struct Stages {
  uint32_t id[kMaxStages];
};

// jax's stage_key(k, stage, 0) = fold_in(fold_in(k, stage), 0) of every
// observation key for every stage: out (nobs, nstages, 2) int64
__global__ void __launch_bounds__(kThreads)
stage_kernel(const long long* __restrict__ keys, long long key_stride,
             long long nobs, int nstages, Stages stages,
             long long* __restrict__ out) {
  const long long total = nobs * nstages;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    uint32_t k0, k1;
    key_of(keys, key_stride, e / nstages, k0, k1);
    tf_split(k0, k1, stages.id[e % nstages], k0, k1);
    tf_split(k0, k1, 0u, k0, k1);
    out[2 * e] = static_cast<long long>(k0);
    out[2 * e + 1] = static_cast<long long>(k1);
  }
}

// cols: dnu, dt, mod.  pows: (2, nchan) float32, x^-3.4 then x^1.2 of each
// channel's x = f / fcent.
__global__ void __launch_bounds__(kThreads)
scint_kernel(const long long* __restrict__ keys, long long key_stride,
             long long nobs, int nchan, int nsub,
             const float* __restrict__ pows, float c_lo, float inv_a,
             float fcent, float sublen, Cols cols, float* __restrict__ out) {
  const long long total = nobs * nchan * nsub;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / (static_cast<long long>(nchan) * nsub);
    const int c = static_cast<int>((e / nsub) % nchan);
    const int s = static_cast<int>(e % nsub);
    // cell_f: (fcent / dnu) (c_lo - x^-3.4) (1 / 3.4)
    const float dnu = clamp_min_nan(col(cols, 0, r), 0x1.0c6f7ap-20f);
    const float scale = __fdiv_rn(fcent, dnu);
    const float n_f =
        __fmul_rn(__fmul_rn(scale, __fsub_rn(c_lo, pows[c])), inv_a);
    // cell_t: the subint midpoint over dt x^1.2
    const float dt = clamp_min_nan(col(cols, 1, r), 0x1.0c6f7ap-20f);
    const float t_mid =
        __fmul_rn(__fadd_rn(static_cast<float>(s), 0.5f), sublen);
    const float n_t = __fdiv_rn(t_mid, __fmul_rn(dt, pows[nchan + c]));
    uint32_t k0, k1;
    key_of(keys, key_stride, r, k0, k1);
    tf_split(k0, k1, cell_id(n_f), k0, k1);
    tf_split(k0, k1, cell_id(n_t), k0, k1);
    const float g = exponential_of(k0, k1);
    const float m = clamp_nan(col(cols, 2, r), 0.0f, 1.0f);
    out[e] = fmaf(m, __fsub_rn(g, 1.0f), 1.0f);
  }
}

// cols: imp_prob, imp_snr, nb_prob, nb_snr, noise level (the last read
// only where scaled)
__global__ void __launch_bounds__(kThreads)
rfi_kernel(const long long* __restrict__ keys, long long key_stride,
           long long nobs, int nchan, int nsub,
           const long long* __restrict__ chan_ids, Cols cols, bool scaled,
           float* __restrict__ levels, bool* __restrict__ mask) {
  const long long total = nobs * nchan * nsub;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / (static_cast<long long>(nchan) * nsub);
    const int c = static_cast<int>((e / nsub) % nchan);
    const uint32_t s = static_cast<uint32_t>(e % nsub);
    uint32_t k0, k1, a0, a1, b0, b1;
    key_of(keys, key_stride, r, k0, k1);
    // the subint's burst: fold_in(k, 0), then 0 (selection) and 1 (energy)
    tf_split(k0, k1, 0u, a0, a1);
    tf_split(a0, a1, 0u, b0, b1);
    const bool burst = uniform01(word(b0, b1, s)) < col(cols, 0, r);
    tf_split(a0, a1, 1u, b0, b1);
    const float e_s = -xla_log1p(-uniform01(word(b0, b1, s)));
    // the channel's tone: fold_in(k, 1), its global channel id, then 0
    // (selection) and 1 (energy)
    tf_split(k0, k1, 1u, a0, a1);
    tf_split(a0, a1, static_cast<uint32_t>(chan_ids[c]), a0, a1);
    tf_split(a0, a1, 0u, b0, b1);
    const bool tone = uniform01(tf_bits(b0, b1)) < col(cols, 2, r);
    tf_split(a0, a1, 1u, b0, b1);
    const float e_c = exponential_of(b0, b1);
    const float imp =
        __fmul_rn(__fmul_rn(col(cols, 1, r), e_s), burst ? 1.0f : 0.0f);
    const float nb =
        __fmul_rn(__fmul_rn(col(cols, 3, r), e_c), tone ? 1.0f : 0.0f);
    float level = __fadd_rn(imp, nb);
    if (scaled) level = __fmul_rn(level, col(cols, 4, r));
    levels[e] = level;
    mask[e] = burst || tone;
  }
}

// mode 0 log-normal (param sigma), 1 power law (alpha), 2 FRB (amp);
// mult: (2^32 mod nsub) for the FRB's randint
__global__ void __launch_bounds__(kThreads)
energy_kernel(const long long* __restrict__ keys, long long key_stride,
              long long nobs, int nsub, int mode, unsigned mult, Cols cols,
              float* __restrict__ out) {
  const long long total = nobs * nsub;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / nsub;
    const uint32_t s = static_cast<uint32_t>(e % nsub);
    const float p = col(cols, 0, r);
    uint32_t k0, k1;
    key_of(keys, key_stride, r, k0, k1);
    float v;
    if (mode == 0) {
      // sigma sqrt(2) erf_inv(u) - (sigma/2) sigma, fused as XLA fuses it
      const float u = uniform_lo(word(k0, k1, s), -0x1.fffffep-1f);
      const float z = xla_erf_inv(u);
      const float half = __fmul_rn(__fmul_rn(0.5f, p), p);
      v = xla_exp(fmaf(__fmul_rn(p, 0x1.6a09e6p+0f), z, -half));
    } else if (mode == 1) {
      const float a = clamp_min_nan(p, 0x1.0ccccc0p+0f);  // 1.05
      const float u = uniform_lo(word(k0, k1, s), 0x1.ad7f2ap-24f);  // 1e-7
      const float pw = static_cast<float>(
          pow(static_cast<double>(u), static_cast<double>(__fdiv_rn(-1.0f, a))));
      v = __fdiv_rn(__fmul_rn(pw, __fsub_rn(a, 1.0f)), a);
    } else {
      // jax's randint(k, (), 0, nsub): one word from each half of the
      // split key, reduced modulo nsub through 2^32 mod nsub in uint32
      uint32_t h0, h1, l0, l1;
      tf_split(k0, k1, 0u, h0, h1);
      tf_split(k0, k1, 1u, l0, l1);
      const uint32_t n = static_cast<uint32_t>(nsub);
      const uint32_t hi = tf_bits(h0, h1) % n;
      const uint32_t lo = tf_bits(l0, l1) % n;
      const uint32_t j = (static_cast<uint32_t>(
                              static_cast<unsigned long long>(hi) * mult) +
                          lo) % n;
      v = __fmul_rn(p, j == s ? 1.0f : 0.0f);
    }
    out[e] = v;
  }
}

unsigned blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
}

// the host's arrays of column pointers and steps, as one kernel argument
bool cols_of(const void* const* ptrs, const long long* steps, int n,
             Cols& out) {
  if (n < 0 || n > kMaxCols) return false;
  for (int j = 0; j < kMaxCols; ++j) {
    out.p[j] = j < n ? static_cast<const float*>(ptrs[j]) : nullptr;
    out.step[j] = j < n ? steps[j] : 0;
  }
  return true;
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of the
// launch (0 = success).  keys: int64 key data on the device, observation r's
// two words at keys[r * key_stride] and keys[r * key_stride + 1]; cols:
// host arrays of device float32 pointers and their steps (0: one value for
// every observation, 1: one each); outputs contiguous, observation-major.

// stage keys (nobs, nstages, 2) int64 of the observation keys, for the
// stage numbers stages[0 .. nstages - 1] (a host array)
extern "C" int scenario_stage_launch(const void* keys, long long key_stride,
                                     long long nobs, int nstages,
                                     const unsigned* stages, void* out,
                                     void* stream) {
  if (nobs < 0 || nstages < 0 || nstages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Stages st;
  for (int j = 0; j < kMaxStages; ++j) st.id[j] = j < nstages ? stages[j] : 0u;
  const long long total = nobs * nstages;
  if (total == 0) return 0;
  stage_kernel<<<blocks_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), key_stride, nobs, nstages, st,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// gains (nobs, nchan, nsub) float32; cols dnu, dt, mod; pows (2, nchan)
extern "C" int scenario_scint_launch(const void* keys, long long key_stride,
                                     long long nobs, int nchan, int nsub,
                                     const void* pows, float c_lo, float inv_a,
                                     float fcent, float sublen,
                                     const void* const* cols,
                                     const long long* steps, void* out,
                                     void* stream) {
  Cols c;
  if (nobs < 0 || nchan < 0 || nsub < 0 || !cols_of(cols, steps, 3, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = nobs * nchan * nsub;
  if (total == 0) return 0;
  scint_kernel<<<blocks_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), key_stride, nobs, nchan, nsub,
      static_cast<const float*>(pows), c_lo, inv_a, fcent, sublen, c,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// levels (nobs, nchan, nsub) float32 and mask (same) bool; chan_ids (nchan)
// int64; cols imp_prob, imp_snr, nb_prob, nb_snr and, when ncols is 5, the
// noise level the levels are multiplied by
extern "C" int scenario_rfi_launch(const void* keys, long long key_stride,
                                   long long nobs, int nchan, int nsub,
                                   const void* chan_ids,
                                   const void* const* cols,
                                   const long long* steps, int ncols,
                                   void* levels, void* mask, void* stream) {
  Cols c;
  if (nobs < 0 || nchan < 0 || nsub < 0 || (ncols != 4 && ncols != 5) ||
      !cols_of(cols, steps, ncols, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = nobs * nchan * nsub;
  if (total == 0) return 0;
  rfi_kernel<<<blocks_for(total), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), key_stride, nobs, nchan, nsub,
      static_cast<const long long*>(chan_ids), c, ncols == 5,
      static_cast<float*>(levels), static_cast<bool*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// energies (nobs, nsub) float32; mode 0 log-normal, 1 power law, 2 FRB;
// cols: the mode's parameter
extern "C" int scenario_energy_launch(const void* keys, long long key_stride,
                                      long long nobs, int nsub, int mode,
                                      const void* const* cols,
                                      const long long* steps, void* out,
                                      void* stream) {
  Cols c;
  if (nobs < 0 || nsub <= 0 || mode < 0 || mode > 2 ||
      !cols_of(cols, steps, 1, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = nobs * nsub;
  if (total == 0) return 0;
  // jax's randint: ((2^16 mod n)^2 mod 2^32) mod n, 2^32 mod n
  const unsigned long long m16 = 65536ULL % static_cast<unsigned>(nsub);
  const unsigned mult = static_cast<unsigned>(
      ((m16 * m16) & 0xFFFFFFFFULL) % static_cast<unsigned>(nsub));
  energy_kernel<<<blocks_for(total), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), key_stride, nobs, nsub, mode, mult,
      c, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
