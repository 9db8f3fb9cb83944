// gamma_field.cu — jax.random.gamma's draws, bit for bit, for Hopper.
//
// Replaces jax.random.gamma as the JAX package calls it for its exact chi^2
// branch, psrsigsim_tpu/ops/stats.py:50-52 (_exact_chi2: 2 * gamma(key,
// df/2)), reached from chi2_sample, blocked_chan_chi2 and chan_chi2_field
// for a static df below 50 (other than 1) and everywhere under
// PSS_EXACT_CHI2=1.  That is not a Pallas kernel: XLA compiles it to a
// batched while loop (jax/_src/random.py::_gamma_impl, _gamma_one).
//
// What it computes.  Rows of (key, alpha, n): element j of row r is
// scale * gamma(alpha_r) drawn from key i = start + j of
// split(key_r, N) (jax's partitionable threefry: both words of counter
// i).  Per element, Marsaglia-Tsang as _gamma_one runs it: alpha < 1 is
// boosted to alpha + 1; key, subkey = split(key); rejection passes of
// key, kx, ku = split(key, 3), an inner loop kx, k = split(kx), x =
// normal(k), v = fma(x, c, 1) while v <= 0, U = uniform(ku), until U <
// fma(-X*X, 0.0331, 1) or log U < X/2 + d*((1 - V) + log V) with X = x^2,
// V = v^3; the draw is d*V, times (1 - uniform(subkey))^(1/alpha) for a
// boosted alpha.  The arithmetic is what XLA's CPU backend compiles
// (psrsigsim_torch/DIVERGENCES.md P21): the normal is sqrt(2) * erf_inv(u)
// with XLA's single-precision erf_inv (its log1p and log polynomials), the
// fused multiply-adds exactly where XLA contracts them (fmaf), every other
// operation rounded on its own (--fmad=false), IEEE sqrtf and division,
// the boost's power glibc's powf (which XLA's CPU code calls; a static
// power of 2 or 3 XLA rewrites as products), subnormal results flushed as
// XLA's CPU code does.  The per-row constants d, c and 1/alpha
// come from the wrapper (ops/stats.py::gamma_consts, which knows whether
// XLA folded them for a static alpha or computed them for a traced one),
// so the kernel and its plain version (ops/stats.py::gamma_plain) share
// them.  The stream is jax's, not a new one.
//
// Bound.  Instruction issue: the output needs, per element, one
// threefry2x32 for its key and one for the first pass's key; per rejection
// pass three (kx, ku, U's bits) and one more after a rejection; per inner
// pass two (the normal's key and bits) and one more after a repeat; two
// for a boosted alpha's uniform: 1 + 3 a pass + 3 an inner pass + 2 a
// boost, about 7 calls at alpha >= 1, at 73 integer operations a call
// (threefry.cuh), plus ~120 float32 operations: some 640 operations an
// element against 4 bytes written.  ptxas issues part of the integer adds
// on the FMA pipe (IMAD), so the integer pipe's 64 a clock is no limit;
// the issue rate, 128 operations an SM a clock, is: ~19 ps an element, the
// bytes ~1.2 ps.
//
// Design: one thread per element, both loops in registers, a grid-stride
// loop over the (rows x n) elements.  Threads of a warp whose elements
// take another number of passes wait for each other (a simple kernel; the
// acceptance rate is above 95% for alpha >= 1).
//
// Built with nvcc for sm_90a, --fmad=false, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

using namespace pss;

constexpr int kThreads = 256;
// log with XLA's log(0) = -inf (ops/stats.py::_log0)
__device__ __forceinline__ float xla_log0(float x) {
  return x == 0.0f ? -__int_as_float(0x7F800000) : xla_log(x);
}

// jax.random.normal of one key: sqrt(2) * erf_inv(u), u uniform on
// (nextafter(-1, 0), 1): fma(f - 1, 2, lo) clamped at lo
__device__ __forceinline__ float normal_of(uint32_t k0, uint32_t k1) {
  const float lo = -0.99999994f;
  const float f = as_float((tf_bits(k0, k1) >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(lo, fmaf(f, 2.0f, lo));
  return 1.41421354f * xla_erf_inv(u);
}

// glibc's float32 powf (its FMA build), the function XLA's CPU code calls
// for a float32 power, for positive normal x and y > 0 with x^y <= 1
// (ops/stats.py::powf).  tab: glibc's __powf_log2_data (16 x (1/c,
// log2 c), then the degree-5 polynomial: 37 doubles) and __exp2f_data (32
// table words, the shift 0x1.8p+52/32, the degree-3 polynomial: 36).
__device__ float glibc_powf(float x, float y, const double* __restrict__ tab) {
  const uint32_t ix = __float_as_uint(x);
  const uint32_t tmp = ix - 0x3F330000u;
  const int i = static_cast<int>((tmp >> 19) & 15u);
  const uint32_t top = tmp & 0xFF800000u;
  const uint32_t iz = ix - top;
  const int k = static_cast<int32_t>(top) >> 23;
  const double z = static_cast<double>(__uint_as_float(iz));
  const double* a = tab + 32;
  const double r = fma(z, tab[2 * i], -1.0);
  const double y0 = tab[2 * i + 1] + static_cast<double>(k);
  const double yy = fma(r, a[0], a[1]);
  const double p = fma(r, a[2], a[3]);
  const double r2 = r * r;
  double q = fma(r, a[4], y0);
  const double r4 = r2 * r2;
  q = fma(r2, p, q);
  const double ylogx = static_cast<double>(y) * fma(yy, r4, q);
  if (ylogx <= -150.0) return 0.0f;  // glibc's underflow branch
  const double* e = tab + 37;
  double kd = ylogx + e[32];
  const unsigned long long ki =
      static_cast<unsigned long long>(__double_as_longlong(kd));
  kd -= e[32];
  const double rr = ylogx - kd;
  const unsigned long long t =
      static_cast<unsigned long long>(__double_as_longlong(e[ki & 31])) +
      (ki << 47);
  const double s = __longlong_as_double(static_cast<long long>(t));
  const double zz = fma(rr, e[33], e[34]);
  const double rr2 = rr * rr;
  double yv = fma(rr, e[35], 1.0);
  yv = fma(zz, rr2, yv) * s;
  return flush(static_cast<float>(yv));
}

__device__ float gamma_one(uint32_t k0, uint32_t k1, float alpha, float d,
                           float c, float inv_alpha, bool traced, bool cube,
                           const double* __restrict__ powf_tab) {
  // jax derives key, subkey = split(k) and, each pass, key, kx, ku =
  // split(key, 3) and kx, k = split(kx); a split key is derived here only
  // where the draw reads it (the subkey for a boosted alpha, the next key
  // after a rejection, the next kx after v <= 0): the same stream
  uint32_t key0, key1;
  tf_split(k0, k1, 0u, key0, key1);
  float V;
  for (;;) {
    uint32_t x0, x1, u0, u1;
    tf_split(key0, key1, 1u, x0, x1);
    float x, v;
    for (;;) {
      uint32_t w0, w1;
      tf_split(x0, x1, 1u, w0, w1);
      x = normal_of(w0, w1);
      v = fmaf(x, c, 1.0f);
      if (v > 0.0f) break;
      tf_split(x0, x1, 0u, x0, x1);
    }
    const float X = x * x;
    V = (v * v) * v;
    tf_split(key0, key1, 2u, u0, u1);
    const float U = uniform01(tf_bits(u0, u1));
    const bool reject =
        (U >= fmaf(-(X * X), 0.0331f, 1.0f)) &&
        (xla_log0(U) >= X * 0.5f + d * ((1.0f - V) + xla_log0(V)));
    if (!reject) break;
    tf_split(key0, key1, 0u, key0, key1);
  }
  if (cube) return V;
  float out = d * V;
  if (alpha < 1.0f) {
    uint32_t sub0, sub1;
    tf_split(k0, k1, 1u, sub0, sub1);
    const float s = 1.0f - uniform01(tf_bits(sub0, sub1));
    float pw;
    if (!traced && inv_alpha == 2.0f) {
      pw = s * s;  // XLA rewrites a constant power 2 or 3 as products
    } else if (!traced && inv_alpha == 3.0f) {
      pw = (s * s) * s;
    } else {
      pw = glibc_powf(s, inv_alpha, powf_tab);
    }
    out = flush(out * pw);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
gamma_field_kernel(const uint32_t* __restrict__ keys,
                   const float4* __restrict__ params,
                   const double* __restrict__ powf_tab, float* __restrict__ out,
                   long long rows, long long n, long long start, float scale,
                   bool traced, bool cube) {
  const long long total = rows * n;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / n;
    const unsigned long long i =
        static_cast<unsigned long long>(start + (e - r * n));
    uint32_t k0, k1;
    threefry2x32(keys[2 * r], keys[2 * r + 1], static_cast<uint32_t>(i >> 32),
                 static_cast<uint32_t>(i), k0, k1);
    const float4 p = params[r];  // alpha, d, c, 1/alpha
    const float g = gamma_one(k0, k1, p.x, p.y, p.z, p.w, traced, cube,
                              powf_tab);
    out[e] = cube ? g : g * scale;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// keys (rows, 2) int32 key-data words, params (rows, 4) float32 (alpha, d,
// c, 1/alpha), powf_tab (73,) float64 (glibc_powf), out (rows, n)
// float32, all contiguous on the device; element j of row r draws key
// start + j of the row's split.  flags bit 0: a traced alpha's power
// (never rewritten as products); bit 1: store the accepted V = v^3 instead
// of scale * gamma (alpha >= 1 only).
extern "C" int gamma_field_launch(const void* keys, const void* params,
                                  const void* powf_tab, void* out,
                                  long long rows, long long n, long long start,
                                  float scale, int flags, void* stream) {
  if (rows < 0 || n < 0 || start < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = rows * n;
  if (total == 0) return 0;
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
  gamma_field_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float4*>(params),
      static_cast<const double*>(powf_tab), static_cast<float*>(out), rows, n,
      start, scale, (flags & 1) != 0, (flags & 2) != 0);
  return static_cast<int>(cudaGetLastError());
}
