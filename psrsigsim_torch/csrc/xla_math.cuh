// xla_math.cuh — XLA's float32 arithmetic, as its CPU backend compiles
// it, for the port's Hopper kernels.
//
// The functions the JAX package's random draws are built on, written out
// operation for operation so that a kernel gives the bits of the port's
// host code (psrsigsim_torch/ops/stats.py, which writes out the same
// arithmetic in torch ops; DIVERGENCES P13, P21): XLA CPU's Cephes/Eigen
// log and log1p, Giles' single-precision erf_inv, jax's float32 uniform of
// 32 random bits, and the flush of a subnormal result.  The fused
// multiply-adds are explicit fmaf; every other operation rounds on its
// own, which holds only where the kernel is built with --fmad=false (as
// ops/_build.py builds every kernel).
//
// Included by gamma_field.cu (K9) and scenario_draws.cu (K10).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float as_float(uint32_t b) {
  return __uint_as_float(b);
}

// XLA CPU's float32 log (Cephes/Eigen): frexp, then a degree-8 polynomial;
// positive finite inputs (ops/stats.py::_log)
__device__ float xla_log(float x) {
  x = fmaxf(x, kFltMin);
  const uint32_t bits = __float_as_uint(x);
  float e = static_cast<float>(static_cast<int>((bits >> 23) & 0x1FFu) - 127) +
            1.0f;
  float m = as_float((bits & 0x807FFFFFu) | 0x3F000000u);
  const bool small = m < 0.707106781186547524f;
  e = e - (small ? 1.0f : 0.0f);
  m = (m - 1.0f) + (small ? m : 0.0f);
  const float m2 = m * m;
  const float m3 = m2 * m;
  float y = fmaf(m, 7.0376836292e-2f, -1.1514610310e-1f);
  float y1 = fmaf(m, -1.2420140846e-1f, 1.4249322787e-1f);
  float y2 = fmaf(m, 2.0000714765e-1f, -2.4999993993e-1f);
  y = fmaf(y, m, 1.1676998740e-1f);
  y1 = fmaf(y1, m, -1.6668057665e-1f);
  y2 = fmaf(y2, m, 3.3333331174e-1f);
  y = fmaf(y, m3, y1);
  y = fmaf(y, m3, y2);
  y = fmaf(y, m3, e * -2.12194440e-4f);
  m = m - m2 * 0.5f;
  m = m + y;
  return m + e * 0.693359375f;
}

// XLA CPU's float32 log1p (ops/stats.py::_log1p)
__device__ float xla_log1p(float x) {
  const float x2 = x * x;
  float num = 4.5270000862445199635215e-5f;
  num = fmaf(num, x, 4.9854102823193375972212e-1f);
  num = fmaf(num, x, 6.5787325942061044846969e0f);
  num = fmaf(num, x, 2.9911919328553073277375e1f);
  num = fmaf(num, x, 6.0949667980987787057556e1f);
  num = fmaf(num, x, 5.7112963590585538103336e1f);
  num = fmaf(num, x, 2.0039553499201281259648e1f);
  float den = 1.0f;
  den = fmaf(den, x, 1.5062909083469192043167e1f);
  den = fmaf(den, x, 8.3047565967967209469434e1f);
  den = fmaf(den, x, 2.2176239823732856465394e2f);
  den = fmaf(den, x, 3.0909872225312059774938e2f);
  den = fmaf(den, x, 2.1642788614495947685003e2f);
  den = fmaf(den, x, 6.0118660497603843919306e1f);
  float small = num / den;
  small = x + ((-0.5f * x2) + (x * x2) * small);
  return fabsf(x) < 0.41421356237309504880f ? small : xla_log(x + 1.0f);
}

// XLA's float32 erf_inv (Giles' polynomial; ops/stats.py::erf_inv)
__device__ float xla_erf_inv(float x) {
  const float w0 = -xla_log1p(-(x * x));
  const bool lt = w0 < 5.0f;
  const float w = lt ? w0 - 2.5f : sqrtf(w0) - 3.0f;
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = fmaf(p, w, lt ? 3.43273939e-07f : 0.000100950558f);
  p = fmaf(p, w, lt ? -3.5233877e-06f : 0.00134934322f);
  p = fmaf(p, w, lt ? -4.39150654e-06f : -0.00367342844f);
  p = fmaf(p, w, lt ? 0.00021858087f : 0.00573950773f);
  p = fmaf(p, w, lt ? -0.00125372503f : -0.0076224613f);
  p = fmaf(p, w, lt ? -0.00417768164f : 0.00943887047f);
  p = fmaf(p, w, lt ? 0.246640727f : 1.00167406f);
  p = fmaf(p, w, lt ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

// jax's float32 uniform in [0, 1) of 32 random bits
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return fmaxf(as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
}

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kFltMin ? 0.0f : x;
}

}  // namespace
