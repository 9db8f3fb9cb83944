// envelope_shift.cu — the Fourier shift's dispersion ramp and spectrum
// product in one pass, for Hopper.
//
// Replaces the traced-shift branch of psrsigsim_tpu/ops/shift.py's
// fourier_shift (an XLA fusion of ops/dfloat.py's error-free
// transformations, cos, sin and the complex product), which the port ran
// as ~34 eager torch passes over the whole (rows, n/2+1) spectrum.  For
// each output row r (one shift, one sample spacing, one spectrum row) and
// harmonic k:
//
//     (rhi, rlo)     = 1 / (n * dt)                  double-float reciprocal
//     (qhi, qlo)     = shift * (rhi, rlo)            double-float product
//     (chi, clo)     = k * (qhi, qlo)
//     theta          = -2pi * frac(chi + clo)        (float32 2pi)
//     out[r, k]      = spec[r, k] * (cos theta + i sin theta)
//
// Bits.  The torch chain (ops/envelope_shift.py::envelope_shift_plain)
// rounds every operation on its own.  Here each rounding is written out
// (__fmul_rn, __fadd_rn, __fsub_rn, __frcp_rn; the build's --fmad=false
// keeps everything else apart too) in the chain's order, so theta is the
// chain's bit for bit.  cosf/sinf are the CUDA math library's, as
// torch.cos/torch.sin call them for float32, and the product is
// c10::complex's as PyTorch's CUDA build compiles it: re = fma(a, c,
// -(b*d)), im = fma(a, d, b*c) (both checked against the card's torch in
// tests/test_torch_envelope_shift.py).
//
// Bound.  Per element the kernel reads 8 bytes of spectrum and writes 8
// and does ~33 float32 operations of its own, cosf and sinf (software
// routines: a range reduction and a polynomial, ~14 float32 operations
// each on this range), one int->float conversion and three floors; a
// row's ratio is formed once per thread.  At the multi-pulsar ensemble's
// rows (92 pulsars x 64 channels x 2049 harmonics plus 36 x 64 x 1025)
// that is 0.23 GB, ~0.07 ms of HBM at 3.35 TB/s against ~0.03 ms of
// arithmetic: bound by the bytes.
//
// Layout.  Output row r reads shifts[r] and dts[r] (the wrapper expands
// those two to the rows, a few bytes a row) and the spectrum row
// r % spec_rows: a spectrum shared over leading axes (one portrait, one
// DM per observation) is read in place, never copied.  Grid (rows,
// harmonic blocks); kThreads threads stride over a row's harmonics.
//
// Built with nvcc for sm_90a by psrsigsim_torch/ops/_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;        // harmonics a thread takes at least
constexpr float kSplitter = 4097.0f;  // Veltkamp, 2^12 + 1
constexpr float kNegTwoPi = -6.2831855f;  // -(float32 2pi)

__device__ __forceinline__ void veltkamp(float a, float& hi, float& lo) {
  const float c = __fmul_rn(kSplitter, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// p + e == a * b exactly (Dekker); (bh, bl) is b's Veltkamp split
__device__ __forceinline__ void two_prod(float a, float b, float bh, float bl,
                                         float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al;
  veltkamp(a, ah, al);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s,
                                              float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// the double-float product of an exact float a with (bhi, blo)
__device__ __forceinline__ void df_mul(float a, float bhi, float bh, float bl,
                                       float blo, float& hi, float& lo) {
  float p, e;
  two_prod(a, bhi, bh, bl, p, e);
  quick_two_sum(p, __fadd_rn(e, __fmul_rn(a, blo)), hi, lo);
}

// frac(hi + lo) in [0, 1) as one float
__device__ __forceinline__ float df_mod1(float hi, float lo) {
  const float frac = __fsub_rn(hi, floorf(hi));
  float s = __fadd_rn(frac, lo);
  const float bb = __fsub_rn(s, frac);
  const float e = __fadd_rn(__fsub_rn(frac, __fsub_rn(s, bb)),
                            __fsub_rn(lo, bb));
  s = __fsub_rn(s, floorf(s));
  const float out = __fadd_rn(s, e);
  return __fsub_rn(out, floorf(out));
}

// kTheta: write theta (float32) instead of the shifted spectrum; kept
// for the checks that hold theta itself to the torch chain's bits
template <bool kTheta>
__global__ void __launch_bounds__(kThreads)
envelope_shift_kernel(const float2* __restrict__ spec, long long spec_rows,
                      const float* __restrict__ shifts,
                      const float* __restrict__ dts, float rhi, float rlo,
                      void* __restrict__ out, int nh, int n) {
  const long long r = blockIdx.x;
  if (dts != nullptr) {
    // df_recip(n * dt): one Newton step on the rounded reciprocal
    const float period = __fmul_rn(static_cast<float>(n), dts[r]);
    const float rcp = __frcp_rn(period);
    float ph, pl, p, e;
    veltkamp(period, ph, pl);
    two_prod(rcp, period, ph, pl, p, e);
    quick_two_sum(rcp, __fmul_rn(__fsub_rn(__fsub_rn(1.0f, p), e), rcp),
                  rhi, rlo);
  }
  float qhi, qlo, rh, rl;
  veltkamp(rhi, rh, rl);
  df_mul(shifts[r], rhi, rh, rl, rlo, qhi, qlo);
  float qh, ql;
  veltkamp(qhi, qh, ql);
  const float2* row = spec + (r % spec_rows) * nh;
  for (int k = blockIdx.y * kThreads + threadIdx.x; k < nh;
       k += gridDim.y * kThreads) {
    float chi, clo;
    df_mul(static_cast<float>(k), qhi, qh, ql, qlo, chi, clo);
    const float theta = __fmul_rn(kNegTwoPi, df_mod1(chi, clo));
    if (kTheta) {
      static_cast<float*>(out)[r * nh + k] = theta;
    } else {
      const float c = cosf(theta);
      const float s = sinf(theta);
      const float2 v = row[k];
      static_cast<float2*>(out)[r * nh + k] =
          make_float2(__fmaf_rn(v.x, c, -__fmul_rn(v.y, s)),
                      __fmaf_rn(v.x, s, __fmul_rn(v.y, c)));
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// spec: spec_rows contiguous complex64 rows of nh = n/2 + 1 harmonics
// (unused with theta != 0); shifts: rows float32; dts: rows float32
// sample spacings, or null to take the reciprocal (rhi, rlo) of n * dt
// given on the host; out: a contiguous (rows, nh) complex64 buffer
// (float32 with theta != 0).
extern "C" int envelope_shift_launch(const void* spec, long long spec_rows,
                                     const void* shifts, const void* dts,
                                     float rhi, float rlo, void* out,
                                     int theta, long long rows, int nh, int n,
                                     void* stream) {
  if (rows < 0 || spec_rows <= 0 || nh <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads * kPerThread;
  int yblocks = (nh + per_block - 1) / per_block;
  if (yblocks > 65535) yblocks = 65535;
  const dim3 grid(static_cast<unsigned>(rows), yblocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float2*>(spec);
  const auto* sh = static_cast<const float*>(shifts);
  const auto* dt = static_cast<const float*>(dts);
  if (theta) {
    envelope_shift_kernel<true><<<grid, kThreads, 0, s>>>(
        sp, spec_rows, sh, dt, rhi, rlo, out, nh, n);
  } else {
    envelope_shift_kernel<false><<<grid, kThreads, 0, s>>>(
        sp, spec_rows, sh, dt, rhi, rlo, out, nh, n);
  }
  return static_cast<int>(cudaGetLastError());
}
