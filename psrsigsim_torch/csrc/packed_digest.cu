// packed_digest.cu — per-observation digest of a packed chunk, for Hopper.
//
// Replaces the JAX package's device digest of the integrity lattice,
// psrsigsim_tpu/runtime/integrity.py::device_packed_digest_rows (an XLA
// fusion of _dev_words_u32 and _dev_fold_u32 over the packed transport,
// no Pallas kernel): for each observation b of the packed (B, nsub, C,
// nbin+4) int16 chunk the ensemble produces, the sum mod 2^32 of three
// positional folds
//
//     fold(w, salt) = sum_i ((w_i ^ m_i) * 0x9E3779B1 + m_i),
//     m_i = (i + salt) * 0x9E3779B1 + 0x85EBCA77         (all mod 2^32)
//
// over the data words (the int16 codes, sign-extended to uint32, i over
// the flattened (nsub, C, nbin) codes, salt 0), the DAT_SCL words (the two
// tail halves nbin, nbin+1 of a row joined little-endian into one uint32,
// i over the flattened (nsub, C) rows, salt 1<<20) and the DAT_OFFS words
// (halves nbin+2, nbin+3, salt 2<<20).  The digest covers the values as
// they sit in the buffer: under byte_order="big" the codes are the
// swapped halves, the tail stays native.
//
// Bound.  The function reads every byte of the chunk once and does ~3
// integer operations per word (XOR, the multiply-add of the term, the add
// into the sum; the position multipliers depend on the position only): at
// the main path's chunk (128 x 20 x 64 x 2052 int16, 673 MB) 0.20 ms of
// bytes at 3.35 TB/s against ~0.06 ms of integer issue, so it is bound by
// the bytes.  The kernel streams each row once with 8-byte loads (a warp
// reads 256 contiguous bytes), keeps one uint32 sum per thread, reduces
// the block by warp shuffles, and adds the block's sum into the
// observation's word with one atomicAdd.  Sums mod 2^32 are exact in any
// order, so the result is bit-equal to the plain version however the
// blocks are scheduled.
//
// Layout: grid (row blocks of one observation, observations); 8 warps per
// block, one row per warp at a time.  Rows are 8-byte aligned when nbin is
// a multiple of 4 and the buffer is; other shapes take 2-byte loads.
//
// Built with nvcc for sm_90a by psrsigsim_torch/ops/_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGold = 0x9E3779B1u;
constexpr uint32_t kOff = 0x85EBCA77u;
constexpr uint32_t kSaltScl = 1u << 20;
constexpr uint32_t kSaltOffs = 2u << 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 4 * kWarps;

__device__ __forceinline__ uint32_t term(uint32_t w, uint32_t i) {
  const uint32_t m = i * kGold + kOff;
  return (w ^ m) * kGold + m;
}

__device__ __forceinline__ uint32_t code(int16_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));  // sign-extended
}

__device__ __forceinline__ uint32_t halves(int16_t lo, int16_t hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
packed_digest_kernel(const int16_t* __restrict__ packed,
                     uint32_t* __restrict__ out, int rows, int nbin) {
  const int b = blockIdx.y;
  const int width = nbin + 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int16_t* obs = packed + static_cast<size_t>(b) * rows * width;
  const int r0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int r1 = min(rows, r0 + kRowsPerBlock);
  uint32_t acc = 0;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int16_t* row = obs + static_cast<size_t>(r) * width;
    const uint32_t i0 = static_cast<uint32_t>(r) * static_cast<uint32_t>(nbin);
    if (kVec) {
      // nbin % 4 == 0: units 0 .. nbin/4 - 1 are codes, the last the tail
      const short4* row4 = reinterpret_cast<const short4*>(row);
      const int units = nbin / 4;
#pragma unroll 4
      for (int u = lane; u < units; u += 32) {
        const short4 v = row4[u];
        const uint32_t i = i0 + 4u * static_cast<uint32_t>(u);
        acc += term(code(v.x), i) + term(code(v.y), i + 1u) +
               term(code(v.z), i + 2u) + term(code(v.w), i + 3u);
      }
    } else {
      for (int k = lane; k < nbin; k += 32) {
        acc += term(code(row[k]), i0 + static_cast<uint32_t>(k));
      }
    }
    if (lane == 0) {
      const uint32_t rr = static_cast<uint32_t>(r);
      acc += term(halves(row[nbin], row[nbin + 1]), rr + kSaltScl) +
             term(halves(row[nbin + 2], row[nbin + 3]), rr + kSaltOffs);
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ uint32_t part[kWarps];
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? part[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) atomicAdd(out + b, acc);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// packed: the first `count` observations of a contiguous (B, rows, nbin+4)
// int16 buffer on the device (rows = nsub * C); out: `count` ZEROED uint32
// words on the device, one digest per observation.
extern "C" int packed_digest_launch(const void* packed, void* out, int count,
                                    int rows, int nbin, void* stream) {
  if (count < 0 || rows < 0 || nbin < 0 || count > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0 || rows == 0) return 0;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, count);
  const auto* p = static_cast<const int16_t*>(packed);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nbin % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0) {
    packed_digest_kernel<true><<<grid, kThreads, 0, s>>>(p, o, rows, nbin);
  } else {
    packed_digest_kernel<false><<<grid, kThreads, 0, s>>>(p, o, rows, nbin);
  }
  return static_cast<int>(cudaGetLastError());
}
