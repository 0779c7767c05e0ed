// Gather-and-scale shared by hsq_decode.cu and hsq_rows_decode.cu:
//   out[r, :] = w(u[r]) * codebook[codes[r], :]      for r in [0, rows)
// where w is chosen at compile time by the including source:
//   kRaw       w = u                     (one fp32 product per element)
//   kBf16      w = bf16(u)
//   kBf16HiLo  two products, with bf16(u) and bf16(u - bf16(u)), then added
// The products and the addition are written with the _rn intrinsics so that
// the compiler contracts nothing: the result is the plain PyTorch version's,
// bit for bit.
//
// What bounds it on the H100: memory.  Per row it reads one code and one
// scale (5 to 8 bytes) and writes dim floats; the codebook (K * dim floats)
// stays in L1/L2.  Design: a work item is one 16-byte piece of one output
// row, consecutive threads take consecutive pieces, so every store is a
// coalesced float4 and the threads of one row read the same code and scale
// (a broadcast).  A block walks chunks of 1,024 rows; the division that
// maps a work item to its row is a 32-bit one inside the chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gqx {

enum Weight { kRaw = 0, kBf16 = 1, kBf16HiLo = 2 };

constexpr int kGatherRowsPerChunk = 1024;

__device__ __forceinline__ float gather_bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int WEIGHT>
__device__ __forceinline__ float gather_scale(float c, float wh, float wl) {
  if constexpr (WEIGHT == kBf16HiLo) {
    return __fadd_rn(__fmul_rn(c, wh), __fmul_rn(c, wl));
  } else {
    return __fmul_rn(c, wh);
  }
}

template <int WEIGHT, int VEC, typename TCode>
__global__ void __launch_bounds__(256) gather_scale_kernel(
    const TCode* __restrict__ codes, const float* __restrict__ u,
    const float* __restrict__ codebook, int dim, int64_t rows,
    float* __restrict__ out) {
  const unsigned per_row = (unsigned)(dim / VEC);
  const int64_t chunks = (rows + kGatherRowsPerChunk - 1) / kGatherRowsPerChunk;
  for (int64_t chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int64_t base = chunk * kGatherRowsPerChunk;
    const int64_t left = rows - base;
    const unsigned n_rows =
        left < kGatherRowsPerChunk ? (unsigned)left : (unsigned)kGatherRowsPerChunk;
    const unsigned items = n_rows * per_row;
    for (unsigned j = threadIdx.x; j < items; j += blockDim.x) {
      const unsigned local = j / per_row;
      const unsigned q = (j - local * per_row) * VEC;
      const int64_t r = base + local;
      const float w = u[r];
      float wh = w, wl = 0.0f;
      if constexpr (WEIGHT != kRaw) {
        wh = gather_bf16_round(w);
        if constexpr (WEIGHT == kBf16HiLo) wl = gather_bf16_round(w - wh);
      }
      const float* cw = codebook + (int64_t)codes[r] * dim + q;
      float* o = out + r * dim + q;
      if constexpr (VEC == 4) {
        const float4 c4 = __ldg(reinterpret_cast<const float4*>(cw));
        *reinterpret_cast<float4*>(o) = make_float4(
            gather_scale<WEIGHT>(c4.x, wh, wl), gather_scale<WEIGHT>(c4.y, wh, wl),
            gather_scale<WEIGHT>(c4.z, wh, wl), gather_scale<WEIGHT>(c4.w, wh, wl));
      } else {
        o[0] = gather_scale<WEIGHT>(__ldg(cw), wh, wl);
      }
    }
  }
}

// Launch on ``stream``; float4 pieces when dim and both float pointers allow
// them, single floats otherwise (any dim).  Returns cudaGetLastError().
template <int WEIGHT>
int launch_gather_scale(const void* codes, int codes_u8, const float* u,
                        const float* codebook, int dim, int64_t rows,
                        float* out, cudaStream_t stream) {
  if (rows == 0 || dim == 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (rows + kGatherRowsPerChunk - 1) / kGatherRowsPerChunk;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(codebook) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define GQX_GATHER(VEC, TC)                                               \
  gather_scale_kernel<WEIGHT, VEC, TC><<<(unsigned)blocks, 256, 0, stream>>>( \
      static_cast<const TC*>(codes), u, codebook, dim, rows, out)
  if (vec4) {
    if (codes_u8) GQX_GATHER(4, uint8_t); else GQX_GATHER(4, int32_t);
  } else {
    if (codes_u8) GQX_GATHER(1, uint8_t); else GQX_GATHER(1, int32_t);
  }
#undef GQX_GATHER
  return (int)cudaGetLastError();
}

}  // namespace gqx
