// HSQ fused decode-mean for Hopper (sm_90a): the parameter server's mean
// over U users of u * codebook[code], computed once per subvector.
//
// Replaces: gqx/ops/pallas_hsq4.py::hsq_decode_mean (_decode_mean_kernel),
// which accumulates a scaled one-hot (B*K, tile) over the users and
// contracts it with the expanded codebook on the TPU's matrix unit.  Here it
// is a gather-accumulate: at most U codewords of the K contribute to a
// subvector, so the one-hot product is not rebuilt.
//
// The TPU kernel's weight rounding is reproduced (pallas_hsq4.py:176-184,
// pallas_hsq3.py:181-206): the weight of each distinct code is the sum of
// the u of the users who chose it, added in user order, times float(1/U);
// passes=1 rounds that weight to bf16, passes=2 splits it into bf16 hi + lo
// whose contributions are summed separately and then added.  With passes=1
// this is not the exact mean.  Products with the bf16-exact codebook are
// exact in fp32; only the order of the (at most U) fp32 additions can
// differ from the TPU's.
//
// What bounds it on the H100: memory.  Per subvector it reads U codes and U
// scales (5U bytes) and writes dim floats; the arithmetic is at most U*dim
// FMAs.  For the ResNet-50 unit (1.47M subvectors, U=8): ~59 MB read, 94 MB
// written, ~46 us at 3.35 TB/s.
//
// Design: one thread per subvector; codes and scales are read coalesced
// (user-major (U, M) layout, neighbouring threads on neighbouring m); the
// codebook sits in shared memory; the dim outputs are accumulated in
// registers and stored as float4.  A user whose code already appeared for
// an earlier user is skipped, so each distinct code is weighted once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int DIM, int PASSES, typename TCode>
__global__ void __launch_bounds__(256) hsq_decode_mean_kernel(
    const TCode* __restrict__ codes, const float* __restrict__ u,
    const float* __restrict__ codebook, int k, int users, int64_t m,
    float inv_users, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* cb = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < k * DIM; i += blockDim.x) cb[i] = codebook[i];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += stride) {
    float acc[DIM];
    float acc_lo[PASSES == 2 ? DIM : 1];
#pragma unroll
    for (int t = 0; t < DIM; ++t) {
      acc[t] = 0.0f;
      if constexpr (PASSES == 2) acc_lo[t] = 0.0f;
    }
    for (int i = 0; i < users; ++i) {
      const int ci = (int)codes[(int64_t)i * m + j];
      bool seen = false;
      for (int q = 0; q < i; ++q) seen |= (int)codes[(int64_t)q * m + j] == ci;
      if (seen) continue;
      float w = u[(int64_t)i * m + j];
      for (int q = i + 1; q < users; ++q) {
        if ((int)codes[(int64_t)q * m + j] == ci) w = w + u[(int64_t)q * m + j];
      }
      w = w * inv_users;
      const float wh = bf16_round(w);
      const float* cw = cb + ci * DIM;
#pragma unroll
      for (int t = 0; t < DIM; ++t) acc[t] = fmaf(wh, cw[t], acc[t]);
      if constexpr (PASSES == 2) {
        const float wl = bf16_round(w - wh);
#pragma unroll
        for (int t = 0; t < DIM; ++t) acc_lo[t] = fmaf(wl, cw[t], acc_lo[t]);
      }
    }
    float* o = out + j * DIM;
    if constexpr (PASSES == 2) {
#pragma unroll
      for (int t = 0; t < DIM; ++t) acc[t] = acc[t] + acc_lo[t];
    }
    if constexpr (DIM % 4 == 0) {
#pragma unroll
      for (int t = 0; t < DIM; t += 4)
        *reinterpret_cast<float4*>(o + t) =
            make_float4(acc[t], acc[t + 1], acc[t + 2], acc[t + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < DIM; ++t) o[t] = acc[t];
    }
  }
}

template <int DIM, int PASSES, typename TCode>
int launch(const void* codes, const float* u, const float* codebook, int k,
           int users, int64_t m, float* out, cudaStream_t stream) {
  auto kernel = hsq_decode_mean_kernel<DIM, PASSES, TCode>;
  const size_t smem = (size_t)k * DIM * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  int64_t blocks = (m + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const TCode*>(codes), u, codebook, k, users, m,
      1.0f / (float)users, out);
  return (int)cudaGetLastError();
}

template <int DIM>
int dispatch(const void* codes, int codes_u8, const float* u,
             const float* codebook, int k, int users, int64_t m, int passes,
             float* out, cudaStream_t s) {
  if (passes == 1) {
    if (codes_u8) return launch<DIM, 1, uint8_t>(codes, u, codebook, k, users, m, out, s);
    return launch<DIM, 1, int32_t>(codes, u, codebook, k, users, m, out, s);
  }
  if (codes_u8) return launch<DIM, 2, uint8_t>(codes, u, codebook, k, users, m, out, s);
  return launch<DIM, 2, int32_t>(codes, u, codebook, k, users, m, out, s);
}

}  // namespace

extern "C" {

// codes: (users, m) uint8 (codes_u8) or int32; u: (users, m) float32, the
// dequantized scales; codebook: (k, dim) float32, bf16-exact; out: (m * dim)
// float32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported dim/passes.
int gqx_hsq_decode_mean(const void* codes, int codes_u8, const float* u,
                        const float* codebook, int k, int dim, int users,
                        int64_t m, int passes, float* out, void* stream) {
  if (passes != 1 && passes != 2) return (int)cudaErrorInvalidValue;
  if (m == 0 || users == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 4: return dispatch<4>(codes, codes_u8, u, codebook, k, users, m, passes, out, s);
    case 8: return dispatch<8>(codes, codes_u8, u, codebook, k, users, m, passes, out, s);
    case 16: return dispatch<16>(codes, codes_u8, u, codebook, k, users, m, passes, out, s);
    case 32: return dispatch<32>(codes, codes_u8, u, codebook, k, users, m, passes, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
