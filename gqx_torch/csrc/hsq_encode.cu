// HSQ encode for Hopper (sm_90a): per user and per dim-wide subvector row,
// the inner products with the K codewords and the selection of the signed
// product of largest magnitude.
//
// Replaces: gqx/ops/pallas_hsq4.py::hsq_encode_flat (_encode_kernel, _select),
// the TPU kernel that contracts a block-diagonal (128, B*K) expansion of the
// codebook on the matrix unit.  That expansion exists only for the TPU's
// 128-lane layout and is not rebuilt here.
//
// What it computes, bit for bit where the arithmetic allows:
//   x is rounded as the TPU kernel rounds it: passes=1 -> bf16(x);
//   passes=2 -> bf16(x) and bf16(x - bf16(x)) contracted separately and
//   added (about 16 mantissa bits, not full fp32).  The codebook is
//   bf16-exact, so every product is exact in fp32; sums are fp32.
//   Selection (pallas_hsq4.py:40-51): pos = max p, neg = min p,
//   u = pos if pos >= -neg else neg, code = first index whose p equals u.
//   A zero row gives code 0 and u 0.
//
// What bounds it on the H100: per row, K*dim fused multiply-adds (4,096 at
// K=256, dim=16) against dim*2 bytes read (bf16 input), i.e. ~256 FMA per
// byte on the CUDA cores: the fp32 pipe, not memory, is the limit
// (8 users x 1.47M rows x 4,096 FMA = 48 G FMA at 33.5 T FMA/s ~ 1.4 ms).
// The same work on the bf16 tensor cores would be bandwidth-bound.
//
// Design: one thread per row, the codebook in shared memory (K*dim*4 bytes,
// 16 KB at K=256, dim=16), read as float4 broadcasts (every thread of a warp
// reads the same codeword), the row kept in registers, the running max/min
// and their first indices tracked in the k loop, so the selection is fused
// and the (rows, K) product never leaves registers.  Blocks stride over the
// rows, so each block loads the codebook once.  A wgmma/TMA version is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int DIM>
__device__ __forceinline__ float dot_row(const float* x, const float* c) {
  float p = 0.0f;
  if constexpr (DIM % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DIM; t += 4) {
      const float4 c4 = *reinterpret_cast<const float4*>(c + t);
      p = fmaf(x[t + 0], c4.x, p);
      p = fmaf(x[t + 1], c4.y, p);
      p = fmaf(x[t + 2], c4.z, p);
      p = fmaf(x[t + 3], c4.w, p);
    }
  } else {
#pragma unroll
    for (int t = 0; t < DIM; ++t) p = fmaf(x[t], c[t], p);
  }
  return p;
}

template <int DIM, int PASSES, typename TIn, typename TCode>
__global__ void __launch_bounds__(256) hsq_encode_kernel(
    const TIn* __restrict__ x, const float* __restrict__ codebook, int k,
    int64_t rows, float* __restrict__ u_out,
    TCode* __restrict__ codes_out) {
  extern __shared__ float4 smem4[];
  float* cb = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < k * DIM; i += blockDim.x) cb[i] = codebook[i];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    // row r = user * m + row of that user; every user's unit is contiguous
    // and m * DIM long, so row r starts at element r * DIM
    const TIn* xr = x + r * DIM;
    float xh[DIM];
    float xl[PASSES == 2 ? DIM : 1];
#pragma unroll
    for (int t = 0; t < DIM; ++t) {
      const float v = to_float(xr[t]);
      xh[t] = bf16_round(v);
      if constexpr (PASSES == 2) xl[t] = bf16_round(v - xh[t]);
    }
    float best_max = -__int_as_float(0x7f800000), best_min = __int_as_float(0x7f800000);
    int imax = 0, imin = 0;
    for (int c = 0; c < k; ++c) {
      const float* cw = cb + c * DIM;
      float p = dot_row<DIM>(xh, cw);
      if constexpr (PASSES == 2) p = p + dot_row<DIM>(xl, cw);
      if (p > best_max) { best_max = p; imax = c; }
      if (p < best_min) { best_min = p; imin = c; }
    }
    const bool take_pos = best_max >= -best_min;
    u_out[r] = take_pos ? best_max : best_min;
    codes_out[r] = (TCode)(take_pos ? imax : imin);
  }
}

template <int DIM, int PASSES, typename TIn, typename TCode>
int launch(const void* x, const float* codebook, int k, int64_t rows, float* u,
           void* codes, cudaStream_t stream) {
  auto kernel = hsq_encode_kernel<DIM, PASSES, TIn, TCode>;
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
  int64_t blocks = (rows + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const TIn*>(x), codebook, k, rows, u,
      static_cast<TCode*>(codes));
  return (int)cudaGetLastError();
}

template <int DIM>
int dispatch(const void* x, int x_bf16, const float* codebook, int k,
             int64_t rows, int passes, float* u, void* codes,
             int codes_u8, cudaStream_t s) {
#define GQX_ENC(P, TI, TC) return launch<DIM, P, TI, TC>(x, codebook, k, rows, u, codes, s)
  if (passes == 1) {
    if (x_bf16) { if (codes_u8) GQX_ENC(1, __nv_bfloat16, uint8_t); GQX_ENC(1, __nv_bfloat16, int32_t); }
    if (codes_u8) GQX_ENC(1, float, uint8_t);
    GQX_ENC(1, float, int32_t);
  }
  if (x_bf16) { if (codes_u8) GQX_ENC(2, __nv_bfloat16, uint8_t); GQX_ENC(2, __nv_bfloat16, int32_t); }
  if (codes_u8) GQX_ENC(2, float, uint8_t);
  GQX_ENC(2, float, int32_t);
#undef GQX_ENC
}

}  // namespace

extern "C" {

// x: (users, m * dim) contiguous, float32 or bf16 (x_bf16); codebook:
// (k, dim) float32, bf16-exact; u: (users, m) float32; codes: (users, m)
// uint8 (codes_u8) or int32.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for an unsupported dim/passes.
int gqx_hsq_encode(const void* x, int x_bf16, const float* codebook, int k,
                   int dim, int64_t users, int64_t m, int passes, float* u,
                   void* codes, int codes_u8, void* stream) {
  if (passes != 1 && passes != 2) return (int)cudaErrorInvalidValue;
  const int64_t rows = users * m;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 4: return dispatch<4>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    case 8: return dispatch<8>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    case 16: return dispatch<16>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    case 32: return dispatch<32>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
