// Row-major HSQ encode for Hopper (sm_90a): per dim-wide row, the inner
// products with the K codewords in float32, code = argmax |p| (the first
// index on a tie) and u = p[code].  It serves the (dim, K) outside the
// flat-layout kernels' envelope: any dim, K up to any size.
//
// Replaces: gqx/ops/pallas_hsq.py::hsq_encode (_encode_kernel), which takes
// (tile, dim) x (dim, K) on the TPU's matrix unit at Precision.HIGHEST and
// the abs-argmax on the vector unit.  One launch covers every user's rows
// (gqx maps the single-user kernel over the users).
//
// What differs from hsq_encode.cu, and is kept: the codebook is the raw
// float32 one and the input is not rounded, so products are not exact and
// are accumulated with fp32 FMAs in element order; the selection is
// argmax |p| with the first index winning, so p = [-3, 3] gives code 0 and
// u = -3 (hsq_encode.cu's pos >= -neg rule gives code 1); a zero row gives
// code 0 and u 0.
//
// What bounds it on the H100: operations.  Per row K*dim fp32 FMAs (8,192
// at K=1024, dim=8) against dim*4 bytes read: with no bf16 shortcut allowed
// the work is the CUDA cores' (8 users x 2.94M rows x 8,192 FMA = 193 G FMA,
// 5.8 ms at 33.5 T FMA/s, against 0.28 ms for its 941 MB).
//
// Design: one thread per row, the row in registers for the common dims
// (4, 8, 16, 24, 32), read from shared memory for any other dim (slower:
// two shared loads per FMA, rows padded to dim + 1 floats against bank
// conflicts).  The codebook goes through shared memory in tiles of at most
// 32 KB, each thread carrying its running best |p|, p and index from tile to
// tile, so a codebook larger than shared memory (dim 16 x K 4096 = 256 KB)
// works like a small one; every thread of a warp reads the same codeword (a
// broadcast, float4 for the register path).  The strict > of the running
// best keeps the first index.  A block covers blockDim rows and reloads the
// tiles from L2, 32 KB per 256 rows at K=1024, dim=8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileBytes = 32 * 1024;
constexpr int kThreadsRegs = 256;     // DIM > 0: the row in registers
constexpr int kThreadsShared = 128;   // DIM == 0: the row in shared memory

// DIM > 0: compile-time dim; DIM == 0: ``dim`` at run time.
template <int DIM, typename TCode>
__global__ void hsq_rows_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ codebook, int k,
    int dim, int tile_k, int64_t rows, float* __restrict__ u_out,
    TCode* __restrict__ codes_out) {
  extern __shared__ float4 smem4[];
  float* cb = reinterpret_cast<float*>(smem4);       // (tile_k, dim)
  const int d = DIM > 0 ? DIM : dim;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < rows;

  float xr[DIM > 0 ? DIM : 1];
  float* xs = cb + (size_t)tile_k * d + (size_t)threadIdx.x * (d + 1);
  if (live) {
    const float* row = x + r * d;
    if constexpr (DIM > 0) {
#pragma unroll
      for (int t = 0; t < DIM; ++t) xr[t] = __ldg(row + t);
    } else {
      for (int t = 0; t < d; ++t) xs[t] = __ldg(row + t);
    }
  }

  float best_abs = -1.0f, best_p = 0.0f;
  int best_i = 0;
  for (int k0 = 0; k0 < k; k0 += tile_k) {
    const int kt = k - k0 < tile_k ? k - k0 : tile_k;
    __syncthreads();  // the previous tile has been read by every thread
    const float* src = codebook + (size_t)k0 * d;
    for (int i = threadIdx.x; i < kt * d; i += blockDim.x) cb[i] = __ldg(src + i);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < kt; ++c) {
      const float* cw = cb + c * d;
      float p = 0.0f;
      if constexpr (DIM > 0) {
#pragma unroll
        for (int t = 0; t < DIM; t += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(cw + t);
          p = fmaf(xr[t + 0], c4.x, p);
          p = fmaf(xr[t + 1], c4.y, p);
          p = fmaf(xr[t + 2], c4.z, p);
          p = fmaf(xr[t + 3], c4.w, p);
        }
      } else {
        for (int t = 0; t < d; ++t) p = fmaf(xs[t], cw[t], p);
      }
      const float a = fabsf(p);
      if (a > best_abs) { best_abs = a; best_p = p; best_i = k0 + c; }
    }
  }
  if (live) {
    u_out[r] = best_p;
    codes_out[r] = (TCode)best_i;
  }
}

template <int DIM, typename TCode>
int launch(const float* x, const float* codebook, int k, int dim, int64_t rows,
           float* u, void* codes, cudaStream_t stream) {
  auto kernel = hsq_rows_encode_kernel<DIM, TCode>;
  const int threads = DIM > 0 ? kThreadsRegs : kThreadsShared;
  int tile_k = kTileBytes / (dim * (int)sizeof(float));
  if (tile_k < 1) tile_k = 1;
  if (tile_k > k) tile_k = k;
  size_t smem = (size_t)tile_k * dim * sizeof(float);
  if (DIM == 0) smem += (size_t)threads * (dim + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (rows + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      x, codebook, k, dim, tile_k, rows, u, static_cast<TCode*>(codes));
  return (int)cudaGetLastError();
}

template <typename TCode>
int dispatch(const float* x, const float* codebook, int k, int dim,
             int64_t rows, float* u, void* codes, cudaStream_t s) {
  switch (dim) {
    case 4: return launch<4, TCode>(x, codebook, k, dim, rows, u, codes, s);
    case 8: return launch<8, TCode>(x, codebook, k, dim, rows, u, codes, s);
    case 16: return launch<16, TCode>(x, codebook, k, dim, rows, u, codes, s);
    case 24: return launch<24, TCode>(x, codebook, k, dim, rows, u, codes, s);
    case 32: return launch<32, TCode>(x, codebook, k, dim, rows, u, codes, s);
    default: return launch<0, TCode>(x, codebook, k, dim, rows, u, codes, s);
  }
}

}  // namespace

extern "C" {

// x: (rows, dim) float32, contiguous, every user's rows one after another;
// codebook: (k, dim) float32; u: (rows,) float32; codes: (rows,) uint8
// (codes_u8, k <= 256) or int32.  dim <= 256 when it is not one of the
// register-path dims.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape outside that.
int gqx_hsq_rows_encode(const float* x, const float* codebook, int k, int dim,
                        int64_t rows, float* u, void* codes, int codes_u8,
                        void* stream) {
  if (dim < 1 || dim > 256 || k < 1 || (codes_u8 && k > 256))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (codes_u8) return dispatch<uint8_t>(x, codebook, k, dim, rows, u, codes, s);
  return dispatch<int32_t>(x, codebook, k, dim, rows, u, codes, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
