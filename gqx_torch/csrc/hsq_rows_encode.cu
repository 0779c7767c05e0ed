// Row-major HSQ encode on the CUDA cores (sm_90a), dims 1-256: per dim-wide
// row, the inner products with the K codewords in float32, code = argmax |p|
// (the first index on a tie) and u = p[code].  No route of ops/hsq_rows.py
// takes it any more: hsq_rows_encode_wide.cu replaced it for dims above 32.
// It stays as the baseline that chip_smoke.py and the tests call through
// its C entry (gqx_torch/scripts/rows_wide_probe.py::cuda_core_encode), to
// time it beside the wide route and hold that route's u to this kernel's.
//
// Replaces: gqx/ops/pallas_hsq.py::hsq_encode (_encode_kernel), which takes
// (tile, dim) x (dim, K) on the TPU's matrix unit at Precision.HIGHEST and
// the abs-argmax on the vector unit.  One launch covers every user's rows
// (gqx maps the single-user kernel over the users).
//
// What it computes: the raw float32 codebook and the row as it is (bf16
// rows widened exactly), products accumulated with fp32 FMAs in element
// order; argmax |p| with the first index winning, so p = [-3, 3] gives
// code 0 and u = -3; a zero row gives code 0 and u 0.
//
// What bounds it on the H100: operations.  Per row K*dim fp32 FMAs against
// dim*4 bytes read, on the CUDA cores (67 TFLOP/s); each FMA also reads its
// two operands from shared memory, and a thread's FMAs form one serial
// chain per codeword, so at dim 256 it runs far below its bound and slower
// than its plain version (PERF.md section 6).
//
// Design: one thread per row, the row in shared memory (padded to dim + 1
// floats against bank conflicts).  The codebook goes through shared memory
// in tiles of at most 32 KB, each thread carrying its running best |p|, p
// and index from tile to tile, so a codebook larger than shared memory
// works like a small one; every thread of a warp reads the same codeword (a
// broadcast).  The strict > of the running best keeps the first index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileBytes = 32 * 1024;
constexpr int kThreads = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TIn, typename TCode>
__global__ void hsq_rows_encode_kernel(
    const TIn* __restrict__ x, const float* __restrict__ codebook, int k,
    int dim, int tile_k, int64_t rows, float* __restrict__ u_out,
    TCode* __restrict__ codes_out) {
  extern __shared__ float smem[];
  float* cb = smem;                                   // (tile_k, dim)
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < rows;

  float* xs = cb + (size_t)tile_k * dim + (size_t)threadIdx.x * (dim + 1);
  if (live) {
    const TIn* row = x + r * dim;
    for (int t = 0; t < dim; ++t) xs[t] = widen(row[t]);
  }

  float best_abs = -1.0f, best_p = 0.0f;
  int best_i = 0;
  for (int k0 = 0; k0 < k; k0 += tile_k) {
    const int kt = k - k0 < tile_k ? k - k0 : tile_k;
    __syncthreads();  // the previous tile has been read by every thread
    const float* src = codebook + (size_t)k0 * dim;
    for (int i = threadIdx.x; i < kt * dim; i += blockDim.x) cb[i] = __ldg(src + i);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < kt; ++c) {
      const float* cw = cb + c * dim;
      float p = 0.0f;
      for (int t = 0; t < dim; ++t) p = fmaf(xs[t], cw[t], p);
      const float a = fabsf(p);
      if (a > best_abs) { best_abs = a; best_p = p; best_i = k0 + c; }
    }
  }
  if (live) {
    u_out[r] = best_p;
    codes_out[r] = (TCode)best_i;
  }
}

template <typename TIn, typename TCode>
int launch(const void* x, const float* codebook, int k, int dim, int64_t rows,
           float* u, void* codes, cudaStream_t stream) {
  auto kernel = hsq_rows_encode_kernel<TIn, TCode>;
  int tile_k = kTileBytes / (dim * (int)sizeof(float));
  if (tile_k < 1) tile_k = 1;
  if (tile_k > k) tile_k = k;
  const size_t smem = ((size_t)tile_k * dim + (size_t)kThreads * (dim + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), codebook, k, dim, tile_k, rows, u, static_cast<TCode*>(codes));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (rows, dim) contiguous, bf16 (x_bf16) or float32, every user's rows one
// after another; codebook: (k, dim) float32; u: (rows,) float32; codes:
// (rows,) uint8 (codes_u8, k <= 256) or int32.  1 <= dim <= 256.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// outside that.
int gqx_hsq_rows_encode(const void* x, int x_bf16, const float* codebook, int k, int dim,
                        int64_t rows, float* u, void* codes, int codes_u8, void* stream) {
  if (dim < 1 || dim > 256 || k < 1 || (codes_u8 && k > 256))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (codes_u8) return launch<__nv_bfloat16, uint8_t>(x, codebook, k, dim, rows, u, codes, s);
    return launch<__nv_bfloat16, int32_t>(x, codebook, k, dim, rows, u, codes, s);
  }
  if (codes_u8) return launch<float, uint8_t>(x, codebook, k, dim, rows, u, codes, s);
  return launch<float, int32_t>(x, codebook, k, dim, rows, u, codes, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
