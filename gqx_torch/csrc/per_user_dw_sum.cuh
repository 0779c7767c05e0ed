// The ordered reduction shared by the routes of the per-user conv weight
// gradient (per_user_dw*.cu): where a user's images are
// cut into ranges, each range's partial sums land in their own slice and are
// added here in range order, so two runs give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// out[e] = part[0][e] + part[1][e] + ... in that order
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  int64_t n, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = part[e];
  for (int k = 1; k < splits; ++k) s += part[(int64_t)k * n + e];
  out[e] = s;
}

inline cudaError_t sum_splits(const float* part, int splits, int64_t n, float* out,
                              cudaStream_t stream) {
  const int threads = 256;
  sum_splits_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, splits, n, out);
  return cudaGetLastError();
}
