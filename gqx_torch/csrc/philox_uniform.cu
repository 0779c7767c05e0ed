// Counter-based uniforms for stochastic rounding on Hopper (sm_90a).
//
// Replaces: gqx/ops/pallas_rand.py::pallas_uniform (_uniform_kernel), which
// draws bits from the TPU's hardware PRNG.  Hopper has no such generator, so
// this is Philox4x32-10 (Salmon et al., SC'11) written into the kernel: a
// pure function of (key, counter), hence reproducible and identical, bit for
// bit, to the plain PyTorch version in gqx_torch/ops/rand.py.  Its bits are
// not the TPU's; parity with gqx is distributional, as it already is on the
// TPU (pallas_rand.py:13-19).
//
// Mapping: element e of the output takes word (e % 4) of the Philox block
// whose counter is (e / 4 + offset), split into (lo32, hi32, 0, 0); the key
// is the 64-bit seed split into (lo32, hi32).  Bits to float is the TPU
// kernel's: (bits >> 8) * 2^-24, a uniform on [0, 1).
//
// What bounds it on the H100: memory.  It writes 4 bytes per value and does
// ~25 integer operations per value (10 rounds of two 32x32 multiplies and
// xors per 4 values): 11.8M values (the ResNet-50 unit, 8 users) are 47 MB,
// ~14 us at 3.35 TB/s.
//
// Design: one thread per Philox block, four float stores; blocks stride
// over the output.  One launch covers every user's uniforms of a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(256) philox_uniform_kernel(
    float* __restrict__ out, int64_t n, uint32_t k0, uint32_t k1,
    uint64_t offset) {
  const int64_t blocks4 = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < blocks4;
       q += stride) {
    const uint64_t ctr = (uint64_t)q + offset;
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u), k0, k1);
    const int64_t e = q * 4;
    if (e + 3 < n) {
      // out is 16-byte aligned (fresh allocation) and e is a multiple of 4
      *reinterpret_cast<float4*>(out + e) =
          make_float4(to_unit(r.x), to_unit(r.y), to_unit(r.z), to_unit(r.w));
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; e + j < n; ++j) out[e + j] = to_unit(w[j]);
    }
  }
}

}  // namespace

extern "C" {

// out: (n,) float32, 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 without a launch for n == 0).
int gqx_philox_uniform(void* out, int64_t n, uint64_t seed, uint64_t offset,
                       void* stream) {
  if (n == 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  int64_t blocks = ((n + 3) / 4 + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 16;
  if (blocks > cap) blocks = cap;
  philox_uniform_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, (uint32_t)seed, (uint32_t)(seed >> 32),
      offset);
  return (int)cudaGetLastError();
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
