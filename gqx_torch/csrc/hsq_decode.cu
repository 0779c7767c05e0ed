// HSQ per-user decode for Hopper (sm_90a): out[i, m*dim:(m+1)*dim] =
// w(u[i, m]) * codebook[codes[i, m]] for every user i and subvector m.
//
// Replaces: gqx/ops/pallas_hsq4.py::hsq_decode_flat (_decode_kernel) and its
// v3 generation gqx/ops/pallas_hsq3.py::hsq_decode_flat, which build a scaled
// one-hot (B*K, tile) per user and contract it with the expanded codebook on
// the TPU's matrix unit.  Exactly one entry of each one-hot column is not
// zero, so here it is a gather and a scale; the one-hot is not rebuilt.
//
// The TPU kernels' rounding of the scale is kept (pallas_hsq3.py::_dot_wt):
// the one-hot weight is cast to bf16 before the product, so passes=1 scales
// by bf16(u) and passes=2 by bf16(u) and bf16(u - bf16(u)) in two products
// that are then added.  The codebook is bf16-exact, so each product is exact
// in fp32 and the output equals the plain PyTorch version bit for bit.
//
// What bounds it on the H100: memory, the dim floats written per subvector
// (8 users x 1.47M subvectors x 64 B = 753 MB against 59 MB of signature
// read).  The design is hsq_gather.cuh's.

#include "hsq_gather.cuh"

extern "C" {

// codes: (rows,) uint8 (codes_u8) or int32, values < k; u: (rows,) float32,
// the dequantized scales; codebook: (k, dim) float32, bf16-exact; out:
// (rows, dim) float32; rows = users * m.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an unsupported passes.
int gqx_hsq_decode(const void* codes, int codes_u8, const float* u,
                   const float* codebook, int dim, int64_t rows, int passes,
                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 1)
    return gqx::launch_gather_scale<gqx::kBf16>(codes, codes_u8, u, codebook, dim, rows, out, s);
  if (passes == 2)
    return gqx::launch_gather_scale<gqx::kBf16HiLo>(codes, codes_u8, u, codebook, dim, rows, out, s);
  return (int)cudaErrorInvalidValue;
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
