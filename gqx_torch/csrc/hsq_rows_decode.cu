// Row-major HSQ decode for Hopper (sm_90a): out[r, :] = u[r] * codebook[codes[r], :]
// in float32, for the (dim, K) outside the flat-layout kernels' envelope.
//
// Replaces: gqx/ops/pallas_hsq.py::hsq_decode (_decode_kernel), which builds
// the scaled one-hot per tile and contracts it with the codebook on the
// TPU's matrix unit at Precision.HIGHEST, so that the result equals the
// float32 gather.  Here it is that gather: one fp32 product per element, the
// raw (not bf16-rounded) codebook, u not rounded.
//
// What bounds it on the H100: memory, the dim floats written per row.  The
// design is hsq_gather.cuh's, with the kRaw weight.

#include "hsq_gather.cuh"

extern "C" {

// codes: (rows,) uint8 (codes_u8) or int32, values < k; u: (rows,) float32;
// codebook: (k, dim) float32; out: (rows, dim) float32.  Returns
// cudaGetLastError() after the launch.
int gqx_hsq_rows_decode(const void* codes, int codes_u8, const float* u,
                        const float* codebook, int dim, int64_t rows,
                        float* out, void* stream) {
  return gqx::launch_gather_scale<gqx::kRaw>(
      codes, codes_u8, u, codebook, dim, rows, out,
      static_cast<cudaStream_t>(stream));
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
