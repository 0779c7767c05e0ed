// Device helpers shared by the hand-written kernels: a division for the
// small indices of a staged tile, the transposing shared-memory load of the
// per-user conv weight gradient's tensor-core kernels, and the split of a
// float32 value into three exact bf16 pieces that the tensor-core kernels on
// float32 values (hsq_rows_encode_tc.cu, per_user_dw_tc_f32.cu) share with
// ops/hsq_prep.py::split_bf16_3.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// floor(n / d) for n < 2^16 by a multiply-high (exact there for every d).
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int d_)
      : d((unsigned)d_), m(d_ > 1 ? 0xFFFFFFFFu / (unsigned)d_ + 1u : 0u) {}
  __device__ __forceinline__ int div(int n) const {
    return d > 1 ? (int)__umulhi((unsigned)n, m) : n;
  }
};

// Four 8x8 bf16 matrices from shared memory, transposed.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// The three exact pieces of two values, as packed bf16 pairs: h the value
// rounded to bf16, m the rest rounded to bf16, l what is left (v = h + m + l
// exactly for |v| from 2^-110 up to the largest bf16, and for 0).
// Each piece is rounded once, both values by one packed conversion, and
// read back as float32 from its bf16 halves.
__device__ __forceinline__ void split3(float v0, float v1, unsigned (&w)[3]) {
  w[0] = pack_bf16(v0, v1);
  const float r0 = v0 - __uint_as_float(w[0] << 16);            // exact
  const float r1 = v1 - __uint_as_float(w[0] & 0xFFFF0000u);
  w[1] = pack_bf16(r0, r1);
  w[2] = pack_bf16(r0 - __uint_as_float(w[1] << 16),            // exact, bf16-representable
                   r1 - __uint_as_float(w[1] & 0xFFFF0000u));
}
