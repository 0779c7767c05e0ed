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
// scales (5U bytes with uint8 codes) and writes dim floats; the arithmetic
// is at most U*dim FMAs.  For the ResNet-50 unit (1.47M subvectors of 16,
// U=8): 59 MB read, 94 MB written, 46 us at 3.35 TB/s.  The loads are small
// and the stores large, so the design is about bytes in flight and whole
// lines written:
//
// - A lane owns S consecutive subvectors (S * dim = 32 floats at passes=1,
//   16 at passes=2, S <= 4: 2 at P1's dim 16) and issues every user's loads
//   before any arithmetic: per user one load of its S codes and one of its
//   S scales.  At U = 8, the count of P1 and P5, the user count is a
//   template constant: the duplicate test is unrolled over registers, and
//   the next tile's 16 loads are issued before this tile's arithmetic.
//   Other counts take the same kernel with a runtime loop, whose duplicate
//   test re-reads the codes from the cache.
// - Vector loads need M and the rows' starts aligned to S elements; where
//   they are not, and for the last lane's subvectors past M, the lane loads
//   element by element (the same arithmetic, tested at M = 517 and 4,099).
// - Each distinct code is weighted once, in order of first appearance; the
//   codebook sits in shared memory as float32, read as float4, its rows
//   padded so that the lanes' random codewords spread over the banks.
// - The outputs leave through shared memory: a lane writes its S*dim
//   floats there, then the warp stores its 32*S*dim contiguous floats with
//   consecutive lanes on consecutive 16 bytes (stored from the registers, a
//   warp's float4 stores touched 32 addresses dim*4 bytes apart).
// - Blocks of 8 warps, as many as fit the multiprocessors at once, walk
//   over the warp tiles in a grid-stride loop, so the codebook is staged
//   once per block, 8 loads in flight per thread.
//
// Where the time goes at P1's shape (scripts/decode_mean_probe.py, variants
// of this source; PERF.md): the loads alone take about the bound's time
// again, at 64 bytes of codes and 256 of scales per user row and warp
// request; the gather from the codebook and the stores add to that rather
// than hide behind it.  Without the padding the gather's bank conflicts took
// most of the time (16-deep at dim 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFastUsers = 8;   // the user count of the training paths

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// S, the subvectors a lane owns, and ROW, the floats per lane in the
// staging of the outputs: padded by a float4, so that 8 lanes' float4
// writes fall into 8 distinct bank groups
// floats per codeword in shared memory.  A lane reads its codeword a float4
// at a time, all lanes the same float4 of theirs at once: unpadded, the
// codewords of dim 16 start in 2 of the 8 four-bank groups (dim 32 in 1),
// so the 32 lanes' loads queued 16-deep (32-deep); a float4 of padding
// spreads them over all 8, about 7 deep for random codes.  Dim 4 needs
// none: a codeword is one float4.
template <int DIM>
struct Book {
  static constexpr int PITCH = DIM == 4 ? DIM : DIM + 4;
};

template <int DIM, int PASSES>
struct Lane {
  static constexpr int kRaw = (PASSES == 1 ? 32 : 16) / DIM;
  static constexpr int S = kRaw > 4 ? 4 : (kRaw < 1 ? 1 : kRaw);
  static constexpr int ROW = S * DIM + 4;
};

template <int BYTES> struct Word;
template <> struct Word<1> { using T = unsigned char; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// v[s] = row[m0 + s] for s < S: one load where `vec` (M and the row start
// aligned to S elements) and all S lie before m; else one element a load,
// zero past m.
template <typename T, int S>
__device__ __forceinline__ void load_run(T (&v)[S], const T* row, int64_t m0, int64_t m,
                                         bool vec) {
  if (vec && m0 + S <= m) {
    union {
      typename Word<sizeof(T) * S>::T w;
      T e[S];
    } p;
    p.w = __ldg(reinterpret_cast<const typename Word<sizeof(T) * S>::T*>(row + m0));
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p.e[s];
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = m0 + s < m ? __ldg(row + m0 + s) : T(0);
  }
}

// The mean of one subvector into dst[0, DIM): `nu` users (NU when NU > 0),
// code(q) and scale(q) the code and u of user q.
template <int DIM, int PASSES, int NU, class Code, class Scale>
__device__ __forceinline__ void mean_of(float* dst, int nu, const Code& code, const Scale& scale,
                                        const float* cb, float inv_users) {
  const int n = NU > 0 ? NU : nu;
  float acc[DIM];
  float lo[PASSES == 2 ? DIM : 1];
#pragma unroll
  for (int t = 0; t < DIM; ++t) {
    acc[t] = 0.0f;
    if constexpr (PASSES == 2) lo[t] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const int ci = code(i);
    bool first = true;
#pragma unroll
    for (int q = 0; q < i; ++q) first = first && code(q) != ci;
    if (!first) continue;
    float w = scale(i);
#pragma unroll
    for (int q = i + 1; q < n; ++q) w = code(q) == ci ? w + scale(q) : w;
    w = w * inv_users;
    const float wh = bf16_round(w);
    const float wl = PASSES == 2 ? bf16_round(w - wh) : 0.0f;
    const float4* cw = reinterpret_cast<const float4*>(cb + ci * Book<DIM>::PITCH);
#pragma unroll
    for (int t = 0; t < DIM; t += 4) {
      const float4 c = cw[t / 4];
      acc[t] = fmaf(wh, c.x, acc[t]);
      acc[t + 1] = fmaf(wh, c.y, acc[t + 1]);
      acc[t + 2] = fmaf(wh, c.z, acc[t + 2]);
      acc[t + 3] = fmaf(wh, c.w, acc[t + 3]);
      if constexpr (PASSES == 2) {
        lo[t] = fmaf(wl, c.x, lo[t]);
        lo[t + 1] = fmaf(wl, c.y, lo[t + 1]);
        lo[t + 2] = fmaf(wl, c.z, lo[t + 2]);
        lo[t + 3] = fmaf(wl, c.w, lo[t + 3]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < DIM; t += 4) {
    if constexpr (PASSES == 2) {
      *reinterpret_cast<float4*>(dst + t) = make_float4(
          acc[t] + lo[t], acc[t + 1] + lo[t + 1], acc[t + 2] + lo[t + 2], acc[t + 3] + lo[t + 3]);
    } else {
      *reinterpret_cast<float4*>(dst + t) = make_float4(acc[t], acc[t + 1], acc[t + 2], acc[t + 3]);
    }
  }
}

// NU > 0: exactly NU users, their loads in registers; NU == 0: `users`.
template <int DIM, int PASSES, typename TCode, int NU>
__global__ void __launch_bounds__(kThreads, 2) hsq_decode_mean_kernel(
    const TCode* __restrict__ codes, const float* __restrict__ u,
    const float* __restrict__ codebook, int k, int users, int64_t m, float inv_users, bool vec,
    int warps, float* __restrict__ out) {
  constexpr int S = Lane<DIM, PASSES>::S;
  constexpr int ROW = Lane<DIM, PASSES>::ROW;
  constexpr int TILE = 32 * S * DIM;   // floats of a warp's tile
  extern __shared__ float4 smem4[];
  float* cb = reinterpret_cast<float*>(smem4);
  // the codebook, a float4 a load and 8 loads in flight per thread (one at
  // a time, its round trips held every block back at its start)
  constexpr int PITCH = Book<DIM>::PITCH;
  const float4* book4 = reinterpret_cast<const float4*>(codebook);
  const int n4 = k * DIM / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 8 * kThreads) {
    float4 f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j * kThreads < n4) f[j] = __ldg(book4 + i0 + j * kThreads);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n4) {
        const int c = i / (DIM / 4);
        reinterpret_cast<float4*>(cb + c * PITCH)[i - c * (DIM / 4)] = f[j];
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp >= warps) return;
  float* stage = cb + k * PITCH + warp * 32 * ROW;   // k * PITCH is a multiple of 4

  const int64_t tiles = (m + 32 * S - 1) / (32 * S);
  const int64_t stride = (int64_t)gridDim.x * warps;
  float* mine = stage + lane * ROW;
  // NU > 0: the next tile's codes and scales are loaded before this tile's
  // arithmetic, so a lane keeps 2 NU loads in flight while it computes
  TCode c[NU > 0 ? NU : 1][S];
  float v[NU > 0 ? NU : 1][S];
  auto load = [&](TCode (&cc)[NU > 0 ? NU : 1][S], float (&vv)[NU > 0 ? NU : 1][S], int64_t t) {
    const int64_t m0 = t * 32 * S + lane * S;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      load_run<TCode, S>(cc[i], codes + (int64_t)i * m, m0, m, vec);
      load_run<float, S>(vv[i], u + (int64_t)i * m, m0, m, vec);
    }
  };
  int64_t tile = (int64_t)blockIdx.x * warps + warp;
  if (NU > 0 && tile < tiles) load(c, v, tile);
  for (; tile < tiles; tile += stride) {
    const int64_t m0 = tile * 32 * S + lane * S;
    if constexpr (NU > 0) {
      TCode cn[NU][S];
      float vn[NU][S];
      if (tile + stride < tiles) load(cn, vn, tile + stride);
#pragma unroll
      for (int s = 0; s < S; ++s)
        mean_of<DIM, PASSES, NU>(
            mine + s * DIM, NU, [&](int q) { return (int)c[q][s]; },
            [&](int q) { return v[q][s]; }, cb, inv_users);
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int e = 0; e < S; ++e) {
          c[i][e] = cn[i][e];
          v[i][e] = vn[i][e];
        }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int64_t j = m0 + s < m ? m0 + s : m - 1;   // past m: any subvector, not stored
        mean_of<DIM, PASSES, 0>(
            mine + s * DIM, users, [&](int q) { return (int)__ldg(codes + (int64_t)q * m + j); },
            [&](int q) { return __ldg(u + (int64_t)q * m + j); }, cb, inv_users);
      }
    }
    __syncwarp();
    // the warp's tile, consecutive lanes on consecutive float4
    const int64_t base = tile * TILE;
    const int64_t end = m * DIM;
#pragma unroll
    for (int e = lane; e < TILE / 4; e += 32) {
      const int r = e / (S * DIM / 4);
      const int col = e - r * (S * DIM / 4);
      if (base + 4 * e < end)
        *reinterpret_cast<float4*>(out + base + 4 * e) =
            *reinterpret_cast<const float4*>(stage + r * ROW + 4 * col);
    }
    __syncwarp();
  }
}

template <int DIM, int PASSES, typename TCode, int NU>
int launch(const void* codes, const float* u, const float* codebook, int k, int users, int64_t m,
           float* out, cudaStream_t stream) {
  auto kernel = hsq_decode_mean_kernel<DIM, PASSES, TCode, NU>;
  constexpr int S = Lane<DIM, PASSES>::S;
  // the codebook and each warp's staging; fewer warps where a large
  // codebook leaves no room for 8
  const size_t book = (size_t)k * Book<DIM>::PITCH * sizeof(float);
  const size_t per_warp = 32 * Lane<DIM, PASSES>::ROW * sizeof(float);
  int device = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int warps = kWarps;
  while (warps > 1 && book + warps * per_warp > (size_t)max_smem) warps /= 2;
  const size_t smem = book + warps * per_warp;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (m + 32 * S - 1) / (32 * S);
  int64_t blocks = (tiles + warps - 1) / warps;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  // vector loads: M and both tensors' starts on a multiple of S elements
  const bool vec = m % S == 0 && reinterpret_cast<uintptr_t>(codes) % (S * sizeof(TCode)) == 0 &&
                   reinterpret_cast<uintptr_t>(u) % (S * sizeof(float)) == 0;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const TCode*>(codes), u,
                                                       codebook, k, users, m, 1.0f / (float)users,
                                                       vec, warps, out);
  return (int)cudaGetLastError();
}

template <int DIM, int PASSES, typename TCode>
int by_users(const void* codes, const float* u, const float* codebook, int k, int users, int64_t m,
             float* out, cudaStream_t s) {
  if (users == kFastUsers)
    return launch<DIM, PASSES, TCode, kFastUsers>(codes, u, codebook, k, users, m, out, s);
  return launch<DIM, PASSES, TCode, 0>(codes, u, codebook, k, users, m, out, s);
}

template <int DIM>
int dispatch(const void* codes, int codes_u8, const float* u, const float* codebook, int k,
             int users, int64_t m, int passes, float* out, cudaStream_t s) {
  if (passes == 1) {
    if (codes_u8) return by_users<DIM, 1, uint8_t>(codes, u, codebook, k, users, m, out, s);
    return by_users<DIM, 1, int32_t>(codes, u, codebook, k, users, m, out, s);
  }
  if (codes_u8) return by_users<DIM, 2, uint8_t>(codes, u, codebook, k, users, m, out, s);
  return by_users<DIM, 2, int32_t>(codes, u, codebook, k, users, m, out, s);
}

}  // namespace

extern "C" {

// codes: (users, m) uint8 (codes_u8) or int32; u: (users, m) float32, the
// dequantized scales; codebook: (k, dim) float32, bf16-exact; out: (m * dim)
// float32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported dim/passes or a codebook that
// leaves shared memory no room for one warp's outputs.
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
