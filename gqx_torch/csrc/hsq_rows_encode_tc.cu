// Row-major HSQ encode on Hopper's tensor cores (sm_90a): per dim-wide row
// (dim <= 32), the inner products with the K codewords of the raw float32
// codebook, code = argmax |p| (the first index on a tie) and u = p[code].
// Dims above 32 take hsq_rows_encode_wide.cu.
//
// Replaces: gqx/ops/pallas_hsq.py::hsq_encode (_encode_kernel), which takes
// (tile, dim) x (dim, K) on the TPU's matrix unit at Precision.HIGHEST (six
// bf16 passes) and the abs-argmax on the vector unit.  One launch covers
// every user's rows.
//
// What it computes: float32-accurate products from exact bf16 pieces.
//   Every normal float32 v splits exactly into three bf16 values,
//   v = h + m + l: h = bf16_rn(v), m = bf16_rn(v - h), l = v - h - m (24 =
//   8 + 8 + 8 significand bits; exact for |v| from 2^-110 up to the largest
//   bf16, and for 0).  A bf16 x bf16 product is exact in float32, so only
//   the tensor core's float32 additions round.
//   - bf16 rows have no middle or low piece: p = x.c_l + x.c_m + x.c_h,
//     three exact passes.
//   - float32 rows are split in three as well; of the nine cross terms the
//     six largest are kept (mm, hl, lh, hm, mh, hh), the dropped ml, lm and
//     ll are below 2^-23 of |x|.|c| together.
//   The terms go into one accumulator, the smallest first.
//   Selection: m = the running max |p|; a group of codeword tiles replaces
//   the kept index and products only where it raises m strictly, so a
//   later tie never wins, and the quad's lanes merge by (|p| largest,
//   index smallest): the first index of argmax |p| exactly, for the
//   products the tensor cores formed.  No rescan is needed (hsq_encode.cu's
//   signed rule needs one; argmax |p| does not).  p = [-3, 3] gives code 0
//   and u = -3; a zero row gives code 0 and u 0.
//   u is not the tensor cores' sum: for the chosen code it is recomputed as
//   the float32 dot product of the row and the raw codeword, FMAs in element
//   order, as the plain version's matmul forms it.  The norm quantizer
//   that follows scales every level of a segment by the segment's min and
//   max of u, so a u rounded otherwise than the plain version's moves a
//   whole segment's levels: with the tensor cores' u, P4's training step
//   moved 9,415 subvectors of the mean by more than 1e-5 against the CPU
//   plain path (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// What bounds it on the H100: its instructions, not its bound.  The bound
// is operations: P4's unit (8 users x 2,940,928 bf16 rows of 8, K = 1024) is
// 192.7 G multiply-adds, on the CUDA cores in float32 (hsq_rows_encode.cu)
// 5.75 ms at the fp32 peak; here three bf16 passes, 1.16 TFLOP, 1.17 ms at
// the bf16 peak (float32 rows: six passes, 2.34 ms), against 0.17 ms for
// its 564 MB.  But every one of the 24.1 G products leaves the tensor cores
// as its own float32 register, and the selection's ~10 instructions per 4
// products (FMNMX, then the compare and the predicated moves of the kept
// index and products) take more issue time than the mma: the probe
// (gqx_torch/scripts/rows_encode_probe.py; times in PERF.md section 6,
// NVIDIA H100 80GB HBM3, 700 W) shows the kernel with the selection cut to a
// running max, or to a sum, well below the whole.
//
// Design (hsq_encode.cu's, for fragments, staging and selection):
// - The contraction index is a free permutation of the dims: the row is
//   zero-padded to DP = 8 * N8 dims (exact), and lane (g, t) = (lane / 4,
//   lane % 4) holds the DP/4 contiguous dims t*DP/4 ... of its rows g and
//   g + 8, two dims per 8-deep chunk.  A pass (x piece, codebook piece) is
//   N8 chunks; the passes' chunks are contracted two at a time by mma.sync
//   m16n8k16 (bf16 -> float32), an odd last chunk by m16n8k8.  At dim 8:
//   bf16 rows take one k16 (c_l, c_m) and one k8 (c_h) per 16 rows x 8
//   codewords, float32 rows three k16.
// - The codebook is split and staged into shared memory per block in
//   fragment order (one 32-bit word of two bf16 per lane, piece and chunk:
//   conflict-free LDS.32), zero past K and past dim.  A codebook larger than
//   kMaxSmem is staged in K-tiles, each warp carrying its running best from
//   one to the next.  A warp holds kTiles row tiles (bf16 rows loaded
//   straight into the A words; float32 rows split once at load) and reuses
//   each B fragment for all of them; blocks stride over the rows.
// - Per row a lane sees codewords 8j + 2t and 8j + 2t + 1 of each tile j.
//   Over groups of kGroup tiles it keeps m = max |p| (FMNMX with the |.|
//   modifier), and where a group raises m (FSETP) the group's index and its
//   products (predicated moves).  At the end, the lane's first kept product
//   with |p| == m, then the quad merge.  Lane t writes row tile t.  The
//   loop over groups is unrolled by 4, so that a group's B reads and mma
//   issue while an earlier group's selection waits on its products.
// - Tried on the card and not kept: 2 row tiles a warp (3 blocks per SM),
//   4 tiles a group, 4 warps a block, no unrolling or by 2 (all slower or
//   no faster on bf16 rows); wgmma m64n64k16 with A from registers, with
//   and without a second accumulator to overlap the next chunk's products
//   with the selection: no faster on bf16 rows (faster on float32 rows,
//   which P4 gives the kernel only with error feedback), since the
//   selection, not the tensor cores, bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kGroup = 2;                 // codeword tiles tracked together
constexpr int kKept = 2 * kGroup;         // products a lane keeps per row
constexpr int kMaxSmem = 96 * 1024;       // codebook pieces per K-tile, bytes
constexpr unsigned kNone = 0xffffffffu;   // no index found

// The kept passes, smallest first, as (x piece, codebook piece); piece 0 =
// h, 1 = m, 2 = l.  bf16 rows: (h,l) (h,m) (h,h).  float32 rows: (m,m)
// (h,l) (l,h) (h,m) (m,h) (h,h).
template <bool X32>
struct Passes {
  static constexpr int kN = X32 ? 6 : 3;
  static constexpr int kXPieces = X32 ? 3 : 1;
  __host__ __device__ static constexpr int x(int i) {
    return X32 ? (i == 0 ? 1 : i == 2 ? 2 : i == 4 ? 1 : 0) : 0;
  }
  __host__ __device__ static constexpr int c(int i) {
    return X32 ? (i == 0 ? 1 : i == 1 ? 2 : i == 3 ? 1 : 0) : 2 - i;
  }
};

// row tiles a warp holds: fewer where a row takes more A words
__host__ __device__ constexpr int row_tiles(int n8, bool x32) {
  return x32 ? (n8 == 1 ? 4 : n8 == 2 ? 2 : 1) : (n8 <= 2 ? 4 : 2);
}

// d = A B and d += A B, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.0f));
}

__device__ __forceinline__ void mma_k16_acc(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_k8_acc(float (&d)[4], unsigned a0, unsigned a1, unsigned b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// One row's A words: xw[piece][chunk] for the lane's dims t*DP/4 + 2c, + 1.
// EXACT (dim == DP): one aligned load per chunk (4 bytes of bf16, 8 of
// float32); otherwise element loads, zero past dim.
template <int N8, bool EXACT, typename TIn>
__device__ __forceinline__ void load_row(const TIn* __restrict__ x, int64_t row, int dim, int t,
                                         bool valid,
                                         unsigned (&xw)[Passes<sizeof(TIn) == 4>::kXPieces][N8]) {
  constexpr bool kX32 = sizeof(TIn) == 4;
  constexpr int kPer = 2 * N8;   // dims per lane
#pragma unroll
  for (int c = 0; c < N8; ++c) {
    float v0 = 0.0f, v1 = 0.0f;
    unsigned raw = 0u;
    if (valid) {
      if constexpr (EXACT) {
        const TIn* p = x + row * (8 * N8) + t * kPer + 2 * c;
        if constexpr (kX32) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(p));
          v0 = v.x;
          v1 = v.y;
        } else {
          raw = __ldg(reinterpret_cast<const unsigned*>(p));
        }
      } else {
        const int e = t * kPer + 2 * c;
        const TIn* p = x + row * dim + e;
        if constexpr (kX32) {
          v0 = e < dim ? __ldg(p) : 0.0f;
          v1 = e + 1 < dim ? __ldg(p + 1) : 0.0f;
        } else {
          const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
          const unsigned lo = e < dim ? __ldg(q) : 0u;
          const unsigned hi = e + 1 < dim ? __ldg(q + 1) : 0u;
          raw = lo | (hi << 16);
        }
      }
    }
    if constexpr (kX32) {
      unsigned w[3];
      split3(v0, v1, w);
#pragma unroll
      for (int p = 0; p < 3; ++p) xw[p][c] = w[p];
    } else {
      xw[0][c] = raw;
    }
  }
}

// u for the chosen code: the row and the raw codeword's float32 dot product,
// FMAs in element order, as the plain version's matmul forms it.
template <int N8, bool EXACT, typename TIn>
__device__ __forceinline__ float dot_row(const TIn* __restrict__ x, int64_t row, int dim,
                                         const float* __restrict__ c) {
  const int d = EXACT ? 8 * N8 : dim;
  const TIn* xr = x + row * d;
  float p = 0.0f;
#pragma unroll
  for (int e = 0; e < 8 * N8; ++e) {
    if (EXACT || e < d) {
      float v;
      if constexpr (sizeof(TIn) == 4) v = __ldg(reinterpret_cast<const float*>(xr) + e);
      else v = __bfloat162float(xr[e]);
      p = fmaf(v, __ldg(c + e), p);
    }
  }
  return p;
}

// p[0], p[1] = row g with codewords 8j + 2t, 8j + 2t + 1; p[2], p[3] = row
// g + 8; every kept pass contracted into one accumulator, the smallest first.
template <int N8, bool X32>
__device__ __forceinline__ void products(float (&p)[4],
                                         const unsigned (&xa)[Passes<X32>::kXPieces][2][N8],
                                         const unsigned (&b)[3][N8]) {
  using P = Passes<X32>;
  constexpr int kChunks = P::kN * N8;
#pragma unroll
  for (int i = 0; i + 1 < kChunks; i += 2) {
    const int x0 = P::x(i / N8), c0 = P::c(i / N8), k0 = i % N8;
    const int x1 = P::x((i + 1) / N8), c1 = P::c((i + 1) / N8), k1 = (i + 1) % N8;
    const unsigned a[4] = {xa[x0][0][k0], xa[x0][1][k0], xa[x1][0][k1], xa[x1][1][k1]};
    const uint2 bb = make_uint2(b[c0][k0], b[c1][k1]);
    if (i == 0) mma_k16(p, a, bb);
    else mma_k16_acc(p, a, bb);
  }
  if constexpr (kChunks % 2 == 1) {
    constexpr int i = kChunks - 1;
    constexpr int xl = P::x(i / N8), cl = P::c(i / N8), kl = i % N8;
    mma_k8_acc(p, xa[xl][0][kl], xa[xl][1][kl], b[cl][kl]);
  }
}

// Stage codeword tiles [j0, j0 + nt) into shared memory, split into pieces:
// word ((jl * 3 + piece) * N8 + c) * 32 + lane holds codeword 8(j0 + jl) + g,
// dims t*DP/4 + 2c and + 1 (zero past K and past dim).
template <int N8>
__device__ __forceinline__ void stage(unsigned* __restrict__ words, const float* __restrict__ cb,
                                      int k, int dim, int j0, int nt) {
  constexpr int kPer = 2 * N8;
  for (int i = threadIdx.x; i < nt * N8 * 32; i += blockDim.x) {
    const int lane = i & 31, c = (i >> 5) % N8, jl = (i >> 5) / N8;
    const int n = 8 * (j0 + jl) + (lane >> 2), e = (lane & 3) * kPer + 2 * c;
    float v0 = 0.0f, v1 = 0.0f;
    if (n < k) {
      const float* row = cb + (int64_t)n * dim;
      if (e < dim) v0 = __ldg(row + e);
      if (e + 1 < dim) v1 = __ldg(row + e + 1);
    }
    unsigned w[3];
    split3(v0, v1, w);
#pragma unroll
    for (int p = 0; p < 3; ++p) words[((jl * 3 + p) * N8 + c) * 32 + lane] = w[p];
  }
}

template <int N8, bool EXACT, typename TIn, typename TCode>
__global__ void __launch_bounds__(kWarps * 32, 2) hsq_rows_encode_tc_kernel(
    const TIn* __restrict__ x, const float* __restrict__ codebook, int k, int dim, int stage_tiles,
    int64_t rows, float* __restrict__ u_out, TCode* __restrict__ codes_out) {
  constexpr bool kX32 = sizeof(TIn) == 4;
  constexpr int kXP = Passes<kX32>::kXPieces;
  constexpr int kTiles = row_tiles(N8, kX32);
  constexpr int kRowsPerWarp = 16 * kTiles;
  extern __shared__ unsigned words[];
  const int tiles_k = (k + 8 * kGroup - 1) / (8 * kGroup) * kGroup;   // zero past K
  const int stages = (tiles_k + stage_tiles - 1) / stage_tiles;
  if (stages == 1) {
    stage<N8>(words, codebook, k, dim, 0, tiles_k);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int64_t tasks = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  // every warp of the block takes the same trips (the K-tiles' barriers)
  for (int64_t base = (int64_t)blockIdx.x * kWarps; base < tasks;
       base += (int64_t)gridDim.x * kWarps) {
    const int64_t task = base + (threadIdx.x >> 5);
    const bool live = task < tasks;
    const int64_t r0 = task * kRowsPerWarp + (lane >> 2);   // row g of tile 0
    unsigned xa[kTiles][kXP][2][N8];
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = r0 + 16 * r + 8 * h;
        unsigned xw[kXP][N8];
        load_row<N8, EXACT, TIn>(x, row, dim, t, live && row < rows, xw);
#pragma unroll
        for (int p = 0; p < kXP; ++p) {
#pragma unroll
          for (int c = 0; c < N8; ++c) xa[r][p][h][c] = xw[p][c];
        }
      }
    }

    // per row: the lane's largest |p| (m), the first group of kGroup tiles
    // that reached it (jg) and that group's products
    float m[kTiles][2], kept[kTiles][2][kKept];
    int jg[kTiles][2];
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[r][h] = -1.0f;
        jg[r][h] = 0;
#pragma unroll
        for (int i = 0; i < kKept; ++i) kept[r][h][i] = 0.0f;
      }
    }
    for (int s = 0; s < stages; ++s) {
      const int j0 = s * stage_tiles;
      const int nt = tiles_k - j0 < stage_tiles ? tiles_k - j0 : stage_tiles;
      if (stages > 1) {
        __syncthreads();   // every warp is done with the previous K-tile
        stage<N8>(words, codebook, k, dim, j0, nt);
        __syncthreads();
      }
      if (!live) continue;
      // four groups unrolled: the next groups' B reads and mma issue while
      // a group's selection waits on its products
#pragma unroll 4
      for (int jl = 0; jl < nt; jl += kGroup) {
        unsigned b[kGroup][3][N8];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
#pragma unroll
          for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int c = 0; c < N8; ++c) b[q][p][c] = words[(((jl + q) * 3 + p) * N8 + c) * 32 + lane];
          }
        }
#pragma unroll
        for (int r = 0; r < kTiles; ++r) {
          float p[kGroup][4];
#pragma unroll
          for (int q = 0; q < kGroup; ++q) products<N8, kX32>(p[q], xa[r], b[q]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = fmaxf(fabsf(p[0][2 * h]), fabsf(p[0][2 * h + 1]));
#pragma unroll
            for (int q = 1; q < kGroup; ++q)
              v = fmaxf(v, fmaxf(fabsf(p[q][2 * h]), fabsf(p[q][2 * h + 1])));
            if (v > m[r][h]) {
              m[r][h] = v;
              jg[r][h] = j0 + jl;
#pragma unroll
              for (int i = 0; i < kKept; ++i) kept[r][h][i] = p[i >> 1][2 * h + (i & 1)];
            }
          }
        }
      }
    }
    if (!live) continue;

    // the lane's first kept product with |p| == m, then the quad's
    // (|p| largest, index smallest); lane t writes row tile t, with u
    // recomputed in float32 for the chosen code
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = m[r][h];
        unsigned idx = kNone;
#pragma unroll
        for (int i = kKept - 1; i >= 0; --i) {
          if (fabsf(kept[r][h][i]) == a) idx = 8u * (unsigned)(jg[r][h] + (i >> 1)) + 2u * t + (i & 1);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float oa = __shfl_xor_sync(0xffffffffu, a, off);
          const unsigned oi = __shfl_xor_sync(0xffffffffu, idx, off);
          if (oa > a || (oa == a && oi < idx)) {
            a = oa;
            idx = oi;
          }
        }
        const int64_t row = r0 + 16 * r + 8 * h;
        if ((r & 3) == t && row < rows) {
          // kNone: a row of NaN
          u_out[row] = idx == kNone ? 0.0f
                                    : dot_row<N8, EXACT, TIn>(x, row, dim, codebook + (int64_t)idx * dim);
          codes_out[row] = (TCode)(idx == kNone ? 0u : idx);
        }
      }
    }
  }
}

template <int N8, bool EXACT, typename TIn, typename TCode>
int launch(const void* x, const float* codebook, int k, int dim, int64_t rows, float* u,
           void* codes, cudaStream_t stream) {
  auto kernel = hsq_rows_encode_tc_kernel<N8, EXACT, TIn, TCode>;
  constexpr int kRowsPerWarp = 16 * row_tiles(N8, sizeof(TIn) == 4);
  const int tiles_k = (k + 8 * kGroup - 1) / (8 * kGroup) * kGroup;
  const int tile_bytes = 3 * N8 * 32 * (int)sizeof(unsigned);
  int stage_tiles = kMaxSmem / tile_bytes / kGroup * kGroup;
  if (stage_tiles > tiles_k) stage_tiles = tiles_k;
  const size_t smem = (size_t)stage_tiles * tile_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tasks = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  int64_t blocks = (tasks + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const TIn*>(x), codebook, k, dim, stage_tiles, rows, u,
      static_cast<TCode*>(codes));
  return (int)cudaGetLastError();
}

template <int N8, bool EXACT>
int dispatch(const void* x, int x_bf16, const float* codebook, int k, int dim, int64_t rows,
             float* u, void* codes, int codes_u8, cudaStream_t s) {
#define GQX_ENC(TI, TC) return launch<N8, EXACT, TI, TC>(x, codebook, k, dim, rows, u, codes, s)
  if (x_bf16) {
    if (codes_u8) GQX_ENC(__nv_bfloat16, uint8_t);
    GQX_ENC(__nv_bfloat16, int32_t);
  }
  if (codes_u8) GQX_ENC(float, uint8_t);
  GQX_ENC(float, int32_t);
#undef GQX_ENC
}

template <int N8>
int dispatch_dim(const void* x, int x_bf16, const float* codebook, int k, int dim, int64_t rows,
                 float* u, void* codes, int codes_u8, cudaStream_t s) {
  if (dim == 8 * N8) return dispatch<N8, true>(x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, s);
  return dispatch<N8, false>(x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, s);
}

}  // namespace

extern "C" {

// x: (rows, dim) contiguous, bf16 (x_bf16) or float32, every user's rows one
// after another; when dim is a multiple of 8, aligned to 4 bytes (bf16) or
// 8 (float32); codebook: (k, dim) float32, raw; u: (rows,) float32; codes:
// (rows,) uint8 (codes_u8, k <= 256) or int32.  1 <= dim <= 32.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape
// outside that, cudaErrorMisalignedAddress for a misaligned x.
int gqx_hsq_rows_encode_tc(const void* x, int x_bf16, const float* codebook, int k, int dim,
                           int64_t rows, float* u, void* codes, int codes_u8, void* stream) {
  if (dim < 1 || dim > 32 || k < 1 || (codes_u8 && k > 256)) return (int)cudaErrorInvalidValue;
  if (dim % 8 == 0 && (uintptr_t)x % (uintptr_t)(x_bf16 ? 4 : 8))
    return (int)cudaErrorMisalignedAddress;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 7) / 8) {
    case 1: return dispatch_dim<1>(x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, s);
    case 2: return dispatch_dim<2>(x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, s);
    case 3: return dispatch_dim<3>(x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, s);
    default: return dispatch_dim<4>(x, x_bf16, codebook, k, dim, rows, u, codes, codes_u8, s);
  }
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
