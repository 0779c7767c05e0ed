// Row-major HSQ encode on Hopper's tensor cores (sm_90a) for dims above 32:
// per dim-wide row, the inner products with the K codewords of the raw
// float32 codebook, code = argmax |p| (the first index on a tie) and u =
// p[code].  Any dim and any K; dims up to 32 take hsq_rows_encode_tc.cu.
//
// Replaces: gqx/ops/pallas_hsq.py::hsq_encode (_encode_kernel), which takes
// (tile, dim) x (dim, K) on the TPU's matrix unit at Precision.HIGHEST and
// the abs-argmax on the vector unit, for dims above 32.  One launch covers
// every user's rows.  It replaced hsq_rows_encode.cu, one row per thread on
// the CUDA cores, which stays in csrc/ only as the baseline that
// chip_smoke.py times beside this kernel.
//
// What it computes (hsq_rows_encode_tc.cu's contract, unchanged):
//   float32-accurate products from exact bf16 pieces.  Every float32 v
//   splits exactly into v = h + m + l, three bf16 values (kernel_util.cuh's
//   split3, ops/hsq_prep.py::split_bf16_3), and a bf16 x bf16 product is
//   exact in float32.  bf16 rows are their own single piece: p = x.c_l +
//   x.c_m + x.c_h, three exact passes.  float32 rows are split as well; of
//   the nine cross terms the six largest are kept (mm, hl, lh, hm, mh, hh),
//   the dropped ml, lm and ll below 2^-23 of |x|.|c| together.
//   The tensor cores' float32 additions round toward zero at the scale of
//   the accumulator (PERF.md section 6).  So the largest pass (x.c_h, or hh)
//   goes into one set of accumulators and the smaller ones, smallest first,
//   into a second, whose roundings are 2^-8 smaller; the two are added
//   once, before the selection.  Modelled on the CPU in float64 with a
//   rounding toward zero per k16 step (tests/test_torch_hsq_rows.py), two
//   sets keep every |p| within 2.5e-6 of the row's largest |p| at dims 256
//   and 512, on both input types, so a code can differ from the exact
//   argmax only below the 1e-5 top-2 margin that the tests allow; one set
//   errs at least twice as much on average.
//   Selection: per row and lane the running max |p| with a strict raise
//   over the codewords in index order, the quad's lanes merged by (|p|
//   largest, index smallest), then the codeword tiles in order: the first
//   index of argmax |p| for the products the tensor cores formed.  p = [-3,
//   3] gives code 0 and u = -3; a zero row gives code 0 and u = 0.
//   u is not the tensor cores' sum: for the chosen code it is recomputed as
//   hsq_rows_encode.cu computes it, fmaf in element order over the widened
//   row and the raw codeword, so it is bit-equal to that kernel's u wherever
//   the codes agree.  A u rounded otherwise moves every level of its norm
//   segment (PERF.md section 6).
//
// What bounds it on the H100: operations.  At P6's shape (8 users x 91,904
// bf16 rows of 256, K 256) the encode is 48.2 G multiply-adds: 1.44 ms at
// the CUDA cores' fp32 peak (67 TFLOP/s), where hsq_rows_encode.cu ran one
// serial FMA chain per codeword and took 18 ms; here three bf16 passes,
// 0.29 ms at the tensor cores' 989 TFLOP/s (float32 rows: six passes, 0.58
// ms), against 0.11 ms (0.22) for the rows' bytes.  At dim >= 64 the
// selection is under one instruction per 64 products: the kernel is a GEMM
// with an argmax epilogue and is built as one, on wgmma.
//
// Design:
// - A block of two warpgroups takes 128 rows, 64 a warpgroup, against the
//   codebook in tiles of 128 codewords: per k16 step and pass one
//   wgmma.mma_async m64n128k16, both operands from shared memory, into 64
//   float32 accumulators a thread and set (two sets: 128).  The dim is
//   contracted in chunks of 32; a chunk's products run while the next
//   chunk's are issued, and the chunks are staged into a ring of six
//   buffers (bf16 rows; four for float32 rows), so the copies run ahead of
//   the tensor cores.  Padding past dim (and past K) is zero, which is
//   exact, so ragged dims need no second path.
// - The codebook is split once per call, by a small kernel, into bf16
//   pieces in device memory (scratch from the wrapper), laid out in the
//   order and layout the kernel stages them: each (codeword tile, chunk)
//   one contiguous 24 KB block, which one bulk copy on the copy engine
//   brings into shared memory, completing the stage's mbarrier.  The rows
//   go by cp.async.  Tiles are in wgmma's canonical K-major layout without
//   swizzle: 8 rows x 16 bytes a core matrix, the next 8 dims 128 bytes on,
//   the next 8 rows kChunk * 16 bytes on; the copies of a warp fill
//   consecutive 16-byte units.  bf16 rows are staged as they are; float32
//   rows are staged raw and split from shared memory into three piece tiles
//   once per chunk (per_user_dw_tc_f32.cu's way), in two alternating
//   buffers.
// - After the last chunk of a codeword tile each thread selects from its
//   accumulators (two rows, 32 codewords each), the quad merges by
//   shuffles, and the thread folds the tile into its rows' running best:
//   a warp holds whole rows of the tile, so no block-wide merge is needed.
//   Rows are staged again for each codeword tile (twice at K 256), so the
//   codebook can be any size.
// - Then u: the rows and the chosen codewords go through the same ring,
//   chunk by chunk, and one thread per row runs its fmaf chain from shared
//   memory (the quarter warp's 16-byte reads fall into distinct bank
//   groups).
// - Copies are 16 bytes where the rows allow (dim * size % 16 == 0, the
//   input 16-byte aligned), else 4, else (bf16 rows of an odd dim) one
//   value at a time through registers.
// - What bounds it now is the bytes it stages, not the tensor cores: per
//   128 rows the whole codebook's pieces (393 KB at P6's shape), the rows
//   twice and, for u, the rows and the chosen codewords again
//   (gqx_torch/scripts/rows_wide_probe.py times the kernel without u and
//   without the rows' copies; PERF.md section 6).
// - Tried and not kept (development runs, before this design): mma.sync
//   m16n8k16 from ldmatrix fragments, 8 warps of 64 rows x 32 codewords,
//   and wgmma with the codebook staged by cp.async and each chunk's
//   products waited for before the next were issued: both about 6x the
//   operations bound on bf16 rows; clusters of 2 and 4 blocks sharing each
//   codebook chunk's copy (multicast), with a cluster barrier per chunk:
//   slower than one block alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"

namespace {

constexpr int kThreads = 256;               // two warpgroups
constexpr int kRows = 128;                  // rows per block, 64 a warpgroup
constexpr int kCodes = 128;                 // codewords per tile: wgmma's N
constexpr int kChunk = 32;                  // dims per staged chunk: two k16 steps
constexpr int kUnits = kChunk / 8;          // 16-byte units of a staged bf16 row
constexpr int kGroupBytes = kUnits * 128;   // 8 rows of a staged bf16 tile
constexpr int kTileBytes = kRows * kChunk * 2;
constexpr int kRawPitch = kChunk + 4;       // floats per staged float32 row: 144 bytes
static_assert(kRows == kCodes, "row and codeword tiles share kTileBytes");

// The kept passes, smallest first, as (x piece, codebook piece); piece 0 =
// h, 1 = m, 2 = l.  The last, (h, h), goes into the first set, the others
// into the second.  bf16 rows: (h,l) (h,m) | (h,h).  float32 rows: (m,m)
// (h,l) (l,h) (h,m) (m,h) | (h,h).
template <bool X32>
struct Passes {
  static constexpr int kN = X32 ? 6 : 3;
  __host__ __device__ static constexpr int x(int i) {
    return X32 ? (i == 0 ? 1 : i == 2 ? 2 : i == 4 ? 1 : 0) : 0;
  }
  __host__ __device__ static constexpr int c(int i) {
    return X32 ? (i == 0 ? 1 : i == 1 ? 2 : i == 3 ? 1 : 0) : 2 - i;
  }
};

// Bytes of one staged rows chunk (bf16 as it is, float32 raw), of one
// staged codebook chunk (three pieces) and of the float32 rows' piece tiles.
template <typename TIn>
__host__ __device__ constexpr int rows_bytes() {
  return sizeof(TIn) == 4 ? kRows * kRawPitch * 4 : kTileBytes;
}
constexpr int kCodesBytes = 3 * kTileBytes;
// the chosen codewords' chunk for u, float32, 144 bytes a row
static_assert(kRows * kRawPitch * 4 <= kCodesBytes, "u's codewords reuse the codebook buffers");

// The ring of staged chunks: as deep as shared memory allows (float32 rows
// also take two piece-tile buffers).
template <typename TIn>
__host__ __device__ constexpr int stages() {
  return sizeof(TIn) == 4 ? 4 : 6;
}

template <typename TIn>
__host__ __device__ constexpr int smem_bytes() {
  return stages<TIn>() * (rows_bytes<TIn>() + kCodesBytes + 8) +
         (sizeof(TIn) == 4 ? 2 * kCodesBytes : 0) + kRows * 8;
}

// Byte offset of (row r, dim e) in a staged bf16 tile: wgmma's K-major
// layout without swizzle.
__host__ __device__ constexpr int tile_offset(int r, int e) {
  return (r >> 3) * kGroupBytes + (e >> 3) * 128 + (r & 7) * 16 + (e & 7) * 2;
}

// The shared-memory matrix descriptor of a tile starting at addr: no
// swizzle, leading byte offset 128 (the next 8 dims), stride byte offset
// kGroupBytes (the next 8 rows).
__device__ __forceinline__ uint64_t descriptor(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(kGroupBytes >> 4) << 32);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy BYTES from global to shared memory without registers; zeros where
// !valid (the source is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Writes to shared memory by this thread become visible to wgmma.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

// The barrier's phase completes once this arrival is made and `bytes` have
// landed.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Copy a contiguous block of global memory into shared memory on the copy
// engine; its bytes count on the barrier at `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Pins the accumulators: no read or move of them crosses this point.
__device__ __forceinline__ void settle(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B on the warpgroup: A (64 x 16) and B (128 x 16, K-major) bf16 in
// shared memory, d the 64 float32 accumulators of the thread.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Start copying chunk [e0, e0 + kChunk) of rows [row0, row0 + kRows) into a
// staged rows buffer at dst (bf16: a tile; float32: raw, kRawPitch apart),
// zero past dim and past the last row.  CP bytes a copy, CP = 2 (bf16 rows
// that allow no 4-byte copy) through registers; a copy lies wholly before
// or after dim since dim * sizeof(TIn) is a multiple of CP.  The eight rows
// of a group vary fastest.
template <typename TIn, int CP>
__device__ __forceinline__ void load_rows(unsigned dst, const TIn* __restrict__ x, int64_t row0,
                                          int64_t rows, int dim, int e0) {
  constexpr int kPer = CP / (int)sizeof(TIn);   // values a copy
  constexpr int kCopies = kChunk / kPer;        // copies a row
  for (int i = threadIdx.x; i < kRows * kCopies; i += kThreads) {
    const int r = i / (8 * kCopies) * 8 + (i & 7), e = (i >> 3) % kCopies * kPer;
    const int64_t row = row0 + r;
    const bool valid = row < rows && e0 + e < dim;
    const TIn* src = valid ? x + row * dim + e0 + e : x;
    const unsigned d = dst + (sizeof(TIn) == 4 ? (r * kRawPitch + e) * 4 : tile_offset(r, e));
    if constexpr (CP >= 4) {
      cp_async<CP>(d, src, valid);
    } else {
      const unsigned short v = valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(d), "h"(v) : "memory");
    }
  }
}

// Split a staged float32 rows chunk into its three bf16 piece tiles (piece
// p at p * kTileBytes): eight values an item, the eight rows of a group
// fastest.
__device__ __forceinline__ void split_rows(const float* raw, unsigned char* tiles) {
  for (int i = threadIdx.x; i < kRows * kUnits; i += kThreads) {
    const int r = i / (8 * kUnits) * 8 + (i & 7), e = (i >> 3) % kUnits * 8;
    const float4 a = *reinterpret_cast<const float4*>(raw + r * kRawPitch + e);
    const float4 b = *reinterpret_cast<const float4*>(raw + r * kRawPitch + e + 4);
    unsigned w[4][3];
    split3(a.x, a.y, w[0]);
    split3(a.z, a.w, w[1]);
    split3(b.x, b.y, w[2]);
    split3(b.z, b.w, w[3]);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(tiles + p * kTileBytes + tile_offset(r, e)) =
          make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
  }
}

template <typename TIn, int CP>
__global__ void __launch_bounds__(kThreads, 1) hsq_rows_encode_wide_kernel(
    const TIn* __restrict__ x, const float* __restrict__ codebook,
    const unsigned char* __restrict__ pieces, int k, int dim, int k_pad, int d_pad, int64_t rows,
    float* __restrict__ u_out, void* __restrict__ codes_out, int codes_u8, int cb16) {
  constexpr bool kX32 = sizeof(TIn) == 4;
  using P = Passes<kX32>;
  constexpr int kRowsBytes = rows_bytes<TIn>();
  constexpr int kS = stages<TIn>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* rows_buf = smem;                                   // kS x rows chunk
  unsigned char* codes_buf = rows_buf + kS * kRowsBytes;            // kS x codebook chunk
  unsigned char* tiles = codes_buf + kS * kCodesBytes;              // float32 rows' pieces, x2
  unsigned char* bars = tiles + (kX32 ? 2 * kCodesBytes : 0);       // kS barriers
  int2* chosen = reinterpret_cast<int2*>(bars + kS * 8);            // (code, found) a row

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int chunks = d_pad / kChunk, total = chunks * (k_pad / kCodes);
  const unsigned rows_s = smem_addr(rows_buf), codes_s = smem_addr(codes_buf);
  const unsigned bars_s = smem_addr(bars);
  if (tid == 0) {
    for (int b = 0; b < kS; ++b) mbar_init(bars_s + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s of (codeword tile, chunk): the rows by cp.async, the codebook
  // chunk (contiguous in the pieces' staged order) by one bulk copy
  auto issue = [&](int s) {
    if (s < total) {
      const int buf = s % kS, tile = s / chunks, c = s - tile * chunks;
      load_rows<TIn, CP>(rows_s + buf * kRowsBytes, x, row0, rows, dim, c * kChunk);
      if (tid == 0) {
        mbar_expect(bars_s + 8 * buf, kCodesBytes);
        bulk_copy(codes_s + buf * kCodesBytes, pieces + (int64_t)s * kCodesBytes, kCodesBytes,
                  bars_s + 8 * buf);
      }
    }
    cp_async_commit();
  };

  // the accumulators of the warpgroup's 64 rows x 128 codewords: per n8
  // tile j, [4j], [4j + 1] row 16w + g, codewords 8j + 2t, + 1; [4j + 2],
  // [4j + 3] row 16w + g + 8
  float s1[64], s2[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s1[i] = s2[i] = 0.0f;
  float best_a[2] = {-1.0f, -1.0f};   // the running best of rows 16w + g and + 8
  int best_i[2] = {0, 0};

  // chunk s's products run while chunk s + 1's are issued: a buffer is
  // refilled two chunks after its products were issued
  for (int s = 0; s < kS - 2; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    const int buf = s % kS, tile = s / chunks, c = s - tile * chunks;
    cp_async_wait<kS - 3>();
    mbar_wait(bars_s + 8 * buf, (s / kS) & 1);
    fence_async();
    __syncthreads();   // chunk s has landed; every warpgroup is done with chunk s - 2
    issue(s + kS - 2);
    unsigned a_base = rows_s + buf * kRowsBytes;
    if constexpr (kX32) {
      unsigned char* piece_tiles = tiles + (s & 1) * kCodesBytes;
      split_rows(reinterpret_cast<const float*>(rows_buf + buf * kRowsBytes), piece_tiles);
      fence_async();
      __syncthreads();
      a_base = smem_addr(piece_tiles);
    }
    a_base += wg * 8 * kGroupBytes;   // the warpgroup's 64 rows
    const unsigned b_base = codes_s + buf * kCodesBytes;
    settle(s1);
    settle(s2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
      for (int i = 0; i + 1 < P::kN; ++i)
        wgmma_128(s2, descriptor(a_base + P::x(i) * kTileBytes + kk * 256),
                  descriptor(b_base + P::c(i) * kTileBytes + kk * 256));
      wgmma_128(s1, descriptor(a_base + kk * 256), descriptor(b_base + kk * 256));
    }
    wgmma_commit();
    if (c != chunks - 1) {
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
    settle(s1);
    settle(s2);

    // the tile's selection: per lane, per quad, then into the running best
    const int n0 = tile * kCodes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = -1.0f;
      int idx = 0;
#pragma unroll
      for (int j = 0; j < kCodes / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = fabsf(s1[4 * j + 2 * h + e] + s2[4 * j + 2 * h + e]);
          const int n = n0 + 8 * j + 2 * t + e;
          if (v > a && n < k) {
            a = v;
            idx = n;
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float oa = __shfl_xor_sync(0xffffffffu, a, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (oa > a || (oa == a && oi < idx)) {
          a = oa;
          idx = oi;
        }
      }
      if (a > best_a[h]) {   // tiles in codeword order: a strict raise keeps the first
        best_a[h] = a;
        best_i[h] = idx;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s1[i] = s2[i] = 0.0f;
  }

  // u for the chosen codes: the rows and the chosen codewords through the
  // same ring, one fmaf chain per row in element order
  cp_async_wait<0>();
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      chosen[wg * 64 + w * 16 + h * 8 + g] = make_int2(best_i[h], best_a[h] >= 0.0f);
  }
  fence_async();
  __syncthreads();
  const float* gather = reinterpret_cast<const float*>(codes_buf);   // (kRows, kRawPitch) a buffer
  auto issue_u = [&](int c) {
    if (c < chunks) {
      const int buf = c % kS, e0 = c * kChunk;
      const unsigned dst = codes_s + buf * kCodesBytes;
      load_rows<TIn, CP>(rows_s + buf * kRowsBytes, x, row0, rows, dim, e0);
      if (cb16) {   // dim % 4 == 0: 16-byte copies
        for (int i = tid; i < kRows * kChunk / 4; i += kThreads) {
          const int r = i / (kChunk / 4), e = i % (kChunk / 4) * 4;
          const bool valid = row0 + r < rows && e0 + e < dim;
          const float* src = valid ? codebook + (int64_t)chosen[r].x * dim + e0 + e : codebook;
          cp_async<16>(dst + (r * kRawPitch + e) * 4, src, valid);
        }
      } else {
        for (int i = tid; i < kRows * kChunk; i += kThreads) {
          const int r = i / kChunk, e = i % kChunk;
          const bool valid = row0 + r < rows && e0 + e < dim;
          const float* src = valid ? codebook + (int64_t)chosen[r].x * dim + e0 + e : codebook;
          cp_async<4>(dst + (r * kRawPitch + e) * 4, src, valid);
        }
      }
    }
    cp_async_commit();
  };
  for (int c = 0; c < kS - 1; ++c) issue_u(c);
  float p = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    issue_u(c + kS - 1);
    if (tid < kRows) {
      const int buf = c % kS, n = min(kChunk, dim - c * kChunk);
      const unsigned char* xb = rows_buf + buf * kRowsBytes;
      const float* cw = gather + buf * (kCodesBytes / 4) + tid * kRawPitch;
#pragma unroll
      for (int q = 0; q < kUnits; ++q) {
        if (q * 8 < n) {
          float xv[8];
          if constexpr (kX32) {
            const float* xr = reinterpret_cast<const float*>(xb) + tid * kRawPitch + q * 8;
            const float4 v0 = *reinterpret_cast<const float4*>(xr);
            const float4 v1 = *reinterpret_cast<const float4*>(xr + 4);
            xv[0] = v0.x; xv[1] = v0.y; xv[2] = v0.z; xv[3] = v0.w;
            xv[4] = v1.x; xv[5] = v1.y; xv[6] = v1.z; xv[7] = v1.w;
          } else {
            const uint4 v = *reinterpret_cast<const uint4*>(xb + tile_offset(tid, q * 8));
            const unsigned wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              xv[2 * e] = __uint_as_float(wv[e] << 16);
              xv[2 * e + 1] = __uint_as_float(wv[e] & 0xffff0000u);
            }
          }
          const float4 c0 = *reinterpret_cast<const float4*>(cw + q * 8);
          const float4 c1 = *reinterpret_cast<const float4*>(cw + q * 8 + 4);
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (q * 8 + e < n) p = fmaf(xv[e], cv[e], p);
        }
      }
    }
  }
  if (tid < kRows && row0 + tid < rows) {
    const int64_t row = row0 + tid;
    const int2 pick = chosen[tid];
    u_out[row] = pick.y ? p : 0.0f;   // nothing found: a row of NaN
    if (codes_u8) static_cast<uint8_t*>(codes_out)[row] = (uint8_t)pick.x;
    else static_cast<int32_t*>(codes_out)[row] = pick.x;
  }
}

// The codebook's exact bf16 pieces, zero past K and dim, in the order the
// kernel stages them: per (codeword tile, chunk), in that order, one
// contiguous codebook chunk of kCodesBytes (piece p's tile at p *
// kTileBytes, tile_offset within).  One thread a pair of values.
__global__ void split_codebook_kernel(const float* __restrict__ cb, int k, int dim, int k_pad,
                                      int d_pad, unsigned char* __restrict__ staged) {
  const int half = d_pad / 2;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)k_pad * half) return;
  const int n = (int)(i / half), e = 2 * (int)(i % half);
  float v0 = 0.0f, v1 = 0.0f;
  if (n < k) {
    if (e < dim) v0 = __ldg(cb + (int64_t)n * dim + e);
    if (e + 1 < dim) v1 = __ldg(cb + (int64_t)n * dim + e + 1);
  }
  unsigned w[3];
  split3(v0, v1, w);
  unsigned char* chunk =
      staged + ((int64_t)(n / kCodes) * (d_pad / kChunk) + e / kChunk) * kCodesBytes;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<unsigned*>(chunk + p * kTileBytes + tile_offset(n % kCodes, e % kChunk)) =
        w[p];
}

int padded_k(int k) { return (k + kCodes - 1) / kCodes * kCodes; }
int padded_dim(int dim) { return (dim + kChunk - 1) / kChunk * kChunk; }

template <typename TIn, int CP>
int launch(const void* x, const float* codebook, int k, int dim, int64_t rows, float* u,
           void* codes, int codes_u8, void* pieces, int cb16, cudaStream_t stream) {
  const int k_pad = padded_k(k), d_pad = padded_dim(dim);
  const int64_t words = (int64_t)k_pad * d_pad / 2;
  split_codebook_kernel<<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      codebook, k, dim, k_pad, d_pad, static_cast<unsigned char*>(pieces));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = hsq_rows_encode_wide_kernel<TIn, CP>;
  constexpr int smem = smem_bytes<TIn>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), codebook, static_cast<const unsigned char*>(pieces), k, dim,
      k_pad, d_pad, rows, u, codes, codes_u8, cb16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch that gqx_hsq_rows_encode_wide needs for the
// codebook's pieces: 3 x K_pad x dim_pad bf16.
int64_t gqx_hsq_rows_encode_wide_scratch_bytes(int k, int dim) {
  return 3LL * padded_k(k) * padded_dim(dim) * 2;
}

// x: (rows, dim) contiguous, bf16 (x_bf16) or float32, every user's rows one
// after another; codebook: (k, dim) float32, raw; u: (rows,) float32; codes:
// (rows,) uint8 (codes_u8, k <= 256) or int32; pieces: scratch of
// gqx_hsq_rows_encode_wide_scratch_bytes(k, dim) bytes, 16-byte aligned.
// Any dim >= 1 and k >= 1.  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a shape outside that.
int gqx_hsq_rows_encode_wide(const void* x, int x_bf16, const float* codebook, int k, int dim,
                             int64_t rows, float* u, void* codes, int codes_u8, void* pieces,
                             void* stream) {
  if (dim < 1 || k < 1 || (codes_u8 && k > 256) || (uintptr_t)pieces % 16)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest copy that every row chunk allows
  const int row_bytes = dim * (x_bf16 ? 2 : 4);
  const uintptr_t base = (uintptr_t)x;
  const int cp = (row_bytes % 16 == 0 && base % 16 == 0) ? 16
                 : (row_bytes % 4 == 0 && base % 4 == 0) ? 4 : 2;
  // u's codewords by 16-byte copies where the codebook's rows allow them
  const int cb16 = dim % 4 == 0 && (uintptr_t)codebook % 16 == 0;
#define GQX_WIDE(T, CP) \
  return launch<T, CP>(x, codebook, k, dim, rows, u, codes, codes_u8, pieces, cb16, s)
  if (x_bf16) {
    if (cp == 16) GQX_WIDE(__nv_bfloat16, 16);
    if (cp == 4) GQX_WIDE(__nv_bfloat16, 4);
    GQX_WIDE(__nv_bfloat16, 2);
  }
  if (cp == 16) GQX_WIDE(float, 16);
  GQX_WIDE(float, 4);
#undef GQX_WIDE
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
