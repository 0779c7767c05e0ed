// Per-user convolution weight gradient of float32 inputs on Hopper's tensor
// cores (sm_90a), stride 1, output of the input's size:
//
//   dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
//       xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]
//
// with x (U*B, Ci, H, W) and dy (U*B, Co, H, W) float32 in NCHW and dW
// (U, Co, Ci, kh, kw) float32 in OIHW.  This is the route of float32 inputs
// with 16 input channels or more and kw <= 7 (ops/dw.py::route): the 3x3
// convs of a float32 ResNet past the stem.  The stem keeps the CUDA-core
// kernel (per_user_dw.cu), bf16 inputs take per_user_dw_tc.cu.
//
// Replaces: gqx/ops/pallas_dw.py::per_user_dw (_dw_kernel) for float32
// inputs, which contracts on the TPU's matrix unit at float32 accuracy.
//
// What it computes: float32-accurate products from exact bf16 pieces.
//   Every float32 v splits exactly into three bf16 values, v = h + m + l:
//   h = bf16_rn(v), m = bf16_rn(v - h), l = v - h - m (24 = 8 + 8 + 8
//   significand bits; exact for |v| from 2^-110 up to the largest bf16, and
//   for 0; ops/hsq_prep.py::split_bf16_3, kernel_util.cuh's split3).
//   A bf16 x bf16 product is exact in float32.  Of the nine cross products
//   of dy's and x's pieces the six largest are kept, (dy, x) = mm, hl, lh,
//   hm, mh, hh; the dropped ml, lm and ll are below 2^-23 |x| |dy| per
//   product together.  The tensor cores' float32 additions round toward
//   zero, at the scale of the accumulator they add into: so hh goes into one
//   set of accumulators, one rounding a step as in the bf16 kernel, and the
//   five smaller products, smallest first, into a second set, whose
//   roundings are 2^-8 smaller; the two are added once at the end, rounded
//   to nearest.  All six summed straight into one set came close to the
//   tolerance below at 512 -> 512 @4x4; each step's six summed from zero
//   and added with a rounded float32 add was accurate but slower (the
//   probe's "one set" and "step sums" variants).  The product arithmetic
//   is emulated on the CPU by tests/test_torch_dw.py, and
//   tests/test_torch_cuda.py holds the kernel to sqrt(n) * 2^-23 of the
//   summed magnitudes against the plain version.
//
// What bounds it on the H100: operations.  2*kh*kw*(U*B*H*W)*Ci*Co FLOP
// (19.3 GFLOP for a 3x3 conv of a ResNet's 64-, 128-, 256- or 512-channel
// stage at 8 users x 32 images): 0.29 ms at the float32 peak of the CUDA
// cores (67 TFLOP/s), where per_user_dw.cu does it; six bf16 passes on the
// tensor cores, 0.117 ms at their 989 TFLOP/s.  Against at most 134 MB
// read and 75 MB written.  The design is per_user_dw_tc.cu's (padded plane,
// one tile per tap, fixed-order split reduction), with six mma per
// fragment pair where the bf16 kernel has one, so more tensor-core work
// stands behind each staged byte:
//
// - A block of 4 warps owns, for one user, one tap row i, up to three taps
//   j of that row, a 64 x 64 (co x ci) tile and one range of the user's
//   images (batch_splits in ops/dw.py); a split reduction is added in range
//   order by sum_splits_kernel, so two runs give the same bits.  A warp
//   keeps a 32 x 32 sub-tile for each of its taps in both sets: 192 float32
//   accumulators per thread at three taps, so two blocks a multiprocessor.
// - A chunk of the user's image rows is staged as a padded plane, pixel
//   p = r * P + c with row pitch P = nw + kw - 1: each operand as three
//   piece planes, pixel-major, 72 bf16 (144 B) per pixel, so that
//   ldmatrix.trans gives dy's (p, co) as A (co x p) and x's (p, ci) as B
//   (p x ci) for every piece and every tap's shift.  A chunk holds at most
//   kInterior (64) image pixels and kChunk (80) plane pixels: six planes of
//   up to 86 pixels, 74 KB, beside a 32 KB raw buffer.
// - The float32 values go from NCHW into the raw buffer by cp.async (16
//   bytes, 4 pixels of a channel, at W % 4 == 0; 8 or 4 bytes at other
//   widths), with no registers; after a barrier, each thread splits 8
//   channels x VEC pixels of it and stores them as three 16-byte pixels,
//   one per piece plane.  The eight threads of a phase hold the eight
//   channel groups of one pixel: the piece stores do not conflict, and the
//   raw buffer's 16-byte units are swizzled by channel group so that the
//   reads do not either.  The pieces are made once per staged value and
//   read by every tap.
// - Per 16-pixel step a warp loads 6 A fragments (3 pieces x 2 row tiles)
//   and per tap 6 B fragments, and issues 6 x 8 mma per tap: 144 mma per
//   24 ldmatrix at three taps.  The B fragments go a half tile (16 ci) at a
//   time, so the loop holds 192 accumulators, 24 A and 12 B registers.
// - A chunk is copied, split and stored between two barriers; the other
//   block of the multiprocessor runs its mma meanwhile.  Issuing the next
//   chunk's copies before this chunk's mma loop, so that the loads run
//   under the mma, measured slower: the copies' addresses then live across
//   the loop beside the 192 accumulators and the registers spill (the
//   "overlap" variant of gqx_torch/scripts/dw_f32_probe.py; PERF.md section
//   6).  Copying by cp.async, one index computation per 8 channels, beat
//   loading through registers (8 x VEC values a thread at a time, which
//   fitted beside the accumulators only one item deep).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"
#include "per_user_dw_sum.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps, 2 x 2 over the (co, ci) tile
constexpr int kTile = 64;          // output and input channels per block
constexpr int kPitch = kTile + 8;  // bf16 per staged pixel of a piece (144 B)
constexpr int kChunk = 80;         // pixels of the padded plane per chunk, at most
constexpr int kInterior = 64;      // image pixels per chunk, at most (a multiple of 32)
constexpr int kJ = 3;              // taps of a row per block
constexpr int kMaxKw = 7;
constexpr int kPieces = 3;         // h, m, l
// 2 blocks of at most 255 registers a thread (the two sets of accumulators
// take 192) and 106 KB of shared memory (the planes and the raw buffer) fit
// a multiprocessor; ops/dw.py's batch_splits counts on this
constexpr int kBlocksPerSM = 2;
constexpr int kTileRow = kTile * kJ + 1;   // floats per co of the output tile
// the kept cross products, smallest first, as (dy piece, x piece): mm, hl,
// lh, hm, mh, hh (piece 0 = h, 1 = m, 2 = l)
__host__ __device__ constexpr int pass_a(int i) { return i == 0 || i == 4 ? 1 : i == 2 ? 2 : 0; }
__host__ __device__ constexpr int pass_b(int i) { return i == 0 || i == 3 ? 1 : i == 1 ? 2 : 0; }

struct Geometry {
  int users, batch, ci, co, h, w, kh, kw, ph, pw;
  int splits, imgs_per_split;   // the user's images are cut into `splits` ranges
  int cols, rows_per_chunk;     // a chunk: up to rows_per_chunk (image, row) pairs x cols
  int ci_tiles, tap_groups;
};

// The chunk being staged: nr (image, row) pairs from the block's pair q0
// (image `img`, row h0), columns [w0, w0 + nw), plane pitch P = nw + kw - 1.
struct Chunk {
  int64_t img;
  int q0, h0, nr, w0, nw, pitch;
};

__device__ __forceinline__ Chunk make_chunk(const Geometry& g, int64_t img0, int n_rows, int q0,
                                            int w0) {
  Chunk k;
  k.q0 = q0;
  k.nr = min(g.rows_per_chunk, n_rows - q0);
  const int b0 = q0 / g.h;
  k.img = img0 + b0;
  k.h0 = q0 - b0 * g.h;
  k.w0 = w0;
  k.nw = min(g.cols, g.w - w0);
  k.pitch = k.nw + g.kw - 1;
  return k;
}

template <int VEC> struct Floats;
template <> struct Floats<4> { using T = float4; };
template <> struct Floats<2> { using T = float2; };
template <> struct Floats<1> { using T = float; };

template <int VEC>
union Pixels {
  typename Floats<VEC>::T v;
  float f[VEC];
};

// The pieces of eight channels of one pixel into the three piece planes
// (plane elements apart) at d.
__device__ __forceinline__ void store_pixel(const float (&v)[8], unsigned short* d, int plane) {
  unsigned w[4][kPieces];
#pragma unroll
  for (int c = 0; c < 4; ++c) split3(v[2 * c], v[2 * c + 1], w[c]);
#pragma unroll
  for (int s = 0; s < kPieces; ++s)
    *reinterpret_cast<uint4*>(d + s * plane) = make_uint4(w[0][s], w[1][s], w[2][s], w[3][s]);
}

// One operand of a chunk: piece s of tile[p * kPitch + c] (s * plane
// further) holds, for the block's 64 channels c0 + c of src (C channels),
// pixel p = r * P + col of the chunk's row r: src[image, c, h + dh, w0 +
// col - off], zero where the channel, the row or the column lies outside
// src or col >= hi.
struct Operand {
  const float* src;
  int tile;                     // offset of the first piece plane in the block's smem
  int C, c0, dh, off;
};

// The raw buffer: per operand and channel c of the block's 64, the chunk's
// interior values i = r * nw + col (at most kInterior) as float32, in
// 16-byte units whose index is XORed with c / 8 (so kInterior / 4 must be a
// multiple of 8), so that the eight channel groups that convert_operand
// reads in one phase fall into distinct banks.
__device__ __forceinline__ int raw_index(int op, int c, int i) {
  return (op * kTile + c) * kInterior + ((((i >> 2) ^ (c >> 3)) << 2) | (i & 3));
}

// Copy VEC floats from global to shared memory without registers; zeros
// where !valid (the source is then not read).
template <int VEC>
__device__ __forceinline__ void cp_async(unsigned dst, const float* src, bool valid) {
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(4 * VEC), "r"(valid ? 4 * VEC : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying an operand's interior of chunk k into the raw buffer
// (operand op): an item is VEC pixels of eight channels, one copy a
// channel; the eight consecutive items of a phase are the eight channel
// groups of the same pixels.
template <int VEC>
__device__ __forceinline__ void copy_operand(const Operand& o, int op, unsigned raw_addr,
                                             const Geometry& g, const Chunk& k,
                                             const FastDiv& by_h) {
  const int nvv = k.nw / VEC;
  const int n = 8 * k.nr * nvv;                 // items
  const FastDiv by_nvv(nvv);
  const int64_t plane = (int64_t)g.h * g.w;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int grp = t & 7;
    const int cb = o.c0 + grp * 8;
    const int rv = t >> 3;
    const int r = by_nvv.div(rv);
    const int v = rv - r * nvv;
    const int db = by_h.div(k.h0 + r);
    const int h = k.h0 + r - db * g.h + o.dh;
    const bool row_ok = h >= 0 && h < g.h;
    const float* src = o.src + ((k.img + db) * o.C + cb) * plane + (int64_t)h * g.w + k.w0 + v * VEC;
    const unsigned dst = raw_addr + 4u * (unsigned)raw_index(op, grp * 8, r * k.nw + v * VEC);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool valid = row_ok && cb + c < o.C;
      cp_async<VEC>(dst + 4u * (unsigned)(c * kInterior), valid ? src + c * plane : o.src, valid);
    }
  }
}

// The raw buffer of an operand (op) into its piece planes: each thread
// splits the values of its items and stores them as three 16-byte pixels
// per pixel.  The eight threads of a phase hold the eight channel groups of
// one pixel, so neither the raw reads nor the piece stores conflict.
template <int VEC>
__device__ __forceinline__ void convert_operand(const Operand& o, int op, const float* raw,
                                                unsigned short* smem, int plane, const Chunk& k) {
  const int nvv = k.nw / VEC;
  const int n = 8 * k.nr * nvv;                 // items
  const FastDiv by_nvv(nvv);
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int grp = t & 7;
    const int rv = t >> 3;
    const int r = by_nvv.div(rv);
    const int v = rv - r * nvv;
    const float* src = raw + raw_index(op, grp * 8, r * k.nw + v * VEC);
    Pixels<VEC> px[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      px[c].v = *reinterpret_cast<const typename Floats<VEC>::T*>(src + c * kInterior);
    unsigned short* d = smem + o.tile + (r * k.pitch + o.off + v * VEC) * kPitch + grp * 8;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      float val[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) val[c] = px[c].f[q];
      store_pixel(val, d + q * kPitch, plane);
    }
  }
}

// The rest of an operand's plane, one pixel of eight channels an item: with
// `halo`, the kw - 1 columns outside [off, off + nw) of rows [0, nr) (loaded
// where they lie inside src and col < hi, else zero); then the tail
// [nr * P, n_pix), zero.  Needed only where an earlier chunk of the block
// may have left other data there: the shared memory starts out zero.
__device__ void stage_edges(const Operand& o, unsigned short* smem, int plane, const Geometry& g,
                            const Chunk& k, const FastDiv& by_h, int hi, bool halo, int n_pix) {
  const int64_t src_plane = (int64_t)g.h * g.w;
  const int per_row = k.pitch - k.nw;                       // kw - 1
  const int n_halo = halo ? k.nr * per_row : 0;
  const int total = 8 * (n_halo + n_pix - k.nr * k.pitch);
  const FastDiv by_per_row(per_row);
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int grp = e & 7;
    const int cb = o.c0 + grp * 8;
    const int s = e >> 3;
    float val[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int p;
    if (s < n_halo) {
      const int r = by_per_row.div(s);
      const int x = s - r * per_row;
      const int col = x < o.off ? x : x + k.nw;
      p = r * k.pitch + col;
      const int db = by_h.div(k.h0 + r);
      const int h = k.h0 + r - db * g.h + o.dh;
      const int w = k.w0 + col - o.off;
      if (col < hi && h >= 0 && h < g.h && w >= 0 && w < g.w) {
        const float* src_px =
            o.src + ((k.img + db) * o.C + cb) * src_plane + (int64_t)h * g.w + w;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (cb + c < o.C) val[c] = src_px[c * src_plane];
      }
    } else {
      p = k.nr * k.pitch + s - n_halo;
    }
    store_pixel(val, smem + o.tile + p * kPitch + grp * 8, plane);
  }
}

// d += A B, bf16 operands, float32 sums; no side effects, so the compiler
// may interleave the mma of independent tiles.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
per_user_dw_tc_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned short smem[];
  const int k_pad = (g.rows_per_chunk * (g.cols + g.kw - 1) + 15) & ~15;
  // six planes of (k_pad + kw - 1, kPitch) bf16: dy's h, m, l, then x's
  const int plane = (k_pad + g.kw - 1) * kPitch;

  const int ci0 = (blockIdx.x % g.ci_tiles) * kTile;
  const int co0 = (blockIdx.x / g.ci_tiles) * kTile;
  const int tap_i = blockIdx.y % g.kh;
  const int rest = blockIdx.y / g.kh;
  const int j0 = (rest % g.tap_groups) * kJ;       // the block's taps j0 .. j0 + nj - 1
  const int nj = min(kJ, g.kw - j0);
  const int split = rest / g.tap_groups;
  const int u = blockIdx.z;

  const int b_lo = split * g.imgs_per_split;
  const int b_hi = min(g.batch, b_lo + g.imgs_per_split);
  const int n_rows = max(b_hi - b_lo, 0) * g.h;    // (image, row) pairs
  const int64_t img0 = (int64_t)u * g.batch + b_lo;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;                 // the warp's co and ci offsets in the tile
  const int wn = (warp & 1) * 32;
  // ldmatrix row addresses, as in per_user_dw_tc.cu: lane l feeds row l % 8
  // of matrix l / 8.  A (co x p) from dy's (p, co): matrices (k 0-7, m 0-7),
  // (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15).  B (p x ci) from x's
  // (p, ci): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = wm + (((lane >> 3) & 1) << 3);
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = wn + ((lane >> 4) << 3);
  const unsigned smem_addr = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned piece_bytes = 2u * (unsigned)plane;
  const unsigned ds_addr = smem_addr + 2u * (unsigned)(a_row * kPitch + a_col);
  const unsigned xs_addr = smem_addr + 3u * piece_bytes +
                           2u * (unsigned)((j0 + b_row) * kPitch + b_col);

  // hh in acc, the five smaller products in lo (2^-8 of acc and less)
  float acc[kJ][2][4][4], lo[kJ][2][4][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][m][n][q] = lo[j][m][n][q] = 0.0f;

  // zero the planes once: halo columns and tails that no chunk writes stay
  // zero (x's tail only has to be finite: it meets dy's zero tail)
  const int smem_vecs = 2 * kPieces * plane / 8;
  for (int e = threadIdx.x; e < smem_vecs; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);

  // with column chunks the last one has another pitch, and its halo is data
  const bool col_chunks = g.cols < g.w;
  const Operand dyo{dy, 0, g.co, co0, 0, 0};
  const Operand xo{x, kPieces * plane, g.ci, ci0, tap_i - g.ph, g.pw};
  const FastDiv by_h(g.h);
  float* raw = reinterpret_cast<float*>(smem + 2 * kPieces * plane);
  const unsigned raw_addr = smem_addr + 4u * (unsigned)kPieces * plane;

  // an empty range (batch_splits leaves none) writes its zero tile
  Chunk k = make_chunk(g, img0, n_rows, 0, 0);
  while (n_rows > 0) {
    const int steps = (k.nr * k.pitch + 15) >> 4;
    copy_operand<VEC>(dyo, 0, raw_addr, g, k, by_h);
    copy_operand<VEC>(xo, 1, raw_addr, g, k, by_h);
    cp_async_wait_all();
    __syncthreads();   // the chunk's raw values are in; the previous chunk is consumed
    convert_operand<VEC>(dyo, 0, raw, smem, plane, k);
    convert_operand<VEC>(xo, 1, raw, smem, plane, k);
    stage_edges(dyo, smem, plane, g, k, by_h, k.nw, col_chunks, steps * 16);
    if (col_chunks) stage_edges(xo, smem, plane, g, k, by_h, k.pitch, true, k.nr * k.pitch);
    __syncthreads();   // the pieces are in; the raw buffer is free

    // the next chunk: the next columns of these rows, else the next rows
    int q0 = k.q0, w0 = k.w0 + g.cols;
    if (w0 >= g.w) { w0 = 0; q0 += g.rows_per_chunk; }
    const bool more = q0 < n_rows;
    const Chunk next = more ? make_chunk(g, img0, n_rows, q0, w0) : k;

#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const unsigned step_off = 2u * (unsigned)(s * 16 * kPitch);
      unsigned a[kPieces][2][4];
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldsm_x4_trans(a[p][m], ds_addr + p * piece_bytes + step_off + 2u * 16u * m);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j < nj) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // the warp's ci columns 16h .. 16h + 15
            unsigned b[kPieces][4];
#pragma unroll
            for (int p = 0; p < kPieces; ++p)
              ldsm_x4_trans(b[p], xs_addr + p * piece_bytes + step_off +
                                      2u * (unsigned)(j * kPitch + 16 * h));
#pragma unroll
            for (int pass = 0; pass < 6; ++pass)
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                  const unsigned(&aa)[4] = a[pass_a(pass)][m];
                  const unsigned b0 = b[pass_b(pass)][2 * n], b1 = b[pass_b(pass)][2 * n + 1];
                  if (pass < 5) mma_bf16(lo[j][m][2 * h + n], aa, b0, b1);
                  else mma_bf16(acc[j][m][2 * h + n], aa, b0, b1);
                }
          }
        }
      }
    }
    if (!more) break;
    k = next;
  }

  // (splits, U, Co, Ci, kh, kw): with one split this is the result itself.
  // The tile goes through shared memory, (co, ci, tap) with a padded co row,
  // so that consecutive threads store consecutive (ci, tap) of one co.
  // Accumulator q of an m16n8 tile: row lane / 4 (+ 8 for q >= 2), column
  // 2 (lane % 4) + q % 2.
  __syncthreads();   // every warp is done with the planes
  float* tile = reinterpret_cast<float*>(smem);
  // the two sets, added once with a float32 add rounded to nearest
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = wm + 16 * m + (lane >> 2) + 8 * (q >> 1);
        const int ci = wn + 8 * n + 2 * (lane & 3) + (q & 1);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          tile[co * kTileRow + ci * kJ + j] = acc[j][m][n][q] + lo[j][m][n][q];
      }
  __syncthreads();
  const int64_t taps = (int64_t)g.kh * g.kw;
  float* dst_out = out + ((int64_t)split * g.users + u) * g.co * g.ci * taps +
                   (int64_t)tap_i * g.kw + j0;
  const int row = kTile * nj;                      // (ci, tap) of one co
  const FastDiv by_row(row), by_nj(nj);
  for (int e = threadIdx.x; e < kTile * row; e += kThreads) {
    const int co = by_row.div(e);
    const int cj = e - co * row;
    const int ci = by_nj.div(cj);
    const int j = cj - ci * nj;
    if (co0 + co < g.co && ci0 + ci < g.ci)
      dst_out[((int64_t)(co0 + co) * g.ci + ci0 + ci) * taps + j] =
          tile[co * kTileRow + ci * kJ + j];
  }
}

// Shared memory of a block: the six piece planes of a chunk and the raw
// buffer of the next, or the output tile.
size_t smem_bytes(int rows_per_chunk, int pitch, int kw) {
  const int k_pad = (rows_per_chunk * pitch + 15) & ~15;
  const size_t planes = sizeof(unsigned short) * 2 * kPieces * kPitch * ((size_t)k_pad + kw - 1) +
                        sizeof(float) * 2 * kTile * kInterior;
  const size_t tile = sizeof(float) * kTile * kTileRow;
  return planes > tile ? planes : tile;
}

template <int VEC>
cudaError_t launch(const float* x, const float* dy, float* out, Geometry g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.rows_per_chunk, g.cols + g.kw - 1, g.kw);
  const int co_tiles = (g.co + kTile - 1) / kTile;
  dim3 grid(g.ci_tiles * co_tiles, g.kh * g.tap_groups * g.splits, g.users);
  cudaError_t err = cudaFuncSetAttribute(per_user_dw_tc_f32_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  per_user_dw_tc_f32_kernel<VEC><<<grid, kThreads, smem, stream>>>(x, dy, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (users*batch, ci, h, w), dy: (users*batch, co, h, w), both float32,
// contiguous; out: (users, co, ci, kh, kw) float32.  0 <= ph < kh and
// 0 <= pw < kw are the low pads.  The user's images are reduced in `splits`
// ranges; with splits > 1, scratch holds (splits, users, co, ci, kh, kw)
// float32 partial sums, which a second launch adds in range order.  Returns
// cudaGetLastError() after the launches.
int gqx_per_user_dw_tc_f32(const void* x, const void* dy, int users, int batch, int ci, int co,
                           int h, int w, int kh, int kw, int ph, int pw, int splits,
                           float* scratch, float* out, void* stream) {
  if (kw < 1 || kw > kMaxKw || splits < 1 || splits > batch || h >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.users = users; g.batch = batch; g.ci = ci; g.co = co; g.h = h; g.w = w;
  g.kh = kh; g.kw = kw; g.ph = ph; g.pw = pw;
  g.splits = splits;
  g.imgs_per_split = (batch + splits - 1) / splits;
  // whole rows where a row fits a chunk's kInterior pixels, else column
  // chunks of kInterior (a multiple of every load width)
  g.cols = min(w, kInterior);
  g.rows_per_chunk = max(1, min(min(kChunk / (g.cols + kw - 1), kInterior / g.cols),
                                g.imgs_per_split * h));
  g.ci_tiles = (ci + kTile - 1) / kTile;
  g.tap_groups = (kw + kJ - 1) / kJ;
  // the widest loads that every row start allows: w0 is a multiple of
  // kInterior and the tensors' starts are aligned to what the loads need
  const uintptr_t align = (uintptr_t)x | (uintptr_t)dy;
  int vec = 4;
  while (vec > 1 && (w % vec != 0 || align % (4 * vec) != 0)) vec /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  cudaError_t err;
  switch (vec) {
    case 4: err = launch<4>(xf, df, dst, g, s); break;
    case 2: err = launch<2>(xf, df, dst, g, s); break;
    default: err = launch<1>(xf, df, dst, g, s); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(scratch, splits, (int64_t)users * co * ci * kh * kw, out, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
