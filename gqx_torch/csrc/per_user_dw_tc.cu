// Per-user convolution weight gradient on Hopper's tensor cores (sm_90a),
// bf16 operands, stride 1, output of the input's size:
//
//   dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
//       xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]
//
// with x (U*B, Ci, H, W) and dy (U*B, Co, H, W) bf16 in NCHW and dW
// (U, Co, Ci, kh, kw) float32 in OIHW.  The products go through
// mma.sync m16n8k16 bf16 -> float32: every bf16 x bf16 product is exact in
// float32, as on the TPU's matrix unit (preferred_element_type=f32).
//
// Replaces: gqx/ops/pallas_dw.py::per_user_dw (_dw_kernel), which views both
// operands as (B*H*W, C), rolls x by each tap's offset, masks the rows of dy
// that wrapped, and contracts on the matrix unit.  Here the roll is an
// address offset into shared memory: a chunk of the user's image rows is
// staged as a padded plane, pixel p = r * P + c with row pitch P = nw + kw - 1
// (nw columns of the image and kw - 1 halo columns), and for each tap
//
//   dW_tap[co, ci] = sum over p of dy[p, co] * x[p + j, ci]
//
// with x staged shifted by the tap row i - ph.  dy is zero in its halo
// columns, so the products that run across the end of a row multiply zero.
//
// What bounds it on the H100: operations.  2*kh*kw*(U*B*H*W)*Ci*Co FLOP
// (19.3 GFLOP for a 3x3 conv of ResNet-50's 64-, 128-, 256- or 512-channel
// stage at 8 users x 32 images: 0.020 ms at the 989 TFLOP/s bf16 peak)
// against at most 67 MB read and 75 MB written.  The CUDA-core kernel
// (per_user_dw.cu) runs the same work as float32 FMAs at 67 TFLOP/s peak;
// this one moves it onto the tensor cores.  The design keeps the tensor cores
// fed from shared memory with ldmatrix, 3 mma per ldmatrix:
//
// - A block of 4 warps owns, for one user, one tap row i, up to three taps
//   j of that row, a 64 x 64 (co x ci) tile and one range of the user's
//   images (batch_splits in ops/dw.py), as the CUDA-core kernel does; a
//   split reduction is added in range order by sum_splits_kernel, so two
//   runs give the same bits.  A warp keeps a 32 x 32 sub-tile for each of
//   its taps: 96 float32 accumulators per thread at three taps.
// - Both operands are staged pixel-major, channels contiguous, 72 bf16
//   (144 B) per pixel: the eight rows of an ldmatrix fall into eight
//   different bank groups, and a row p + j starts 16-byte aligned for every
//   tap j.  (Staged channel-major, a shift by one column breaks ldmatrix's
//   16-byte alignment.)  ldmatrix.trans turns both into mma fragments: dy's
//   (p, co) into A (co x p), x's (p, ci) into B (p x ci).
// - The transpose from NCHW goes through registers: a thread loads eight
//   channels x VEC pixels with VEC-wide loads (VEC = 8 where W % 8 == 0, the
//   widths 32, 16 and 8 of ResNet-50; 4 at W = 4) and stores VEC 16-byte
//   pixels; the eight threads of a store phase hold eight channel groups of
//   one pixel, so the stores do not conflict.
// - Shared memory starts out zero and each chunk stages only the image
//   columns (and dy's zero tail): the halo stays zero.  Only with rows wider
//   than a chunk, cut into column chunks, is the halo loaded each time.
// - Loads and mma overlap across blocks, not inside one: the block stages a
//   chunk of up to kChunk pixels, synchronises, runs its mma loop, and three
//   blocks per multiprocessor keep the tensor cores busy while others load.
//   Staged alone or computed alone, a chunk takes about as long as the
//   other: overlapping the two inside a block is the next step, then wgmma
//   with TMA.
// - The output tile leaves through shared memory, so that a warp stores
//   runs of (ci, tap) of one co.  Stored straight from the accumulators, one
//   float per lane on 32 lines, it was the largest single cost at 4x4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"
#include "per_user_dw_sum.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps, 2 x 2 over the (co, ci) tile
constexpr int kTile = 64;          // output and input channels per block
constexpr int kPitch = kTile + 8;  // bf16 per staged pixel (144 B)
constexpr int kChunk = 192;        // pixels of the padded plane per chunk, at most
constexpr int kJ = 3;              // taps of a row per block
constexpr int kMaxKw = 7;
// 3 blocks of 160-170 registers a thread and at most 56 KB of shared memory
// fit a multiprocessor; ops/dw.py's batch_splits counts on this
constexpr int kBlocksPerSM = 3;
constexpr int kTileRow = kTile * kJ + 1;   // floats per co of the output tile

struct Geometry {
  int users, batch, ci, co, h, w, kh, kw, ph, pw;
  int splits, imgs_per_split;   // the user's images are cut into `splits` ranges
  int cols, rows_per_chunk;     // a chunk: up to rows_per_chunk (image, row) pairs x cols
  int ci_tiles, tap_groups;
};

// The chunk being staged: nr (image, row) pairs from image `img`, row h0,
// columns [w0, w0 + nw), plane pitch P = nw + kw - 1.
struct Chunk {
  int64_t img;
  int h0, nr, w0, nw, pitch;
};

template <int VEC> struct Bits;
template <> struct Bits<8> { using T = uint4; };
template <> struct Bits<4> { using T = uint2; };
template <> struct Bits<2> { using T = unsigned; };
template <> struct Bits<1> { using T = unsigned short; };

template <int VEC>
union Pixels {
  typename Bits<VEC>::T v;
  unsigned short s[VEC];
};

__device__ __forceinline__ unsigned pack(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// One operand of a chunk: tile[p * kPitch + c] holds, for the block's 64
// channels c0 + c of src (C channels), pixel p = r * P + col of the chunk's
// row r: src[image, c, h + dh, w0 + col - off], zero where the channel, the
// row or the column lies outside src or col >= hi.
struct Operand {
  const unsigned short* src;
  unsigned short* tile;
  int C, c0, dh, off;
};

// Load item t of an operand's interior, columns [off, off + nw): VEC pixels
// of eight channels; returns where store_interior puts them.  The eight
// consecutive items of a store phase are the eight channel groups of one
// pixel, so its 16-byte stores fall into distinct banks.
template <int VEC>
__device__ __forceinline__ unsigned short* load_interior(Pixels<VEC> (&px)[8], const Operand& o,
                                                         int t, const Geometry& g, const Chunk& k,
                                                         const FastDiv& by_h, const FastDiv& by_nv) {
  const int grp = t & 7;
  const int cb = o.c0 + grp * 8;
  const int rv = t >> 3;
  const int r = by_nv.div(rv);
  const int v = rv - r * (k.nw / VEC);
  const int db = by_h.div(k.h0 + r);
  const int h = k.h0 + r - db * g.h + o.dh;
  const bool row_ok = h >= 0 && h < g.h;
  const int64_t plane = (int64_t)g.h * g.w;
  const unsigned short* s =
      o.src + ((k.img + db) * o.C + cb) * plane + (int64_t)h * g.w + k.w0 + v * VEC;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (row_ok && cb + c < o.C) {
      px[c].v = __ldg(reinterpret_cast<const typename Bits<VEC>::T*>(s + c * plane));
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) px[c].s[q] = 0;
    }
  }
  return o.tile + (r * k.pitch + o.off + v * VEC) * kPitch + grp * 8;
}

template <int VEC>
__device__ __forceinline__ void store_interior(const Pixels<VEC> (&px)[8], unsigned short* d) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    uint4 o;
    o.x = pack(px[0].s[q], px[1].s[q]);
    o.y = pack(px[2].s[q], px[3].s[q]);
    o.z = pack(px[4].s[q], px[5].s[q]);
    o.w = pack(px[6].s[q], px[7].s[q]);
    *reinterpret_cast<uint4*>(d + q * kPitch) = o;
  }
}

// The interiors of both operands.
template <int VEC>
__device__ __forceinline__ void stage_interiors(const Operand& a, const Operand& b,
                                                const Geometry& g, const Chunk& k,
                                                const FastDiv& by_h) {
  const FastDiv by_nv(k.nw / VEC);
  const int n = 8 * k.nr * (k.nw / VEC);   // items of one operand
  for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
    Pixels<VEC> px[8];
    unsigned short* dst = e < n ? load_interior(px, a, e, g, k, by_h, by_nv)
                                : load_interior(px, b, e - n, g, k, by_h, by_nv);
    store_interior(px, dst);
  }
}

// The rest of an operand's plane, one pixel of eight channels an item: with
// `halo`, the kw - 1 columns outside [off, off + nw) of rows [0, nr) (loaded
// where they lie inside src and col < hi, else zero); then the tail
// [nr * P, n_pix), zero.  Needed only where an earlier chunk of the block
// may have left other data there: the shared memory starts out zero.
__device__ void stage_edges(const Operand& o, const Geometry& g, const Chunk& k,
                            const FastDiv& by_h, int hi, bool halo, int n_pix) {
  const int64_t plane = (int64_t)g.h * g.w;
  const int per_row = k.pitch - k.nw;                       // kw - 1
  const int n_halo = halo ? k.nr * per_row : 0;
  const int total = 8 * (n_halo + n_pix - k.nr * k.pitch);
  const FastDiv by_per_row(per_row);
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int grp = e & 7;
    const int cb = o.c0 + grp * 8;
    const int s = e >> 3;
    unsigned short val[8] = {0, 0, 0, 0, 0, 0, 0, 0};
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
        const unsigned short* src_px =
            o.src + ((k.img + db) * o.C + cb) * plane + (int64_t)h * g.w + w;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (cb + c < o.C) val[c] = src_px[c * plane];
      }
    } else {
      p = k.nr * k.pitch + s - n_halo;
    }
    uint4 v;
    v.x = pack(val[0], val[1]);
    v.y = pack(val[2], val[3]);
    v.z = pack(val[4], val[5]);
    v.w = pack(val[6], val[7]);
    *reinterpret_cast<uint4*>(o.tile + p * kPitch + grp * 8) = v;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
per_user_dw_tc_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
                      float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned short smem[];
  const int k_pad = (g.rows_per_chunk * (g.cols + g.kw - 1) + 15) & ~15;
  unsigned short* ds = smem;                       // (k_pad, kPitch): dy
  unsigned short* xs = smem + k_pad * kPitch;      // (k_pad + kw - 1, kPitch): x

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
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.  A (co x p)
  // from dy's (p, co): matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
  // (k 8-15, m 8-15).  B (p x ci) from x's (p, ci): (k 0-7, n 0-7), (k 8-15, n 0-7),
  // (k 0-7, n 8-15), (k 8-15, n 8-15).
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = wm + (((lane >> 3) & 1) << 3);
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = wn + ((lane >> 4) << 3);
  const unsigned ds_addr = (unsigned)__cvta_generic_to_shared(ds) +
                           2u * (unsigned)(a_row * kPitch + a_col);
  const unsigned xs_addr = (unsigned)__cvta_generic_to_shared(xs) +
                           2u * (unsigned)((j0 + b_row) * kPitch + b_col);

  float acc[kJ][2][4][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][m][n][q] = 0.0f;

  // zero the planes once: halo columns and tails that no chunk writes stay
  // zero (x's tail only has to be finite: it meets dy's zero tail)
  const int smem_vecs = (2 * k_pad + g.kw - 1) * kPitch / 8;
  for (int e = threadIdx.x; e < smem_vecs; e += kThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);

  // with column chunks the last one has another pitch, and its halo is data
  const bool col_chunks = g.cols < g.w;
  const Operand dyo{dy, ds, g.co, co0, 0, 0};
  const Operand xo{x, xs, g.ci, ci0, tap_i - g.ph, g.pw};
  const FastDiv by_h(g.h);
  for (int q0 = 0; q0 < n_rows; q0 += g.rows_per_chunk) {
    Chunk k;
    k.nr = min(g.rows_per_chunk, n_rows - q0);
    const int b0 = q0 / g.h;
    k.img = img0 + b0;
    k.h0 = q0 - b0 * g.h;
    for (k.w0 = 0; k.w0 < g.w; k.w0 += g.cols) {
      k.nw = min(g.cols, g.w - k.w0);
      k.pitch = k.nw + g.kw - 1;
      const int steps = (k.nr * k.pitch + 15) >> 4;
      __syncthreads();   // the previous chunk has been consumed
      stage_interiors<VEC>(dyo, xo, g, k, by_h);
      stage_edges(dyo, g, k, by_h, k.nw, col_chunks, steps * 16);
      if (col_chunks) stage_edges(xo, g, k, by_h, k.pitch, true, k.nr * k.pitch);
      __syncthreads();

      for (int s = 0; s < steps; ++s) {
        const unsigned step_off = 2u * (unsigned)(s * 16 * kPitch);
        unsigned a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) ldsm_x4_trans(a[m], ds_addr + step_off + 2u * 16u * m);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (j < nj) {
            unsigned b[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n)
              ldsm_x4_trans(b[n], xs_addr + step_off + 2u * (unsigned)(j * kPitch + 16 * n));
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int n = 0; n < 4; ++n)
                mma_bf16(acc[j][m][n], a[m], b[n >> 1][(n & 1) * 2], b[n >> 1][(n & 1) * 2 + 1]);
          }
        }
      }
    }
  }

  // (splits, U, Co, Ci, kh, kw): with one split this is the result itself.
  // The tile goes through shared memory, (co, ci, tap) with a padded co row,
  // so that consecutive threads store consecutive (ci, tap) of one co: a
  // warp's store covers a few runs of nj floats, not 32 scattered ones.
  // Accumulator q of an m16n8 tile: row lane / 4 (+ 8 for q >= 2), column
  // 2 (lane % 4) + q % 2.
  __syncthreads();   // every warp is done with the planes
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = wm + 16 * m + (lane >> 2) + 8 * (q >> 1);
        const int ci = wn + 8 * n + 2 * (lane & 3) + (q & 1);
#pragma unroll
        for (int j = 0; j < kJ; ++j) tile[co * kTileRow + ci * kJ + j] = acc[j][m][n][q];
      }
  __syncthreads();
  const int64_t taps = (int64_t)g.kh * g.kw;
  float* dst = out + ((int64_t)split * g.users + u) * g.co * g.ci * taps +
               (int64_t)tap_i * g.kw + j0;
  const int row = kTile * nj;                      // (ci, tap) of one co
  const FastDiv by_row(row), by_nj(nj);
  for (int e = threadIdx.x; e < kTile * row; e += kThreads) {
    const int co = by_row.div(e);
    const int cj = e - co * row;
    const int ci = by_nj.div(cj);
    const int j = cj - ci * nj;
    if (co0 + co < g.co && ci0 + ci < g.ci)
      dst[((int64_t)(co0 + co) * g.ci + ci0 + ci) * taps + j] = tile[co * kTileRow + ci * kJ + j];
  }
}

// Shared memory of a block: the two planes of a chunk, or the output tile.
size_t smem_bytes(int rows_per_chunk, int pitch, int kw) {
  const int k_pad = (rows_per_chunk * pitch + 15) & ~15;
  const size_t planes = sizeof(unsigned short) * kPitch * (2 * (size_t)k_pad + kw - 1);
  const size_t tile = sizeof(float) * kTile * kTileRow;
  return planes > tile ? planes : tile;
}

template <int VEC>
cudaError_t configure(size_t smem) {
  return cudaFuncSetAttribute(per_user_dw_tc_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int VEC>
cudaError_t launch(const unsigned short* x, const unsigned short* dy, float* out, Geometry g,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g.rows_per_chunk, g.cols + g.kw - 1, g.kw);
  const int co_tiles = (g.co + kTile - 1) / kTile;
  dim3 grid(g.ci_tiles * co_tiles, g.kh * g.tap_groups * g.splits, g.users);
  cudaError_t err = configure<VEC>(smem);
  if (err != cudaSuccess) return err;
  per_user_dw_tc_kernel<VEC><<<grid, kThreads, smem, stream>>>(x, dy, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (users*batch, ci, h, w), dy: (users*batch, co, h, w), both bf16,
// contiguous; out: (users, co, ci, kh, kw) float32.  0 <= ph < kh and
// 0 <= pw < kw are the low pads.  The user's images are reduced in `splits`
// ranges; with splits > 1, scratch holds (splits, users, co, ci, kh, kw)
// float32 partial sums, which a second launch adds in range order.  Returns
// cudaGetLastError() after the launches.
int gqx_per_user_dw_tc(const void* x, const void* dy, int users, int batch, int ci, int co,
                       int h, int w, int kh, int kw, int ph, int pw, int splits, float* scratch,
                       float* out, void* stream) {
  if (kw < 1 || kw > kMaxKw || splits < 1 || splits > batch || h >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.users = users; g.batch = batch; g.ci = ci; g.co = co; g.h = h; g.w = w;
  g.kh = kh; g.kw = kw; g.ph = ph; g.pw = pw;
  g.splits = splits;
  g.imgs_per_split = (batch + splits - 1) / splits;
  // whole rows where one fits a chunk, else column chunks of a multiple of 8
  g.cols = w + kw - 1 <= kChunk ? w : (kChunk - (kw - 1)) / 8 * 8;
  g.rows_per_chunk = max(1, min(kChunk / (g.cols + kw - 1), g.imgs_per_split * h));
  g.ci_tiles = (ci + kTile - 1) / kTile;
  g.tap_groups = (kw + kJ - 1) / kJ;
  // the widest loads that every row start allows: w0 is a multiple of 8 and
  // the tensors' starts are aligned to what the loads need
  const uintptr_t align = (uintptr_t)x | (uintptr_t)dy;
  int vec = 8;
  while (vec > 1 && (w % vec != 0 || align % (2 * vec) != 0)) vec /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
  const unsigned short* xb = static_cast<const unsigned short*>(x);
  const unsigned short* db = static_cast<const unsigned short*>(dy);
  cudaError_t err;
  switch (vec) {
    case 8: err = launch<8>(xb, db, dst, g, s); break;
    case 4: err = launch<4>(xb, db, dst, g, s); break;
    case 2: err = launch<2>(xb, db, dst, g, s); break;
    default: err = launch<1>(xb, db, dst, g, s); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(scratch, splits, (int64_t)users * co * ci * kh * kw, out, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
