// Per-user convolution weight gradient of a layer with few input channels
// (the stem's 3) on Hopper's tensor cores (sm_90a), bf16 operands, stride 1,
// output of the input's size:
//
//   dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
//       xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]
//
// with x (U*B, Ci, H, W) and dy (U*B, Co, H, W) bf16 in NCHW and dW
// (U, Co, Ci, kh, kw) float32 in OIHW.  The products go through mma.sync
// m16n8k16 bf16 -> float32: every bf16 x bf16 product is exact in float32.
//
// Replaces: gqx/ops/pallas_dw.py::per_user_dw (_dw_kernel) for bf16 inputs
// with fewer than 16 channels.  The TPU kernel contracts each tap over the
// channel dimension, which is 3 wide here; per_user_dw_tc.cu, which does the
// same on Hopper, would fill 3 of its 64 input-channel columns.  Here each
// user's gradient is one GEMM whose depth is the pixels:
//
//   M = Co (the rows of dy), N = Ci * kh * kw columns n = (ci, i, j),
//   K = the user's B * H * W pixels, B[p, n] = xpad[p shifted by (i, j), ci],
//
// and n runs in the output's own (ci, i, j) order, so a row of the result is
// a row of dW.
//
// What bounds it on the H100: bytes.  dy is 21x the bytes of x at the stem
// (64 against 3 channels) and is read once, 33.5 MB at ResNet-50's 8 x 32
// images of 32 x 32: 0.0105 ms at 3.35 TB/s; its 0.9 GFLOP take 0.001 ms on
// the tensor cores.  So the design is a stream of dy into the mma:
//
// - A (co x pixels) is dy itself: row-major with the pixels contiguous.  It
//   goes from device memory into the A fragments without shared memory.  The
//   order in which a k-step's 16 slots take pixels is free, as long as A and
//   B use the same one; lane (g, t) of a warp loads 8 contiguous pixels
//   8t .. 8t + 7 of row g (one 16-byte load), and of a chunk of 32 pixels
//   k-step s takes pixels 8t + 4s + {0, 1} as slots 2t + {0, 1} and
//   8t + 4s + {2, 3} as slots 2t + 8 + {0, 1}.  A warp's load covers 8 rows
//   x 64 contiguous bytes: whole 32-byte sectors.
// - B (pixels x n) is x shifted by a tap, which no 16-byte load can read in
//   place (a shift by one column is 2 bytes).  A piece of the image (a band
//   of rows) is staged in shared memory as a padded plane per channel, pitch
//   P = W + kw - 1 and kh - 1 halo rows, zero outside the image; column n of
//   pixel (r, w) is then plane[ci][(r + i) * P + w + j], and a lane builds
//   its B fragment from 8 16-bit shared loads of its column.
// - A block of 4 warps owns one user, a 64-row tile of Co, a 32-column tile
//   of N and a range of the user's pieces (narrow_splits in ops/dw.py); a
//   warp takes 2 chunks of 32 pixels at a time, so each warp has 16 loads of
//   16 bytes in flight before it multiplies, and 2 blocks share a
//   multiprocessor.  The 4 warps' sums are added in warp order through shared
//   memory, the ranges' sums in range order by sum_splits_kernel: two runs
//   give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"
#include "per_user_dw_sum.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCo = 64;            // rows of a block: 4 m16 tiles, every warp
constexpr int kTileN = 32;             // columns of a block: 4 n8 tiles
constexpr int kChunk = 32;             // pixels of a warp's two k-steps
constexpr int kUnroll = 2;             // chunks a warp loads before it multiplies
constexpr int kStage = 8;              // x loads a thread keeps in flight while staging
constexpr int kRedPitch = kTileN + 1;  // floats per row of the warps' partial tiles
// 2 blocks per multiprocessor (at 3, the 170 registers a thread spilled
// and were slower: scripts/narrow_probe.py); ops/dw.py's narrow_splits
// counts on this
constexpr int kBlocksPerSM = 2;
constexpr int kMaxKw = 7;
// the staged x of a piece, in bf16 elements, and the loads that may run past
// it stay below 2^16: FastDiv's range
constexpr int kMaxStaged = (1 << 16) - kThreads * kStage;

struct Geometry {
  int users, batch, ci, co, h, w, kh, kw, ph, pw;
  int n;                  // columns: ci * kh * kw
  int band_rows, bands;   // a piece: band_rows rows of one image (fewer in the last band)
  int pieces, pieces_per_split;
  int n_tiles;
};

__device__ __forceinline__ unsigned pack(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8 pixels p .. p + 7 of one dy row of a piece of npx pixels, zero past its
// end or for a row outside Co.  VEC = 8: p and npx are multiples of 8 and the
// row starts 16-byte aligned; VEC = 1: any shape, one pixel a load.
template <int VEC>
__device__ __forceinline__ uint4 load8(const unsigned short* row, bool live, int p, int npx) {
  if constexpr (VEC == 8) {
    return live && p < npx ? __ldg(reinterpret_cast<const uint4*>(row + p))
                           : make_uint4(0u, 0u, 0u, 0u);
  } else {
    unsigned short v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = live && p + e < npx ? __ldg(row + p + e) : 0;
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
per_user_dw_narrow_kernel(const unsigned short* __restrict__ x,
                          const unsigned short* __restrict__ dy, float* __restrict__ out,
                          Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* xs = reinterpret_cast<unsigned short*>(smem);

  const int n_tile = blockIdx.x % g.n_tiles;
  const int co0 = (blockIdx.x / g.n_tiles) * kTileCo;
  const int split = blockIdx.y;
  const int u = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;   // the fragment's row (A, C) or column (B) in its tile
  const int tq = lane & 3;

  const int pitch = g.w + g.kw - 1;
  const int rows_staged = g.band_rows + g.kh - 1;
  const int plane = rows_staged * pitch;   // a channel's staged plane
  const int taps = g.kh * g.kw;
  const int64_t hw = (int64_t)g.h * g.w;

  // the staged offset of this lane's B column in each n8 tile (0, any
  // finite value, past the last column)
  int cbase[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n_tile * kTileN + nt * 8 + gq;
    cbase[nt] = 0;
    if (n < g.n) {
      const int c = n / taps;
      const int t = n - c * taps;
      const int i = t / g.kw;
      cbase[nt] = c * plane + i * pitch + (t - i * g.kw);
    }
  }
  // the lane's two dy rows in each m16 tile, relative to co0
  bool row_live[4][2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) row_live[m][hl] = co0 + m * 16 + gq + 8 * hl < g.co;

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][nt][q] = 0.0f;

  const FastDiv by_w(g.w), by_pitch(pitch);
  const int q_lo = split * g.pieces_per_split;
  const int q_hi = min(g.pieces, q_lo + g.pieces_per_split);
  for (int q = q_lo; q < q_hi; ++q) {
    const int b = q / g.bands;
    const int h0 = (q - b * g.bands) * g.band_rows;
    const int nr = min(g.band_rows, g.h - h0);
    const int64_t img = (int64_t)u * g.batch + b;

    // stage the piece's x: per channel nr + kh - 1 rows of pitch columns,
    // zero outside the image.  Each thread starts kStage loads before it
    // stores the first (one at a time, the staging's round trips outlasted
    // the dy stream).
    __syncthreads();   // the previous piece has been consumed
    const int per_channel = (nr + g.kh - 1) * pitch;
    const int staged = g.ci * per_channel;
    const FastDiv by_channel(per_channel);
    for (int e0 = threadIdx.x; e0 < staged; e0 += kThreads * kStage) {
      unsigned short v[kStage];
      int at[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int e = e0 + k * kThreads;
        const int c = by_channel.div(e);
        const int rem = e - c * per_channel;
        const int rr = by_pitch.div(rem);
        const int cc = rem - rr * pitch;
        const int hh = h0 + rr - g.ph;
        const int ww = cc - g.pw;
        const bool live = e < staged && hh >= 0 && hh < g.h && ww >= 0 && ww < g.w;
        v[k] = live ? __ldg(x + (img * g.ci + c) * hw + (int64_t)hh * g.w + ww) : (unsigned short)0;
        at[k] = c * plane + rem;
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (e0 + k * kThreads < staged) xs[at[k]] = v[k];
    }
    __syncthreads();

    const int npx = nr * g.w;
    const unsigned short* dyp = dy + (img * g.co + co0) * hw + (int64_t)h0 * g.w;
    for (int c0 = warp * kChunk * kUnroll; c0 < npx; c0 += kWarps * kChunk * kUnroll) {
      // every A load of the kUnroll chunks first
      uint4 a[kUnroll][4][2];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
            a[k][m][hl] = load8<VEC>(dyp + (int64_t)(m * 16 + gq + 8 * hl) * hw,
                                     row_live[m][hl], c0 + k * kChunk + 8 * tq, npx);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int p = c0 + k * kChunk + 8 * tq;
        if (p - 8 * tq >= npx) break;   // the whole chunk lies past the piece (warp-uniform)
        // staged offsets of the lane's 8 pixels (0 past the piece: A is zero there)
        int off[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pe = p + e;
          const int r = by_w.div(pe);
          off[e] = pe < npx ? r * pitch + pe - r * g.w : 0;
        }
        // column by column: a B fragment lives only while its 8 mma run
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          unsigned short v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = xs[cbase[nt] + off[e]];
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int m = 0; m < 4; ++m)
              mma_bf16(acc[m][nt], word(a[k][m][0], 2 * s), word(a[k][m][1], 2 * s),
                       word(a[k][m][0], 2 * s + 1), word(a[k][m][1], 2 * s + 1),
                       pack(v[4 * s], v[4 * s + 1]), pack(v[4 * s + 2], v[4 * s + 3]));
        }
      }
    }
  }

  // (splits, U, Co, N): with one split this is the result itself.  The
  // warps' tiles meet in shared memory and are added in warp order.
  // Accumulator q of an m16n8 tile: row gq (+ 8 for q >= 2), column
  // 2 tq + q % 2.
  __syncthreads();   // every warp is done with the planes
  float* red = reinterpret_cast<float*>(smem);   // (kWarps, kTileCo, kRedPitch)
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m * 16 + gq + 8 * (q >> 1);
        const int col = nt * 8 + 2 * tq + (q & 1);
        red[(warp * kTileCo + row) * kRedPitch + col] = acc[m][nt][q];
      }
  __syncthreads();
  float* dst = out + ((int64_t)split * g.users + u) * g.co * g.n;
  for (int e = threadIdx.x; e < kTileCo * kTileN; e += kThreads) {
    const int row = e / kTileN;
    const int col = e - row * kTileN;
    const int co = co0 + row;
    const int n = n_tile * kTileN + col;
    if (co < g.co && n < g.n) {
      float s = red[row * kRedPitch + col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += red[(w * kTileCo + row) * kRedPitch + col];
      dst[(int64_t)co * g.n + n] = s;
    }
  }
}

// Shared memory of a block: the staged planes of a piece, or the warps' tiles.
size_t smem_bytes(const Geometry& g) {
  const size_t planes =
      sizeof(unsigned short) * g.ci * (size_t)(g.band_rows + g.kh - 1) * (g.w + g.kw - 1);
  const size_t tiles = sizeof(float) * kWarps * kTileCo * kRedPitch;
  return planes > tiles ? planes : tiles;
}

template <int VEC>
cudaError_t launch(const unsigned short* x, const unsigned short* dy, float* out, const Geometry& g,
                   int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  const int co_tiles = (g.co + kTileCo - 1) / kTileCo;
  dim3 grid(g.n_tiles * co_tiles, splits, g.users);
  cudaError_t err = cudaFuncSetAttribute(per_user_dw_narrow_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  per_user_dw_narrow_kernel<VEC><<<grid, kThreads, smem, stream>>>(x, dy, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (users*batch, ci, h, w), dy: (users*batch, co, h, w), both bf16,
// contiguous; out: (users, co, ci, kh, kw) float32.  0 <= ph < kh and
// 0 <= pw < kw are the low pads.  A user's images are cut into pieces of
// band_rows rows (fewer in an image's last band), and its pieces into
// `splits` ranges of equal length but the last; with splits > 1, scratch
// holds (splits, users, co, ci, kh, kw) float32 partial sums, which a second
// launch adds in range order.  Returns cudaGetLastError() after the launches.
int gqx_per_user_dw_narrow(const void* x, const void* dy, int users, int batch, int ci, int co,
                           int h, int w, int kh, int kw, int ph, int pw, int band_rows,
                           int splits, float* scratch, float* out, void* stream) {
  if (kw < 1 || kw > kMaxKw || band_rows < 1 || band_rows > h || splits < 1 ||
      w >= (1 << 15) || band_rows * w > (1 << 16) - 64)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.users = users; g.batch = batch; g.ci = ci; g.co = co; g.h = h; g.w = w;
  g.kh = kh; g.kw = kw; g.ph = ph; g.pw = pw;
  g.n = ci * kh * kw;
  g.band_rows = band_rows;
  g.bands = (h + band_rows - 1) / band_rows;
  g.pieces = batch * g.bands;
  g.pieces_per_split = (g.pieces + splits - 1) / splits;
  g.n_tiles = (g.n + kTileN - 1) / kTileN;
  if (splits > g.pieces || (int64_t)ci * (band_rows + kh - 1) * (w + kw - 1) > kMaxStaged)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads of dy where every piece starts on one: each dy row of a
  // piece starts at a multiple of 8 pixels from an aligned base
  const int64_t hw = (int64_t)h * w;
  const bool vec8 = hw % 8 == 0 && ((int64_t)band_rows * w) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
  const unsigned short* xb = static_cast<const unsigned short*>(x);
  const unsigned short* db = static_cast<const unsigned short*>(dy);
  cudaError_t err = vec8 ? launch<8>(xb, db, dst, g, splits, s) : launch<1>(xb, db, dst, g, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(scratch, splits, (int64_t)users * co * g.n, out, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
