// Per-user convolution weight gradient of a float32 layer with few input
// channels (the stem's 3) on Hopper's tensor cores (sm_90a), stride 1,
// output of the input's size:
//
//   dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
//       xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]
//
// with x (U*B, Ci, H, W) and dy (U*B, Co, H, W) float32 in NCHW and dW
// (U, Co, Ci, kh, kw) float32 in OIHW.  This is the route of float32 inputs
// with fewer than 16 input channels and kw <= 7 (ops/dw.py::route).
//
// Replaces: gqx/ops/pallas_dw.py::per_user_dw (_dw_kernel) for float32
// inputs with fewer than 16 channels.  The TPU kernel contracts each tap
// over the channel dimension, 3 wide here.  As in per_user_dw_narrow.cu
// (the bf16 route of these layers), each user's gradient is one GEMM whose
// depth is the pixels:
//
//   M = Co (the rows of dy), N = Ci * kh * kw columns n = (ci, i, j),
//   K = the user's B * H * W pixels, B[p, n] = xpad[p shifted by (i, j), ci],
//
// with n in the output's own (ci, i, j) order, so a row of the result is a
// row of dW.
//
// What it computes: float32-accurate products from exact bf16 pieces, as
// per_user_dw_tc_f32.cu does.  Every float32 v splits exactly into three
// bf16 values, v = h + m + l (kernel_util.cuh's split3,
// ops/hsq_prep.py::split_bf16_3); a bf16 x bf16 product is exact in
// float32.  Of the nine cross products of dy's and x's pieces the six
// largest are kept, (dy, x) = mm, hl, lh, hm, mh, hh.  The tensor cores'
// float32 additions round toward zero at the scale of the accumulator, so
// hh goes into one set of accumulators and the five smaller products,
// smallest first, into a second, whose roundings are 2^-8 smaller; the two
// are added once at the end, rounded to nearest.  tests/test_torch_dw.py
// models this order of sums on the CPU; tests/test_torch_cuda.py holds the
// kernel to sqrt(n) * 2^-23 of the summed magnitudes.
//
// What bounds it on the H100: bytes.  dy is 21x the bytes of x at the stem
// (64 against 3 channels) and is read once: 67.1 MB at ResNet-50's 8 x 32
// images of 32 x 32, 0.020 ms at 3.35 TB/s; its six bf16 passes (5.4
// GFLOP) take 0.006 ms on the tensor cores.  So the design is
// per_user_dw_narrow.cu's stream of dy into the mma:
//
// - A (co x pixels) is dy itself, streamed from device memory without
//   registers: each warp copies its own chunks of 32 pixels x 64 rows (8 KB)
//   by cp.async into a private ring of two stages in shared memory, the next
//   chunk in flight while it multiplies this one; each lane copies only the
//   16-byte units that it reads back, so no barrier orders the ring, only the
//   lane's own cp.async.wait_group.  Lane (g, t) holds pixels 16s + 4t ..
//   16s + 4t + 3 of row g of a chunk for s = 0, 1, and k-step s of the
//   chunk takes pixels 16s + 4t + {0, 1} as slots 2t + {0, 1} and 16s + 4t
//   + {2, 3} as slots 2t + 8 + {0, 1}: a k-step is 16 consecutive pixels,
//   and each copy instruction of a warp moves 64 contiguous bytes of each of
//   8 rows, whole 32-byte sectors (with a lane's 8 pixels contiguous
//   instead, each copy took half sectors and the kernel was 1.4x slower).
//   The lane splits each pair into its three pieces in registers: three A
//   fragments per k-step, made once and used by every column tile.
// - B (pixels x n) is x shifted by a tap.  A piece of the image (a band of
//   rows) is staged in shared memory as a padded plane per channel, pitch
//   P = W + kw - 1 and kh - 1 halo rows, zero outside the image: its
//   float32 values copied by cp.async in one round trip into a raw buffer
//   (while the first chunks of dy are in flight), then split once, element
//   e holding (h | m << 16, l) in 8 bytes, so that one 64-bit shared load
//   brings a value's three pieces and two byte permutations pack two
//   pixels' pieces into a fragment word.
// - A block of 4 warps owns one user, a 64-row tile of Co, a 32-column tile
//   of N and a range of the user's pieces (narrow_splits in ops/dw.py).  A
//   thread keeps 2 x 64 accumulators; two blocks share a multiprocessor.
//   The 4 warps' sums are added in warp order through shared memory, the
//   ranges' sums in range order by sum_splits_kernel: two runs give the
//   same bits.
//
// gqx_torch/scripts/narrow_f32_probe.py times this kernel against variants
// of its own source (one accumulator set, 1 block per multiprocessor, half
// sectors, k-steps unrolled, no B loads, no mma, no split).  At the stem it
// reaches about 60% of the bound; without the mma it is about 10% faster,
// without the B loads or the split no faster: the dy stream and the fixed
// costs (staging, the ordered sum of the ranges) set its pace (PERF.md).

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
constexpr int kRing = 2;               // chunks of a warp's ring of dy in shared memory
constexpr int kUnits = 16;             // 16-byte units of dy a lane holds per chunk
constexpr int kRingStage = kUnits * 32 * 16;              // a warp's chunk: 8 KB
constexpr int kRingBytes = kWarps * kRing * kRingStage;   // 64 KB
constexpr int kRedPitch = kTileN + 1;  // floats per row of the warps' partial tiles
// ops/dw.py's narrow_splits counts on this
constexpr int kBlocksPerSM = 2;
constexpr int kMaxKw = 7;
// the staged x of a piece, in elements (8 bytes of pieces and 4 of raw
// value): it fits a block's 227 KB beside the ring, below 2^16 (FastDiv's
// range)
constexpr int kMaxStaged = (232448 - kRingBytes) / 12;

struct Geometry {
  int users, batch, ci, co, h, w, kh, kw, ph, pw;
  int n;                  // columns: ci * kh * kw
  int band_rows, bands;   // a piece: band_rows rows of one image (fewer in the last band)
  int pieces, pieces_per_split;
  int n_tiles;
};

// the kept cross products, smallest first, as (dy piece, x piece): mm, hl,
// lh, hm, mh, hh (piece 0 = h, 1 = m, 2 = l)
__host__ __device__ constexpr int pass_a(int i) { return i == 0 || i == 4 ? 1 : i == 2 ? 2 : 0; }
__host__ __device__ constexpr int pass_b(int i) { return i == 0 || i == 3 ? 1 : i == 1 ? 2 : 0; }

// d += A B, bf16 operands, float32 sums; no side effects, so the compiler
// may interleave the mma of independent tiles.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy 4 pixels p .. p + 3 of one dy row of a piece of npx pixels into a
// 16-byte unit of shared memory at dst, zero past its end or for a row
// outside Co (then `any`, a valid address, stands for the source, which is
// not read).  VEC = 4: p and npx are multiples of 4 and the row starts
// 16-byte aligned; VEC = 1: any shape, one pixel a copy.
template <int VEC>
__device__ __forceinline__ void copy4(unsigned dst, const float* row, bool live, int p, int npx,
                                      const float* any) {
  if constexpr (VEC == 4) {
    const bool valid = live && p < npx;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(valid ? row + p : any), "r"(valid ? 16 : 0) : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = live && p + e < npx;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(dst + 4u * e), "l"(valid ? row + p + e : any), "r"(valid ? 4 : 0)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A staged element: the three pieces of v as (h | m << 16, l).
__device__ __forceinline__ uint2 staged_pieces(float v) {
  unsigned w[3];
  split3(v, 0.0f, w);
  return make_uint2((w[0] & 0xFFFFu) | (w[1] << 16), w[2] & 0xFFFFu);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
per_user_dw_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                              float* __restrict__ out, Geometry g) {
  // the warps' rings of dy, the staged planes of x, the raw buffer of x
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* xs = reinterpret_cast<uint2*>(smem + kRingBytes);

  const int n_tile = blockIdx.x % g.n_tiles;
  const int co0 = (blockIdx.x / g.n_tiles) * kTileCo;
  const int split = blockIdx.y;
  const int u = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;   // the fragment's row (A, C) or column (B) in its tile
  const int tq = lane & 3;
  // the lane's 16-byte units of the warp's ring: unit (m * 2 + hl) * 2 + s
  // of ring stage k at ring + k * kRingStage, 512 bytes apart
  const unsigned ring = (unsigned)__cvta_generic_to_shared(smem) +
                        (unsigned)(warp * kRing * kRingStage + lane * 16);
  const float4* ring_f4 = reinterpret_cast<const float4*>(smem + warp * kRing * kRingStage) + lane;

  const int pitch = g.w + g.kw - 1;
  const int rows_staged = g.band_rows + g.kh - 1;
  const int plane = rows_staged * pitch;   // a channel's staged plane
  const float* raw = reinterpret_cast<const float*>(xs + g.ci * plane);
  const unsigned raw_addr = (unsigned)__cvta_generic_to_shared(raw);
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

  // hh in acc, the five smaller products in lo (2^-8 of acc and less)
  float acc[4][4][4], lo[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][nt][q] = lo[m][nt][q] = 0.0f;

  const FastDiv by_w(g.w), by_pitch(pitch);
  const int q_lo = split * g.pieces_per_split;
  const int q_hi = min(g.pieces, q_lo + g.pieces_per_split);
  for (int q = q_lo; q < q_hi; ++q) {
    const int b = q / g.bands;
    const int h0 = (q - b * g.bands) * g.band_rows;
    const int nr = min(g.band_rows, g.h - h0);
    const int64_t img = (int64_t)u * g.batch + b;

    const int npx = nr * g.w;
    const float* dyp = dy + (img * g.co + co0) * hw + (int64_t)h0 * g.w;
    // request the warp's chunk c0 of the piece into ring stage k (a group of
    // copies, empty past the piece)
    auto request = [&](int c0, int k) {
      if (c0 < npx) {
        const int p = c0 + 4 * tq;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int s = 0; s < 2; ++s)
              copy4<VEC>(ring + (unsigned)(k * kRingStage + ((m * 2 + hl) * 2 + s) * 512),
                         dyp + (int64_t)(m * 16 + gq + 8 * hl) * hw, row_live[m][hl],
                         p + 16 * s, npx, dy);
      }
      cp_async_commit();
    };

    // x of the piece as float32 into the raw buffer, by cp.async in one
    // group: per channel nr + kh - 1 rows of pitch columns, zero outside the
    // image.  Then the warp's first kRing chunks of dy, which run on while
    // the raw values are split into the planes.
    __syncthreads();   // the previous piece has been consumed
    const int per_channel = (nr + g.kh - 1) * pitch;
    const int staged = g.ci * per_channel;
    const FastDiv by_channel(per_channel);
    for (int e = threadIdx.x; e < staged; e += kThreads) {
      const int c = by_channel.div(e);
      const int rem = e - c * per_channel;
      const int rr = by_pitch.div(rem);
      const int cc = rem - rr * pitch;
      const int hh = h0 + rr - g.ph;
      const int ww = cc - g.pw;
      const bool live = hh >= 0 && hh < g.h && ww >= 0 && ww < g.w;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(raw_addr + 4u * (unsigned)e),
                      "l"(live ? x + (img * g.ci + c) * hw + (int64_t)hh * g.w + ww : x),
                      "r"(live ? 4 : 0) : "memory");
    }
    cp_async_commit();
    const int first = warp * kChunk;
#pragma unroll
    for (int k = 0; k < kRing; ++k) request(first + k * kWarps * kChunk, k);
    cp_async_wait<kRing>();   // the raw values are in (the ring's may be in flight)
    __syncthreads();
    for (int e = threadIdx.x; e < staged; e += kThreads) {
      const int c = by_channel.div(e);
      xs[e + c * (plane - per_channel)] = staged_pieces(raw[e]);
    }
    __syncthreads();

    for (int c0 = first, k = 0; c0 < npx; c0 += kWarps * kChunk, k = (k + 1) % kRing) {
      const int p = c0 + 4 * tq;   // the lane's first pixel of the chunk
      cp_async_wait<kRing - 1>();  // this chunk is in; the next may be in flight
      const float4* a = ring_f4 + k * (kRingStage / 16);
      // the two k-steps one after the other: unrolled, the compiler hoists
      // the second's loads beside the 128 accumulators and spills
#pragma unroll 1
      for (int s = 0; s < 2; ++s) {
        // the B fragments of the k-step, every column tile: b[nt][piece] =
        // {slots 2t, 2t + 1; slots 2t + 8, 2t + 9}, from the lane's pixels
        // p + 16s .. p + 16s + 3 (offset 0 past the piece: A is zero there)
        unsigned b[4][3][2];
        int off[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pe = p + 16 * s + e;
          const int r = by_w.div(pe);
          off[e] = pe < npx ? r * pitch + pe - r * g.w : 0;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint2 v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = xs[cbase[nt] + off[e]];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            b[nt][0][h] = __byte_perm(v[2 * h].x, v[2 * h + 1].x, 0x5410);   // h pieces
            b[nt][1][h] = __byte_perm(v[2 * h].x, v[2 * h + 1].x, 0x7632);   // m pieces
            b[nt][2][h] = __byte_perm(v[2 * h].y, v[2 * h + 1].y, 0x5410);   // l pieces
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          // pixels p + 16s .. p + 16s + 3 of the lane's rows g and g + 8 of tile m
          const float4 r0 = a[((m * 2 + 0) * 2 + s) * 32], r1 = a[((m * 2 + 1) * 2 + s) * 32];
          // the A fragments' pieces: rows g and g + 8, slots 2t (+ 1) and 2t + 8 (+ 1)
          unsigned a0[3], a1[3], a2[3], a3[3];
          split3(r0.x, r0.y, a0);
          split3(r1.x, r1.y, a1);
          split3(r0.z, r0.w, a2);
          split3(r1.z, r1.w, a3);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int pass = 0; pass < 6; ++pass) {
              const int pa = pass_a(pass), pb = pass_b(pass);
              if (pass < 5)
                mma_bf16(lo[m][nt], a0[pa], a1[pa], a2[pa], a3[pa], b[nt][pb][0], b[nt][pb][1]);
              else
                mma_bf16(acc[m][nt], a0[pa], a1[pa], a2[pa], a3[pa], b[nt][pb][0], b[nt][pb][1]);
            }
        }
      }
      // the chunk after next into the stage just read (this lane's own units)
      request(c0 + kRing * kWarps * kChunk, k);
    }
  }

  // (splits, U, Co, N): with one split this is the result itself.  Each
  // warp's two sets are added once, rounded to nearest; the warps' tiles
  // meet in shared memory and are added in warp order.  Accumulator q of an
  // m16n8 tile: row gq (+ 8 for q >= 2), column 2 tq + q % 2.
  __syncthreads();   // every warp is done with its ring and the planes
  float* red = reinterpret_cast<float*>(smem);   // (kWarps, kTileCo, kRedPitch)
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m * 16 + gq + 8 * (q >> 1);
        const int col = nt * 8 + 2 * tq + (q & 1);
        red[(warp * kTileCo + row) * kRedPitch + col] = acc[m][nt][q] + lo[m][nt][q];
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

// Shared memory of a block: the warps' rings, the staged planes of a piece
// and its raw values, or the warps' tiles.
size_t smem_bytes(const Geometry& g) {
  const size_t planes = kRingBytes + (sizeof(uint2) + sizeof(float)) * g.ci *
                        (size_t)(g.band_rows + g.kh - 1) * (g.w + g.kw - 1);
  const size_t tiles = sizeof(float) * kWarps * kTileCo * kRedPitch;
  return planes > tiles ? planes : tiles;
}

template <int VEC>
cudaError_t launch(const float* x, const float* dy, float* out, const Geometry& g, int splits,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  const int co_tiles = (g.co + kTileCo - 1) / kTileCo;
  dim3 grid(g.n_tiles * co_tiles, splits, g.users);
  cudaError_t err = cudaFuncSetAttribute(per_user_dw_narrow_f32_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  per_user_dw_narrow_f32_kernel<VEC><<<grid, kThreads, smem, stream>>>(x, dy, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (users*batch, ci, h, w), dy: (users*batch, co, h, w), both float32,
// contiguous; out: (users, co, ci, kh, kw) float32.  0 <= ph < kh and
// 0 <= pw < kw are the low pads.  A user's images are cut into pieces of
// band_rows rows (fewer in an image's last band), and its pieces into
// `splits` ranges of equal length but the last; with splits > 1, scratch
// holds (splits, users, co, ci, kh, kw) float32 partial sums, which a second
// launch adds in range order.  Returns cudaGetLastError() after the launches.
int gqx_per_user_dw_narrow_f32(const void* x, const void* dy, int users, int batch, int ci,
                               int co, int h, int w, int kh, int kw, int ph, int pw,
                               int band_rows, int splits, float* scratch, float* out,
                               void* stream) {
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
  // piece starts at a multiple of 4 pixels from an aligned base
  const int64_t hw = (int64_t)h * w;
  const bool vec4 = hw % 4 == 0 && ((int64_t)band_rows * w) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  cudaError_t err = vec4 ? launch<4>(xf, df, dst, g, splits, s) : launch<1>(xf, df, dst, g, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(scratch, splits, (int64_t)users * co * g.n, out, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
