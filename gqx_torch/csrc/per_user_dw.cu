// Per-user convolution weight gradient for Hopper (sm_90a), stride 1, output
// of the input's size:
//
//   dW[u, co, ci, i, j] = sum over the images b of user u and over (h, w) of
//       xpad[b, ci, h + i - ph, w + j - pw] * dy[b, co, h, w]
//
// with x (U*B, Ci, H, W) and dy (U*B, Co, H, W) float32 in NCHW, xpad the
// input with a zero border (ph, pw the low pads), and dW (U, Co, Ci, kh, kw)
// float32 in the weight's OIHW layout, accumulated with float32 FMAs.  No
// route of ops/dw.py takes it: float32 inputs go to per_user_dw_tc_f32.cu
// (16 input channels or more) or per_user_dw_narrow_f32.cu (fewer), both on
// exact bf16 pieces on the tensor cores, bf16 inputs to per_user_dw_tc.cu or
// per_user_dw_narrow.cu.  It stays callable through its C entry
// (gqx_torch/scripts/dw_f32_probe.py::cuda_core_dw, used by chip_smoke.py,
// the probes and a cuda test) as the baseline that those routes are checked
// and timed beside.
//
// Replaces: gqx/ops/pallas_dw.py::per_user_dw (_dw_kernel) for float32
// inputs.  The TPU kernel views both operands as (B*H*W, C) in NHWC, rolls
// x by the tap's offset, masks the rows of dy that wrapped, and contracts on
// the TPU's matrix unit, carrying the sum over batch chunks in the output
// block.  None of that carries over: a
// shifted tap here is an index into a staged tile with a zero halo, the
// layout is NCHW so that loads along w coalesce, and the reduction over a
// user's images, where it is split, is split across blocks and combined by
// a second kernel in a fixed order (no atomics: two runs give the same bits).
//
// What bounds it on the H100: operations.  2*kh*kw*(U*B*H*W)*Ci*Co FLOP
// (19.3 GFLOP for a 3x3 conv of ResNet-50's 64-, 128-, 256- or 512-channel
// stage at 8 users x 32 images) against at most 67 MB read and 75 MB
// written.  This kernel works on the CUDA cores (67 TFLOP/s float32), so it
// is far from the tensor cores' bound; it is also short of the CUDA
// cores' peak by its staging through shared memory without overlap, one
// shared load per 6 FMAs (2.4 with few input channels), and the partial
// tiles of narrow layers.
//
// Design: a block of 16 x 16 threads owns, for one user, one tap row i and
// one range of the user's images, a tile of 64 output channels x TCI input
// channels (TCI = 64, or 16 for layers with few input channels such as the
// stem) and all kw taps of that row.  A thread keeps 4 x CIT x kw sums in
// registers (CIT = TCI / 16).  The block walks over the (image, row) pairs
// of its range in chunks that fit 96 KB of shared memory (two blocks per
// multiprocessor): it stages the dy rows (64 x rows x wc) and the x rows
// shifted by i - ph with kw - 1 halo columns (TCI x rows x (wc + kw - 1)), zero outside the
// image, then every thread slides a kw-wide window along each row: one new
// x value per input channel and one dy value per output channel feed
// 4 * CIT * kw FMAs.  Channel planes in shared memory have an odd stride,
// so the 16 input channels a warp reads fall into 16 banks and the two
// output channels into two.  Rows wider than 64 are cut into column chunks.
// The staging loops split a flat element index with multiply-high divisions
// by divisors set once per chunk (an integer division per element cost as
// much as the FMAs it fed), and each thread starts eight global loads
// before it stores the first.
// A tap row per block triples (for 3x3) the reads from L2 and in exchange
// keeps the register tile small and gives narrow layers enough blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"
#include "per_user_dw_sum.cuh"

namespace {

constexpr int kTX = 16;          // thread columns: input-channel groups
constexpr int kTY = 16;          // thread rows: output-channel groups
constexpr int kThreads = kTX * kTY;
constexpr int kCOT = 4;          // output channels per thread
constexpr int kTCO = kTY * kCOT; // output channels per block
constexpr int kMaxCols = 64;     // columns of a row staged at once
constexpr int kSmemFloats = 96 * 1024 / 4;  // below 2^16: FastDiv's range
constexpr int kMaxKw = 7;
constexpr int kStage = 8;        // global loads a thread keeps in flight while staging

struct Geometry {
  int users, batch, ci, co, h, w, kh, ph, pw;
  int splits, imgs_per_split;   // the user's images are cut into `splits` ranges
  int rows_per_chunk, cols;     // the staged chunk: (image, row) pairs x columns
  int ci_tiles;
};

template <int KW, int CIT>
__global__ void __launch_bounds__(kThreads)
per_user_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ out, Geometry g) {
  constexpr int TCI = kTX * CIT;
  extern __shared__ float smem[];
  const int pitch = g.cols + KW - 1;                    // staged x row
  const int xs_plane = (g.rows_per_chunk * pitch) | 1;  // odd: no bank conflicts
  const int ds_plane = (g.rows_per_chunk * g.cols) | 1;
  float* xs = smem;                                     // (TCI, xs_plane)
  float* ds = smem + TCI * xs_plane;                    // (kTCO, ds_plane)

  const int ci0 = (blockIdx.x % g.ci_tiles) * TCI;
  const int co0 = (blockIdx.x / g.ci_tiles) * kTCO;
  const int tap_i = blockIdx.y % g.kh;
  const int split = blockIdx.y / g.kh;
  const int u = blockIdx.z;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  const int b_lo = split * g.imgs_per_split;
  const int b_hi = min(g.batch, b_lo + g.imgs_per_split);
  const int n_rows = max(b_hi - b_lo, 0) * g.h;         // (image, row) pairs
  const int di = tap_i - g.ph;
  const int64_t plane = (int64_t)g.h * g.w;
  const int64_t img0 = (int64_t)u * g.batch + b_lo;

  float acc[kCOT][CIT][KW];
#pragma unroll
  for (int c = 0; c < kCOT; ++c)
#pragma unroll
    for (int a = 0; a < CIT; ++a)
#pragma unroll
      for (int j = 0; j < KW; ++j) acc[c][a][j] = 0.0f;

  const FastDiv by_h(g.h);
  for (int q0 = 0; q0 < n_rows; q0 += g.rows_per_chunk) {
    const int nr = min(g.rows_per_chunk, n_rows - q0);
    const int b0 = q0 / g.h;
    const int h0 = q0 - b0 * g.h;
    for (int w0 = 0; w0 < g.w; w0 += g.cols) {
      const int nw = min(g.cols, g.w - w0);
      const int xw = nw + KW - 1;
      const FastDiv by_xw(xw), by_xplane(nr * xw), by_nw(nw), by_dplane(nr * nw);
      __syncthreads();   // the previous chunk has been consumed
      // kStage global loads in flight per thread, then their stores: one
      // load at a time left the block waiting on memory most of the time
      const int x_total = TCI * nr * xw;
      for (int e0 = threadIdx.x; e0 < x_total; e0 += kThreads * kStage) {
        float val[kStage];
        int dst[kStage];
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          const int e = min(e0 + k * kThreads, x_total - 1);
          const int c = by_xplane.div(e);
          const int rem = e - c * (nr * xw);
          const int r = by_xw.div(rem);
          const int col = rem - r * xw;
          const int db = by_h.div(h0 + r);
          const int h = h0 + r - db * g.h + di;
          const int w = w0 + col - g.pw;
          const int ci = ci0 + c;
          const bool live = ci < g.ci && h >= 0 && h < g.h && w >= 0 && w < g.w;
          val[k] = live ? x[((img0 + b0 + db) * g.ci + ci) * plane + (int64_t)h * g.w + w]
                        : 0.0f;
          dst[k] = c * xs_plane + r * pitch + col;
        }
#pragma unroll
        for (int k = 0; k < kStage; ++k)
          if (e0 + k * kThreads < x_total) xs[dst[k]] = val[k];
      }
      const int d_total = kTCO * nr * nw;
      for (int e0 = threadIdx.x; e0 < d_total; e0 += kThreads * kStage) {
        float val[kStage];
        int dst[kStage];
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          const int e = min(e0 + k * kThreads, d_total - 1);
          const int c = by_dplane.div(e);
          const int rem = e - c * (nr * nw);
          const int r = by_nw.div(rem);
          const int col = rem - r * nw;
          const int db = by_h.div(h0 + r);
          const int h = h0 + r - db * g.h;
          const int co = co0 + c;
          val[k] = co < g.co
              ? dy[((img0 + b0 + db) * g.co + co) * plane + (int64_t)h * g.w + w0 + col]
              : 0.0f;
          dst[k] = c * ds_plane + r * g.cols + col;
        }
#pragma unroll
        for (int k = 0; k < kStage; ++k)
          if (e0 + k * kThreads < d_total) ds[dst[k]] = val[k];
      }
      __syncthreads();

      for (int r = 0; r < nr; ++r) {
        const float* xr = xs + r * pitch;
        const float* dr = ds + r * g.cols;
        float win[CIT][KW];
#pragma unroll
        for (int a = 0; a < CIT; ++a)
#pragma unroll
          for (int j = 1; j < KW; ++j) win[a][j] = xr[(tx + kTX * a) * xs_plane + j - 1];
#pragma unroll 4
        for (int w = 0; w < nw; ++w) {
          float d[kCOT];
#pragma unroll
          for (int c = 0; c < kCOT; ++c) d[c] = dr[(ty + kTY * c) * ds_plane + w];
#pragma unroll
          for (int a = 0; a < CIT; ++a) {
#pragma unroll
            for (int j = 0; j + 1 < KW; ++j) win[a][j] = win[a][j + 1];
            win[a][KW - 1] = xr[(tx + kTX * a) * xs_plane + w + KW - 1];
          }
#pragma unroll
          for (int c = 0; c < kCOT; ++c)
#pragma unroll
            for (int a = 0; a < CIT; ++a)
#pragma unroll
              for (int j = 0; j < KW; ++j)
                acc[c][a][j] = fmaf(d[c], win[a][j], acc[c][a][j]);
        }
      }
    }
  }

  // (splits, U, Co, Ci, kh, KW): with one split this is the result itself
  const int64_t taps = (int64_t)g.kh * KW;
  float* dst = out + ((int64_t)split * g.users + u) * g.co * g.ci * taps;
#pragma unroll
  for (int c = 0; c < kCOT; ++c) {
    const int co = co0 + ty + kTY * c;
#pragma unroll
    for (int a = 0; a < CIT; ++a) {
      const int ci = ci0 + tx + kTX * a;
      if (co < g.co && ci < g.ci) {
        float* p = dst + ((int64_t)co * g.ci + ci) * taps + (int64_t)tap_i * KW;
#pragma unroll
        for (int j = 0; j < KW; ++j) p[j] = acc[c][a][j];
      }
    }
  }
}

template <int KW, int CIT>
cudaError_t launch(const float* x, const float* dy, float* out, Geometry g,
                   cudaStream_t stream) {
  constexpr int TCI = kTX * CIT;
  g.cols = min(g.w, kMaxCols);
  const int per_row = TCI * (g.cols + KW - 1) + kTCO * g.cols;
  const int fit = (kSmemFloats - TCI - kTCO) / per_row;   // planes round up by 1
  g.rows_per_chunk = max(1, min(fit, g.imgs_per_split * g.h));
  g.ci_tiles = (g.ci + TCI - 1) / TCI;
  const int co_tiles = (g.co + kTCO - 1) / kTCO;
  const size_t smem = sizeof(float) *
      ((size_t)TCI * ((g.rows_per_chunk * (g.cols + KW - 1)) | 1) +
       (size_t)kTCO * ((g.rows_per_chunk * g.cols) | 1));
  dim3 grid(g.ci_tiles * co_tiles, g.kh * g.splits, g.users);
  cudaError_t err = cudaFuncSetAttribute(per_user_dw_kernel<KW, CIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(kSmemFloats * sizeof(float)));
  if (err != cudaSuccess) return err;
  per_user_dw_kernel<KW, CIT><<<grid, kThreads, smem, stream>>>(x, dy, out, g);
  return cudaGetLastError();
}

template <int KW>
cudaError_t launch_kw(const float* x, const float* dy, float* out, const Geometry& g,
                      cudaStream_t stream) {
  // few input channels (the stem's 3): a 16-wide tile wastes less
  return g.ci <= 16 ? launch<KW, 1>(x, dy, out, g, stream)
                    : launch<KW, 4>(x, dy, out, g, stream);
}

cudaError_t launch_any(const float* x, const float* dy, float* out, int kw,
                       const Geometry& g, cudaStream_t stream) {
  switch (kw) {
    case 1: return launch_kw<1>(x, dy, out, g, stream);
    case 2: return launch_kw<2>(x, dy, out, g, stream);
    case 3: return launch_kw<3>(x, dy, out, g, stream);
    case 4: return launch_kw<4>(x, dy, out, g, stream);
    case 5: return launch_kw<5>(x, dy, out, g, stream);
    case 6: return launch_kw<6>(x, dy, out, g, stream);
    case 7: return launch_kw<7>(x, dy, out, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (users*batch, ci, h, w), dy: (users*batch, co, h, w), both float32,
// contiguous; out: (users, co, ci, kh, kw) float32.  0 <= ph < kh and
// 0 <= pw < kw are the low pads.  The user's images are reduced in `splits`
// ranges; with splits > 1, scratch holds (splits, users, co, ci, kh, kw)
// float32 partial sums, which a second launch adds in range order.  Returns
// cudaGetLastError() after the launches.
int gqx_per_user_dw(const void* x, const void* dy, int users, int batch, int ci, int co, int h,
                    int w, int kh, int kw, int ph, int pw, int splits, float* scratch, float* out,
                    void* stream) {
  if (kw < 1 || kw > kMaxKw || splits < 1 || splits > batch || h >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.users = users; g.batch = batch; g.ci = ci; g.co = co; g.h = h; g.w = w;
  g.kh = kh; g.ph = ph; g.pw = pw;
  g.splits = splits;
  g.imgs_per_split = (batch + splits - 1) / splits;
  g.rows_per_chunk = g.cols = g.ci_tiles = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? scratch : out;
  cudaError_t err = launch_any(static_cast<const float*>(x), static_cast<const float*>(dy), dst,
                               kw, g, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(scratch, splits, (int64_t)users * co * ci * kh * kw, out, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
