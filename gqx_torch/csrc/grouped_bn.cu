// Grouped training batch norm for Hopper (sm_90a): the forward and the
// analytic backward of gqx_torch.models.folded.GroupedBatchNorm, one launch
// each.  x (U*B, C, H, W) NCHW, float32 or bf16, is normalised per
// (user, channel) group of B*H*W elements with gqx's numerics
// (gqx/models/folded.py:250-296):
//
//   forward:  mean = sum(x) / n, var = max(0, sum(x^2) / n - mean^2) (the
//             clipped fast variance), inv = rsqrt(var + eps),
//             y = ((x - mean) * inv) * w + b, rounded once to x's type;
//   backward: s1 = sum(dy), s2 = sum(dy * ((x - mean) * inv)), x centred
//             element by element (never sum(dy * x) - mean * s1, which
//             cancels where |mean| >> std); g1 = w * inv, g2 = s1 * g1 / n,
//             g5 = [var > 0] * -(s2 * g1 * inv) / n,
//             dx = ((g1 * dy) - g2) + ((x - mean) * g5).
//
// The sums are float32.  Every element-wise step is rounded where the plain
// version (gqx_torch/ops/bn.py) rounds it (no contraction into FMAs), so
// given the same statistics the two give the same bits; the sums alone are
// taken in another order.
//
// Replaces no TPU kernel: gqx leaves this chain to XLA (_gbn_fwd /
// _gbn_bwd).  It was written because the plain chain, about ten float32
// passes over the activation each way, took 67% of the port's ResNet-50
// step on the H100 (223 of some 330 device ms at 32 users x 32 images).
//
// What bounds it on the H100: memory.  A read-once design moves 4 B an
// element forward (bf16 x in, y out) and 6 B backward (x and dy in, dx
// out).  The design reads each group from device memory once:
//
// - A block owns whole groups: one user and `tile` consecutive channels
//   (a power of two, at most a block's threads / 8).  No reduction crosses
//   blocks and no float atomics are used, so two runs give the same bits.
// - threads / tile threads own a channel.  They walk its B runs of H*W
//   elements in vectors of V elements (16 B where H*W allows), neighbouring
//   threads on neighbouring addresses, kUnroll vectors in flight a thread,
//   sum as the vectors arrive and, on the staged route, keep each vector in
//   shared memory where the same thread reads it back for the output.  A
//   warp reduces its lanes by xor shuffles; the warps of a channel add their
//   partial sums in warp order.
// - Where H*W is small (4x4, 2x2), a block takes many channels, so each
//   image's slab of channels x H*W is read whole by the block at once.
// - Staged route ("smem"): the block's groups sit in shared memory between
//   the sum and the output, B*H*W*tile elements of x (and of dy backward):
//   at most 64 KB forward and 128 KB backward at the cells' shapes (32
//   images of 32x32).  Two-pass route: groups that do not fit (float32
//   backward at 32x32, larger batches) read x (and dy) a second time,
//   mostly from L2.  (Measured at the three cells' batch norms, H100: two
//   passes took 17-21% longer than the staged route, forward and backward.)
// - A block has 256 threads, four a multiprocessor, so that one block's
//   sums and output overlap the others' loads; a staged block that leaves
//   no room for a second one (128 KB: the backward at 32x32) has 1,024, so
//   that its one block keeps as many loads in flight.  Both at most 64
//   registers a thread, two vectors in flight a thread: with four the
//   backward spilled at 64 registers, and 64 registers leave the block count
//   of a multiprocessor to the shared memory.  (Measured at the u32 cell's
//   53 batch norms, H100: 256 threads throughout gave the 32x32 backward 43%
//   of its bound, 1,024 threads 61-66%; 1,024 gave the forward and the
//   smaller planes 45-60%, 256 threads 65-74%.)
// - ops/bn.py's `plan` chooses route, tile, threads and V from the shapes,
//   the type and the card's shared memory; this file only checks them.
//   These four fix the order of a group's sums, and none depends on the
//   number of users, which only adds blocks: the folded step and the
//   per-user loop give a group the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of a block (see above)
constexpr int kSmallBlock = 256;
constexpr int kLargeBlock = 1024;
constexpr int kUnroll = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements moved as one access of V * sizeof(T) bytes
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

struct Geometry {
  int batch;     // images of a user
  int channels;  // C
  int hw;        // H * W
  int tile;      // channels of a block
};

// What one thread owns: channel j of its block's tile, lane k of the
// channel's threads, and the vectors q = k, k + per, ... of the group.
template <int kThreads, int V>
struct Lane {
  int per, j, k, c, nvec;
  bool live;
  int hwv;
  int64_t image, first;
  __device__ explicit Lane(const Geometry& g) {
    per = kThreads / g.tile;
    j = threadIdx.x / per;
    k = threadIdx.x - j * per;
    c = blockIdx.x * g.tile + j;
    live = c < g.channels;
    hwv = g.hw / V;
    nvec = g.batch * hwv;
    image = (int64_t)g.channels * g.hw;
    first = ((int64_t)blockIdx.y * g.batch * g.channels + c) * g.hw;
  }
  // element offset of vector q of the group in the NCHW tensor
  __device__ __forceinline__ int64_t offset(int q) const {
    const int b = q / hwv;
    return first + b * image + (int64_t)(q - b * hwv) * V;
  }
};

// The sums of a and b over the `per` consecutive threads of a channel (per
// a power of two), left in every one of them, in a fixed order.  Every
// thread of the block calls it.
template <int kWarps>
__device__ __forceinline__ void channel_sums(float& a, float& b, int per,
                                             float (&scratch)[2][kWarps]) {
  const int lanes = per < 32 ? per : 32;
  for (int o = lanes / 2; o > 0; o /= 2) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (per <= 32) return;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    scratch[0][warp] = a;
    scratch[1][warp] = b;
  }
  __syncthreads();
  const int first = (threadIdx.x / per) * (per / 32);
  a = scratch[0][first];
  b = scratch[1][first];
  for (int w = 1; w < per / 32; ++w) {
    a += scratch[0][first + w];
    b += scratch[1][first + w];
  }
}

// at most 64 registers a thread: 1,024 threads a multiprocessor
template <typename T, int kThreads, int V, bool kStaged>
__global__ void __launch_bounds__(kThreads, kLargeBlock / kThreads)
grouped_bn_forward_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                          const float* __restrict__ bias, Geometry g, float eps,
                          T* __restrict__ y, float* __restrict__ mean_out,
                          float* __restrict__ var_out, float* __restrict__ inv_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[2][kThreads / 32];
  const Lane<kThreads, V> l(g);
  T* stage = reinterpret_cast<T*>(smem) + (size_t)l.j * l.nvec * V;
  using W = Vec<T, V>;

  float s = 0.f, ss = 0.f;
  if (l.live) {
    for (int q0 = l.k; q0 < l.nvec; q0 += l.per * kUnroll) {
      W v[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int q = q0 + t * l.per;
        if (q < l.nvec) v[t] = *reinterpret_cast<const W*>(x + l.offset(q));
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int q = q0 + t * l.per;
        if (q < l.nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float f = to_float(v[t].v[e]);
            s += f;
            ss = fmaf(f, f, ss);
          }
          if (kStaged) *reinterpret_cast<W*>(stage + (size_t)q * V) = v[t];
        }
      }
    }
  }
  channel_sums(s, ss, l.per, scratch);
  if (!l.live) return;

  const float n = (float)((int64_t)g.batch * g.hw);
  const float mean = __fdiv_rn(s, n);
  const float d = __fsub_rn(__fdiv_rn(ss, n), __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;   // a NaN stays NaN, as in clamp_min
  const float inv = rsqrtf(__fadd_rn(var, eps));
  if (l.k == 0) {
    const int64_t at = (int64_t)blockIdx.y * g.channels + l.c;
    mean_out[at] = mean;
    var_out[at] = var;
    inv_out[at] = inv;
  }
  const float w = weight[l.c], b = bias[l.c];
  for (int q0 = l.k; q0 < l.nvec; q0 += l.per * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int q = q0 + t * l.per;
      if (q < l.nvec)
        v[t] = kStaged ? *reinterpret_cast<const W*>(stage + (size_t)q * V)
                       : *reinterpret_cast<const W*>(x + l.offset(q));
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int q = q0 + t * l.per;
      if (q < l.nvec) {
        W o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xn = __fmul_rn(__fsub_rn(to_float(v[t].v[e]), mean), inv);
          o.v[e] = from_float<T>(__fadd_rn(__fmul_rn(xn, w), b));
        }
        *reinterpret_cast<W*>(y + l.offset(q)) = o;
      }
    }
  }
}

template <typename T, int kThreads, int V, bool kStaged>
__global__ void __launch_bounds__(kThreads, kLargeBlock / kThreads)
grouped_bn_backward_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ mean_in, const float* __restrict__ var_in,
                           const float* __restrict__ inv_in, const float* __restrict__ weight,
                           Geometry g, T* __restrict__ dx, float* __restrict__ s1_out,
                           float* __restrict__ s2_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[2][kThreads / 32];
  const Lane<kThreads, V> l(g);
  T* xs = reinterpret_cast<T*>(smem) + (size_t)l.j * l.nvec * V;
  T* ds = xs + (size_t)g.tile * l.nvec * V;
  using W = Vec<T, V>;

  const int64_t at = (int64_t)blockIdx.y * g.channels + l.c;
  const float mean = l.live ? mean_in[at] : 0.f;
  const float inv = l.live ? inv_in[at] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  if (l.live) {
    for (int q0 = l.k; q0 < l.nvec; q0 += l.per * kUnroll) {
      W xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int q = q0 + t * l.per;
        if (q < l.nvec) {
          const int64_t o = l.offset(q);
          xv[t] = *reinterpret_cast<const W*>(x + o);
          dv[t] = *reinterpret_cast<const W*>(dy + o);
        }
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int q = q0 + t * l.per;
        if (q < l.nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float d = to_float(dv[t].v[e]);
            s1 += d;
            s2 = fmaf(d, __fmul_rn(__fsub_rn(to_float(xv[t].v[e]), mean), inv), s2);
          }
          if (kStaged) {
            *reinterpret_cast<W*>(xs + (size_t)q * V) = xv[t];
            *reinterpret_cast<W*>(ds + (size_t)q * V) = dv[t];
          }
        }
      }
    }
  }
  channel_sums(s1, s2, l.per, scratch);
  if (!l.live) return;

  const float n = (float)((int64_t)g.batch * g.hw);
  const float g1 = __fmul_rn(weight[l.c], inv);
  const float g2 = __fdiv_rn(__fmul_rn(s1, g1), n);
  const float on = var_in[at] > 0.f ? 1.f : 0.f;   // the clipped groups' g5 is 0
  const float g5 = __fdiv_rn(__fmul_rn(on, -__fmul_rn(__fmul_rn(s2, g1), inv)), n);
  if (l.k == 0) {
    s1_out[at] = s1;
    s2_out[at] = s2;
  }
  for (int q0 = l.k; q0 < l.nvec; q0 += l.per * kUnroll) {
    W xv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int q = q0 + t * l.per;
      if (q < l.nvec) {
        if (kStaged) {
          xv[t] = *reinterpret_cast<const W*>(xs + (size_t)q * V);
          dv[t] = *reinterpret_cast<const W*>(ds + (size_t)q * V);
        } else {
          const int64_t o = l.offset(q);
          xv[t] = *reinterpret_cast<const W*>(x + o);
          dv[t] = *reinterpret_cast<const W*>(dy + o);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int q = q0 + t * l.per;
      if (q < l.nvec) {
        W o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xc = __fsub_rn(to_float(xv[t].v[e]), mean);
          const float a = __fsub_rn(__fmul_rn(g1, to_float(dv[t].v[e])), g2);
          o.v[e] = from_float<T>(__fadd_rn(a, __fmul_rn(xc, g5)));
        }
        *reinterpret_cast<W*>(dx + l.offset(q)) = o;
      }
    }
  }
}

struct Call {
  const void* x;
  const void* dy;           // backward
  const float* weight;
  const float* bias;        // forward
  const float* mean;        // forward: out; backward: in
  const float* var;
  const float* inv;
  float eps;
  void* out;                // y or dx
  float* s1;                // backward
  float* s2;
  int users, staged;
  Geometry g;
};

// shared memory of a staged block: its groups of x (and of dy backward)
template <typename T, bool kBackward>
size_t staged_bytes(const Geometry& g) {
  return (kBackward ? 2 : 1) * (size_t)g.tile * g.batch * g.hw * sizeof(T);
}

// a kernel may take more than 48 KB of dynamic shared memory only when told
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(
                                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
                           : cudaSuccess;
}

template <typename T, int kThreads, int V, bool kStaged, bool kBackward>
int launch(const Call& a, cudaStream_t stream) {
  const dim3 grid((a.g.channels + a.g.tile - 1) / a.g.tile, a.users);
  const size_t bytes = kStaged ? staged_bytes<T, kBackward>(a.g) : 0;
  if constexpr (kBackward) {
    auto kernel = grouped_bn_backward_kernel<T, kThreads, V, kStaged>;
    if (const cudaError_t e = allow_smem(kernel, bytes)) return (int)e;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.mean, a.var, a.inv,
        a.weight, a.g, static_cast<T*>(a.out), a.s1, a.s2);
  } else {
    auto kernel = grouped_bn_forward_kernel<T, kThreads, V, kStaged>;
    if (const cudaError_t e = allow_smem(kernel, bytes)) return (int)e;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(a.x), a.weight, a.bias, a.g, a.eps, static_cast<T*>(a.out),
        const_cast<float*>(a.mean), const_cast<float*>(a.var), const_cast<float*>(a.inv));
  }
  return (int)cudaGetLastError();
}

// the routes: staged with either block, or two passes with the small one
template <typename T, int V, bool kBackward>
int launch_route(const Call& a, int threads, cudaStream_t stream) {
  if (!a.staged)
    return threads == kSmallBlock ? launch<T, kSmallBlock, V, false, kBackward>(a, stream)
                                  : (int)cudaErrorInvalidValue;
  if (threads == kSmallBlock) return launch<T, kSmallBlock, V, true, kBackward>(a, stream);
  if (threads == kLargeBlock) return launch<T, kLargeBlock, V, true, kBackward>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// V as the plan gives it: 16 / sizeof(T) elements at most
template <typename T, bool kBackward>
int dispatch(const Call& a, int threads, int vec, cudaStream_t stream) {
  const Geometry& g = a.g;
  if (a.users < 1 || a.users > 65535 || g.batch < 1 || g.channels < 1 || g.hw < 1 ||
      g.tile < 1 || g.tile > threads / 8 || (g.tile & (g.tile - 1)) || vec < 1 ||
      g.hw % vec || (int64_t)g.batch * g.hw >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) return launch_route<T, 8, kBackward>(a, threads, stream);
      break;
    case 4: return launch_route<T, 4, kBackward>(a, threads, stream);
    case 2: return launch_route<T, 2, kBackward>(a, threads, stream);
    case 1: return launch_route<T, 1, kBackward>(a, threads, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The largest shared memory a block may opt into on `device`, in *bytes.
int gqx_grouped_bn_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// x (users*batch, channels, hw) NCHW contiguous, float32 (bf16 = 0) or bf16
// (bf16 = 1); weight, bias (channels,) float32 -> y like x, mean, var, inv
// (users, channels) float32.  Returns cudaGetLastError() after the launch.
int gqx_grouped_bn_forward(const void* x, const float* weight, const float* bias, int bf16,
                           int users, int batch, int channels, int hw, int tile, int threads,
                           int vec, int staged, float eps, void* y, float* mean, float* var,
                           float* inv, void* stream) {
  Call a{x, nullptr, weight, bias, mean, var, inv, eps, y, nullptr, nullptr, users, staged,
         Geometry{batch, channels, hw, tile}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16, false>(a, threads, vec, s)
              : dispatch<float, false>(a, threads, vec, s);
}

// x, dy as the forward's x; mean, var, inv (users, channels) float32 from
// the forward; weight (channels,) float32 -> dx like x, s1 = sum(dy) and
// s2 = sum(dy * xhat) (users, channels) float32.
int gqx_grouped_bn_backward(const void* x, const void* dy, const float* mean, const float* var,
                            const float* inv, const float* weight, int bf16, int users,
                            int batch, int channels, int hw, int tile, int threads, int vec,
                            int staged, void* dx, float* s1, float* s2, void* stream) {
  Call a{x, dy, weight, nullptr, mean, var, inv, 0.f, dx, s1, s2, users, staged,
         Geometry{batch, channels, hw, tile}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16, true>(a, threads, vec, s)
              : dispatch<float, true>(a, threads, vec, s);
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
