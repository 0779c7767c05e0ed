// HSQ encode on Hopper's tensor cores (sm_90a): per user and per dim-wide
// subvector row, the inner products with the K codewords and the selection
// of the signed product of largest magnitude.
//
// Replaces: gqx/ops/pallas_hsq4.py::hsq_encode_flat (_encode_kernel, _select),
// the TPU kernel that contracts a block-diagonal (128, B*K) expansion of the
// codebook on the matrix unit (_dot_t, bf16 operands, float32 accumulation).
// That expansion exists only for the TPU's 128-lane layout and is not rebuilt
// here; the contraction itself goes to the tensor cores, as on the TPU.
//
// What it computes, bit for bit where the arithmetic allows:
//   x is rounded as the TPU kernel rounds it: passes=1 -> bf16(x);
//   passes=2 -> bf16(x) and bf16(x - bf16(x)) contracted separately and
//   added in float32 (a bf16 input has no low part: it is taken as it is).
//   The codebook is bf16-exact, so every product is exact in float32; only
//   the order and rounding of the float32 additions inside the mma differ
//   from the plain version.
//   Selection (pallas_hsq4.py:40-51): pos = max p, neg = min p,
//   u = pos if pos >= -neg else neg, code = first index whose p equals u.
//   A zero row gives code 0 and u 0.  The u written is then recomputed for
//   the chosen code as the plain version computes it (dot_row): the same
//   exact products added in element order.  The tensor cores' own sum
//   rounds in another order, and the norm quantizer's levels follow each
//   segment's min and max of u, so a rounding there moved every level of
//   a segment (with float32 compute, thousands of subvectors of the
//   aggregate off the CPU plain path in some runs).
//
// What bounds it on the H100: the 3.0 G products of a call at ResNet-50's
// unit (8 x 1,470,464 rows of 16, K = 256), not its bytes (376 MB of bf16 in,
// 59 MB out: 0.13 ms) nor its 96 GFLOP (0.10 ms at the bf16 peak).  With a
// contraction depth of 16, every product leaves the tensor cores as its own
// float32 register, and the selection must read each one.  Measured by
// gqx_torch/scripts/encode_probe.py (PERF.md): the loads, the mma and a plain
// sum of the products take about half of the kernel's time, with or
// without the loads; the selection takes the other half, in proportion to
// its instructions per product.
//
// Design:
// - One mma.sync m16n8k16 (bf16 -> float32) per 16 rows x 8 codewords.  The
//   contraction index k is a free permutation of the dims, so lane
//   (g, t) = (lane / 4, lane % 4) holds the dim/4 contiguous dims
//   t*dim/4 ... of its rows g and g + 8, and a warp's loads cover whole rows
//   (bf16 in 4-byte pieces, which land straight in the mma's A registers).
//   dim 4 and 8 fill k with zeros, dim 32 takes two k-steps into one
//   accumulator.  The codebook's B fragments use the same permutation.
// - The codebook is staged once per block into shared memory in fragment
//   order (8 bytes per lane and k-step, one conflict-free LDS.64), zero past
//   K (a zero codeword never beats a real one and never comes first).  A
//   warp holds kTiles row tiles (64 rows) and reuses each B fragment for all
//   of them; blocks stride over the rows.
// - The selection is fused from the accumulator fragments in one pass.  Per
//   row, a lane sees codewords 8j + 2t and 8j + 2t + 1 of each tile j.  Over
//   groups of kGroup tiles (4 products) it keeps the running maximum m of
//   |p| (3 FMNMX with the |.| modifier per group), and where a group raises
//   it (FSETP), the group's index and its 4 products (predicated moves: 11
//   instructions per 4 products in all).  A = the quad's maximum of m; a
//   lane with m == A finds its first p == +A and first p == -A among the
//   kept products; the code is the quad's first index with +A if the quad
//   has one (max p >= -min p), else its first with -A.  This is exact unless a
//   lane's later group only ties m (FSETP, the 11th instruction): a -A
//   kept first could hide a later +A.  Then the warp takes the exact scan
//   (zero rows and exact ties only): the same mma again (the same bits)
//   and every product compared with +A and -A.  The rule is the TPU
//   kernel's: +v wins an exact +v/-v tie, the first index an equal pair.
// - Tried on the card and not kept (probes whose code is not kept): two
//   passes (max |p|, then the mma again and a compare per product, with a
//   branch where it hits) were much slower, because in nearly every tile
//   some lane of a warp hits; one tile per group was slower; 4 tiles per
//   group, loads one task ahead, fewer row tiles per warp, and wgmma
//   (m64n128k16, A from registers, the same bits) hardly moved the time.
// - Each lane writes the u and code of one row tile's two rows per quad
//   after the quad reduction (kTiles = 4: lane t writes tile t), u summed
//   again in element order from the row and the codeword (L1 hits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kTiles = 4;                 // 16-row tiles a warp holds at once
constexpr int kRowsPerWarp = 16 * kTiles;
constexpr int kGroup = 2;                 // codeword tiles tracked together
constexpr unsigned kNone = 0xffffffffu;   // no index found

// How a lane holds a row: DIM/4 contiguous values as packed bf16 pairs
// (words), 2 words per k-step of 16.
template <int DIM>
struct Frag {
  static constexpr int kPer = DIM / 4;                    // values per row and lane
  static constexpr int kWords = kPer >= 2 ? kPer / 2 : 1;  // 32-bit words of two bf16
  static constexpr int kSteps = (kWords + 1) / 2;         // k-steps of the mma
};

// A lane's load of one row: DIM/4 values of TIn, in pieces of at most 16 bytes.
template <int DIM, typename TIn>
struct RowLoad {
  static constexpr int kBytes = DIM / 4 * (int)sizeof(TIn);
  // bf16 in 4-byte pieces: two rows' words then land straight in the mma's
  // A registers (8-byte pieces make the compiler move them at every mma)
  static constexpr int kMaxPiece = sizeof(TIn) == 2 ? 4 : 16;
  static constexpr int kPiece = kBytes < kMaxPiece ? kBytes : kMaxPiece;
  static constexpr int kRaw = kBytes >= 4 ? kBytes / 4 : 1;   // 32-bit words loaded
};

template <int N> struct Bits;
template <> struct Bits<2> { using T = unsigned short; };
template <> struct Bits<4> { using T = unsigned; };
template <> struct Bits<8> { using T = uint2; };
template <> struct Bits<16> { using T = uint4; };

template <int N>
union Piece {
  typename Bits<N>::T v;
  unsigned w[N >= 4 ? N / 4 : 1];
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int DIM, typename TIn>
__device__ __forceinline__ void load_row(const TIn* p, bool valid,
                                         unsigned (&raw)[RowLoad<DIM, TIn>::kRaw]) {
  using L = RowLoad<DIM, TIn>;
  constexpr int kPerPiece = L::kPiece >= 4 ? L::kPiece / 4 : 1;
#pragma unroll
  for (int i = 0; i < L::kRaw; ++i) raw[i] = 0u;
  if (!valid) return;
  const auto* src = reinterpret_cast<const typename Bits<L::kPiece>::T*>(p);
#pragma unroll
  for (int i = 0; i < L::kBytes / L::kPiece; ++i) {
    Piece<L::kPiece> c;
    c.w[0] = 0u;
    c.v = src[i];
#pragma unroll
    for (int w = 0; w < kPerPiece; ++w) raw[i * kPerPiece + w] = c.w[w];
  }
}

// One row's A-operand words: hi = bf16(x) and, for PASSES == 2, lo =
// bf16(x - bf16(x)).  A bf16 input is its own hi.
template <int DIM, int PASSES, typename TIn>
__device__ __forceinline__ void row_words(const unsigned (&raw)[RowLoad<DIM, TIn>::kRaw],
                                          unsigned (&hi)[Frag<DIM>::kWords],
                                          unsigned (&lo)[Frag<DIM>::kWords]) {
  using F = Frag<DIM>;
  if constexpr (sizeof(TIn) == 2) {
#pragma unroll
    for (int w = 0; w < F::kWords; ++w) hi[w] = raw[w];
  } else {
#pragma unroll
    for (int w = 0; w < F::kWords; ++w) {
      const float v0 = __uint_as_float(raw[2 * w]);
      const float v1 = 2 * w + 1 < F::kPer ? __uint_as_float(raw[2 * w + 1]) : 0.0f;
      hi[w] = pack_bf16(v0, v1);
      if constexpr (PASSES == 2) lo[w] = pack_bf16(v0 - bf16_round(v0), v1 - bf16_round(v1));
    }
  }
}

// d = A B (a zero accumulator) and d += A B, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.0f));
}

__device__ __forceinline__ void mma_bf16_acc(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One row tile's A fragments per k-step, for bf16(x) and, at PASSES == 2,
// bf16(x - bf16(x)): rows g (w[0]) and g + 8 (w[1]) in the mma's register order.
template <int DIM>
__device__ __forceinline__ void a_fragments(const unsigned (&w)[2][Frag<DIM>::kWords],
                                            unsigned (&a)[Frag<DIM>::kSteps][4]) {
  using F = Frag<DIM>;
#pragma unroll
  for (int s = 0; s < F::kSteps; ++s) {
    const bool two = 2 * s + 1 < F::kWords;
    a[s][0] = w[0][2 * s];
    a[s][1] = w[1][2 * s];
    a[s][2] = two ? w[0][2 * s + 1] : 0u;
    a[s][3] = two ? w[1][2 * s + 1] : 0u;
  }
}

// p[0], p[1] = row g with codewords 8j + 2t, 8j + 2t + 1; p[2], p[3] = row g + 8.
template <int DIM, int PASSES>
__device__ __forceinline__ void products(float (&p)[4],
                                         const unsigned (&a)[PASSES][Frag<DIM>::kSteps][4],
                                         const uint2 (&b)[Frag<DIM>::kSteps]) {
  using F = Frag<DIM>;
  mma_bf16(p, a[0][0], b[0]);
#pragma unroll
  for (int s = 1; s < F::kSteps; ++s) mma_bf16_acc(p, a[0][s], b[s]);
  if constexpr (PASSES == 2) {
    float q[4];
    mma_bf16(q, a[1][0], b[0]);
#pragma unroll
    for (int s = 1; s < F::kSteps; ++s) mma_bf16_acc(q, a[1][s], b[s]);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] += q[i];
  }
}

template <int DIM>
__device__ __forceinline__ void b_fragments(const uint2* frag, int j, int lane,
                                            uint2 (&b)[Frag<DIM>::kSteps]) {
#pragma unroll
  for (int s = 0; s < Frag<DIM>::kSteps; ++s) b[s] = frag[(j * Frag<DIM>::kSteps + s) * 32 + lane];
}

// The first index with p == +a goes to pos; the first with p == -a to neg.
// Once pos is found, later codewords cannot win: cmp becomes NaN.
__device__ __forceinline__ void record(float p, float a, unsigned idx, unsigned& pos,
                                       unsigned& neg, float& cmp) {
  if (p == a) {
    pos = min(pos, idx);
    cmp = __int_as_float(0x7fc00000);
  } else if (p == -a) {
    neg = min(neg, idx);
  }
}

// u of a row for its code, in the plain version's order (ops/hsq.py
// _dot_in_order): the products of bf16(x) with the codeword added in
// element order from +0; at PASSES == 2 those of bf16(x - bf16(x))
// likewise, the two sums then added.  Every product is exact in float32;
// __fmul_rn / __fadd_rn keep the compiler from contracting them.  The row
// is read as the main loads read it, a quarter (a lane's piece) at a time;
// the codeword by 16-byte loads where the codebook allows (c16).
template <int DIM, int PASSES, typename TIn>
__device__ __forceinline__ float dot_row(const TIn* __restrict__ xr,
                                         const float* __restrict__ c, bool c16) {
  using F = Frag<DIM>;
  using L = RowLoad<DIM, TIn>;
  float cv[DIM];
#pragma unroll
  for (int e = 0; e < DIM; e += 4) {
    const float4 q = c16 ? __ldg(reinterpret_cast<const float4*>(c + e))
                         : make_float4(__ldg(c + e), __ldg(c + e + 1), __ldg(c + e + 2),
                                       __ldg(c + e + 3));
    cv[e] = q.x, cv[e + 1] = q.y, cv[e + 2] = q.z, cv[e + 3] = q.w;
  }
  float hi = 0.0f, lo = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned raw[L::kRaw];
    load_row<DIM, TIn>(xr + q * F::kPer, true, raw);
#pragma unroll
    for (int i = 0; i < F::kPer; ++i) {
      float v;
      if constexpr (sizeof(TIn) == 4) v = __uint_as_float(raw[i]);
      else v = __uint_as_float(i & 1 ? raw[i >> 1] & 0xffff0000u : raw[i >> 1] << 16);
      const float vh = bf16_round(v), ce = cv[q * F::kPer + i];
      hi = __fadd_rn(hi, __fmul_rn(vh, ce));
      if constexpr (PASSES == 2) lo = __fadd_rn(lo, __fmul_rn(bf16_round(__fsub_rn(v, vh)), ce));
    }
  }
  return PASSES == 2 ? __fadd_rn(hi, lo) : hi;
}

template <int DIM, int PASSES, typename TIn, typename TCode>
__global__ void __launch_bounds__(kWarps * 32, 2) hsq_encode_tc_kernel(
    const TIn* __restrict__ x, const float* __restrict__ codebook, int k, int64_t rows,
    float* __restrict__ u_out, TCode* __restrict__ codes_out) {
  using F = Frag<DIM>;
  using L = RowLoad<DIM, TIn>;
  extern __shared__ uint2 frag[];   // [tile j][k-step s][lane]: b0, b1
  const int kt = (k + 8 * kGroup - 1) / (8 * kGroup) * kGroup;   // tiles, zero past K

  // the codebook in B-fragment order: lane (g, t) of tile j holds codeword
  // 8j + g, values t*DIM/4 ... as bf16 pairs (exact: the codebook is bf16-exact)
  for (int i = threadIdx.x; i < kt * F::kSteps * 32; i += blockDim.x) {
    const int lane = i & 31, s = (i >> 5) % F::kSteps, n = (i >> 5) / F::kSteps * 8 + (lane >> 2);
    unsigned w[2] = {0u, 0u};
    if (n < k) {
      const float* c = codebook + (int64_t)n * DIM + (lane & 3) * F::kPer;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = (2 * s + h) * 2;
        w[h] = pack_bf16(e < F::kPer ? c[e] : 0.0f, e + 1 < F::kPer ? c[e + 1] : 0.0f);
      }
    }
    frag[i] = make_uint2(w[0], w[1]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, t = lane & 3;
  const bool c16 = ((uintptr_t)codebook & 15) == 0;   // 16-byte codeword loads
  const int64_t tasks = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int64_t task = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); task < tasks;
       task += (int64_t)gridDim.x * kWarps) {
    const int64_t r0 = task * kRowsPerWarp + (lane >> 2);   // row g of tile 0
    unsigned a[kTiles][PASSES][F::kSteps][4];
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
      unsigned hi[2][F::kWords], lo[2][F::kWords];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = r0 + 16 * r + 8 * h;
        unsigned raw[L::kRaw];
        load_row<DIM, TIn>(x + row * DIM + t * F::kPer, row < rows, raw);
        row_words<DIM, PASSES, TIn>(raw, hi[h], lo[h]);
      }
      a_fragments<DIM>(hi, a[r][0]);
      if constexpr (PASSES == 2) a_fragments<DIM>(lo, a[r][PASSES - 1]);
    }

    // One pass over the codebook: per row, the lane's largest |p| (m), the
    // first group of kGroup tiles where it was reached (jg) and that group's
    // products.  A later group that only equals m (a tie) sends the warp to
    // the exact scan.
    constexpr int kKept = 2 * kGroup;
    float m[kTiles][2], kept[kTiles][2][kKept];
    unsigned jg[kTiles][2];
    bool tie = false;
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[r][h] = -1.0f;
        jg[r][h] = 0u;
#pragma unroll
        for (int i = 0; i < kKept; ++i) kept[r][h][i] = 0.0f;
      }
    }
    for (int j = 0; j < kt; j += kGroup) {
      uint2 b[kGroup][F::kSteps];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) b_fragments<DIM>(frag, j + q, lane, b[q]);
#pragma unroll
      for (int r = 0; r < kTiles; ++r) {
        float p[kGroup][4];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) products<DIM, PASSES>(p[q], a[r], b[q]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = fmaxf(fabsf(p[0][2 * h]), fabsf(p[0][2 * h + 1]));
#pragma unroll
          for (int q = 1; q < kGroup; ++q)
            v = fmaxf(v, fmaxf(fabsf(p[q][2 * h]), fabsf(p[q][2 * h + 1])));
          tie |= v == m[r][h];
          if (v > m[r][h]) {
            m[r][h] = v;
            jg[r][h] = j;
#pragma unroll
            for (int i = 0; i < kKept; ++i) kept[r][h][i] = p[i >> 1][2 * h + (i & 1)];
          }
        }
      }
    }
    // A = max |p| of the row: the maximum over the quad
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[r][h] = fmaxf(m[r][h], __shfl_xor_sync(0xffffffffu, m[r][h], 1));
        m[r][h] = fmaxf(m[r][h], __shfl_xor_sync(0xffffffffu, m[r][h], 2));
      }
    }

    // the lane's first indices with p == +A and with p == -A
    unsigned pos[kTiles][2], neg[kTiles][2];
    if (!__any_sync(0xffffffffu, tie)) {
      // no lane saw a tie across groups: its first +A or -A is in group jg,
      // whose products are kept in codeword order
#pragma unroll
      for (int r = 0; r < kTiles; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float am = m[r][h];
          pos[r][h] = neg[r][h] = kNone;
#pragma unroll
          for (int i = kKept - 1; i >= 0; --i) {
            const unsigned idx = 8u * (jg[r][h] + (i >> 1)) + 2u * t + (i & 1);
            if (kept[r][h][i] == am) pos[r][h] = idx;
            if (kept[r][h][i] == -am) neg[r][h] = idx;
          }
        }
      }
    } else {
      // exact scan: the same mma again (the same bits), one compare per
      // product; a lane that matches +A or -A records the index
      float cmp[kTiles][2];
#pragma unroll
      for (int r = 0; r < kTiles; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          cmp[r][h] = m[r][h];
          pos[r][h] = neg[r][h] = kNone;
        }
      }
      for (int j = 0; j < kt; ++j) {
        uint2 b[F::kSteps];
        b_fragments<DIM>(frag, j, lane, b);
        float p[kTiles][4];
        bool hit = false;
#pragma unroll
        for (int r = 0; r < kTiles; ++r) {
          products<DIM, PASSES>(p[r], a[r], b);
          hit |= (fabsf(p[r][0]) == cmp[r][0]) | (fabsf(p[r][1]) == cmp[r][0]) |
                 (fabsf(p[r][2]) == cmp[r][1]) | (fabsf(p[r][3]) == cmp[r][1]);
        }
        if (hit) {
          const unsigned idx = 8u * j + 2u * t;
#pragma unroll
          for (int r = 0; r < kTiles; ++r) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (cmp[r][h] == cmp[r][h]) {   // not NaN: +A not found yet
                record(p[r][2 * h], m[r][h], idx, pos[r][h], neg[r][h], cmp[r][h]);
                record(p[r][2 * h + 1], m[r][h], idx + 1, pos[r][h], neg[r][h], cmp[r][h]);
              }
            }
          }
        }
      }
    }

    // the code: the quad's first index with p = +A if a codeword gives +A
    // (max p >= -min p), else its first with p = -A.  Lane t keeps the
    // codes of row tile t, which it writes.
    static_assert(kTiles == 4, "lane t of a quad writes row tile t");
    unsigned mine[2] = {0u, 0u};
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned ip = pos[r][h], in = neg[r][h];
        ip = min(ip, __shfl_xor_sync(0xffffffffu, ip, 1));
        ip = min(ip, __shfl_xor_sync(0xffffffffu, ip, 2));
        in = min(in, __shfl_xor_sync(0xffffffffu, in, 1));
        in = min(in, __shfl_xor_sync(0xffffffffu, in, 2));
        if (r == t) mine[h] = ip != kNone ? ip : (in != kNone ? in : 0u);
      }
    }
    // u: the code's products in element order, every lane at once
    float u[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + 16 * t + 8 * h;
      const float* c = codebook + (int64_t)mine[h] * DIM;
      u[h] = row < rows ? dot_row<DIM, PASSES, TIn>(x + row * DIM, c, c16) : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + 16 * t + 8 * h;
      if (row < rows) {
        u_out[row] = u[h];
        codes_out[row] = (TCode)mine[h];
      }
    }
  }
}

template <int DIM, int PASSES, typename TIn, typename TCode>
int launch(const void* x, const float* codebook, int k, int64_t rows, float* u, void* codes,
           cudaStream_t stream) {
  auto kernel = hsq_encode_tc_kernel<DIM, PASSES, TIn, TCode>;
  const size_t smem = (size_t)(k + 8 * kGroup - 1) / (8 * kGroup) * kGroup * Frag<DIM>::kSteps * 32 *
                      sizeof(uint2);
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
      static_cast<const TIn*>(x), codebook, k, rows, u, static_cast<TCode*>(codes));
  return (int)cudaGetLastError();
}

template <int DIM>
int dispatch(const void* x, int x_bf16, const float* codebook, int k, int64_t rows, int passes,
             float* u, void* codes, int codes_u8, cudaStream_t s) {
#define GQX_ENC(P, TI, TC) return launch<DIM, P, TI, TC>(x, codebook, k, rows, u, codes, s)
  // a bf16 input has no low part: passes=2 contracts it as passes=1 does
  if (x_bf16) {
    if (codes_u8) GQX_ENC(1, __nv_bfloat16, uint8_t);
    GQX_ENC(1, __nv_bfloat16, int32_t);
  }
  if (passes == 1) {
    if (codes_u8) GQX_ENC(1, float, uint8_t);
    GQX_ENC(1, float, int32_t);
  }
  if (codes_u8) GQX_ENC(2, float, uint8_t);
  GQX_ENC(2, float, int32_t);
#undef GQX_ENC
}

}  // namespace

extern "C" {

// x: (users, m * dim) contiguous, float32 or bf16 (x_bf16), aligned to one
// load (a lane's dim/4 values, in pieces of at most 4 bytes of bf16 or 16
// of float32); codebook: (k, dim)
// float32, bf16-exact; u: (users, m) float32; codes: (users, m) uint8
// (codes_u8) or int32.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for an unsupported dim/passes or a codebook larger
// than shared memory, cudaErrorMisalignedAddress for a misaligned x.
int gqx_hsq_encode(const void* x, int x_bf16, const float* codebook, int k, int dim,
                   int64_t users, int64_t m, int passes, float* u, void* codes, int codes_u8,
                   void* stream) {
  if (passes != 1 && passes != 2) return (int)cudaErrorInvalidValue;
  if (dim != 4 && dim != 8 && dim != 16 && dim != 32) return (int)cudaErrorInvalidValue;
  if (k < 1 || (size_t)(k + 8 * kGroup - 1) / (8 * kGroup) * kGroup * (dim > 16 ? 2 : 1) * 32 *
                       sizeof(uint2) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int64_t bytes = dim / 4 * (x_bf16 ? 2 : 4), piece = x_bf16 ? 4 : 16;
  const int64_t align = bytes < piece ? bytes : piece;   // RowLoad::kPiece
  if ((uintptr_t)x % (uintptr_t)align) return (int)cudaErrorMisalignedAddress;
  const int64_t rows = users * m;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 4: return dispatch<4>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    case 8: return dispatch<8>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    case 16: return dispatch<16>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
    default: return dispatch<32>(x, x_bf16, codebook, k, rows, passes, u, codes, codes_u8, s);
  }
}

const char* gqx_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
