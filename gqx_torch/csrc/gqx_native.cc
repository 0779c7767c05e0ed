// Host-side data pipeline of the port (C++17, OpenMP), bound with ctypes by
// gqx_torch/data/native.py and built with g++ by gqx_torch/ops/_build.py
// (load_host) into gqx_torch/_build/.
//
// The functions and their arithmetic are those of gqx's native library
// (native/gqx_native.cc), built with the same flags, so that the same
// seed gives the same bits:
//   - fused augmentation: pad -> random crop -> hflip -> normalize, uint8 in,
//     float32 out, parallel over the batch; each image's crop and flip come
//     from its own std::mt19937_64 seeded from the batch seed and its index,
//   - normalization alone,
//   - bit packing/unpacking of quantization levels into uint32 words
//     (gqx_torch/ops/pack.py's little-endian bit stream).
// It replaces no TPU kernel: it is host code in both packages.

#include <cstdint>
#include <cstring>
#include <random>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Fused augmentation.
// in:   (n, h, w, c) uint8
// out:  (n, h, w, c) float32, normalized with per-channel mean/std
// crop offsets are sampled in [0, 2*pad], flips with p=0.5, from `seed`.
// ---------------------------------------------------------------------------
void gqx_augment_batch(const uint8_t* in, float* out, int64_t n, int64_t h,
                       int64_t w, int64_t c, int pad, int do_flip,
                       const float* mean, const float* stdv, uint64_t seed) {
  const float inv255 = 1.0f / 255.0f;
  // precompute per-channel scale/shift: (x/255 - mean)/std
  float scale[8], shift[8];
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = inv255 / stdv[ch];
    shift[ch] = -mean[ch] / stdv[ch];
  }

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ull + i);
    int off_h = 0, off_w = 0;
    bool flip = false;
    if (pad > 0) {
      off_h = (int)(rng() % (uint64_t)(2 * pad + 1));
      off_w = (int)(rng() % (uint64_t)(2 * pad + 1));
    }
    if (do_flip) flip = (rng() & 1u) != 0;

    const uint8_t* src = in + i * h * w * c;
    float* dst = out + i * h * w * c;
    for (int64_t y = 0; y < h; ++y) {
      // source row in the virtually padded image
      int64_t sy = y + off_h - pad;
      for (int64_t x = 0; x < w; ++x) {
        int64_t sx = x + off_w - pad;
        int64_t dx = flip ? (w - 1 - x) : x;
        float* d = dst + (y * w + dx) * c;
        if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
          for (int64_t ch = 0; ch < c; ++ch) d[ch] = shift[ch];  // zero pixel
        } else {
          const uint8_t* s = src + (sy * w + sx) * c;
          for (int64_t ch = 0; ch < c; ++ch)
            d[ch] = (float)s[ch] * scale[ch] + shift[ch];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Normalize only (test-time path).
// ---------------------------------------------------------------------------
void gqx_normalize_batch(const uint8_t* in, float* out, int64_t n_pixels,
                         int64_t c, const float* mean, const float* stdv) {
  const float inv255 = 1.0f / 255.0f;
  float scale[8], shift[8];
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = inv255 / stdv[ch];
    shift[ch] = -mean[ch] / stdv[ch];
  }
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < n_pixels; ++p)
    for (int64_t ch = 0; ch < c; ++ch)
      out[p * c + ch] = (float)in[p * c + ch] * scale[ch] + shift[ch];
}

// ---------------------------------------------------------------------------
// Bit packing: n values of `bits` bits (little-endian bit order within the
// stream) -> ceil(n*bits/32) uint32 words.  Mirrors gqx.ops.pack.pack_bits.
// ---------------------------------------------------------------------------
void gqx_pack_bits(const uint32_t* values, uint32_t* words, int64_t n,
                   int bits) {
  int64_t n_words = (n * bits + 31) / 32;
  std::memset(words, 0, (size_t)n_words * 4);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t v = values[i] & ((bits == 32) ? 0xFFFFFFFFull : ((1ull << bits) - 1));
    int64_t bitpos = i * bits;
    int64_t word = bitpos >> 5;
    int off = (int)(bitpos & 31);
    words[word] |= (uint32_t)(v << off);
    if (off + bits > 32) words[word + 1] |= (uint32_t)(v >> (32 - off));
  }
}

void gqx_unpack_bits(const uint32_t* words, uint32_t* values, int64_t n,
                     int bits) {
  uint64_t mask = (bits == 32) ? 0xFFFFFFFFull : ((1ull << bits) - 1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t bitpos = i * bits;
    int64_t word = bitpos >> 5;
    int off = (int)(bitpos & 31);
    uint64_t v = words[word] >> off;
    if (off + bits > 32) v |= ((uint64_t)words[word + 1]) << (32 - off);
    values[i] = (uint32_t)(v & mask);
  }
}

int gqx_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
