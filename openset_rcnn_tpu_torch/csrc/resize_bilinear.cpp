// Bilinear resize of a uint8 3-channel image, bitwise equal to
// PIL.Image.resize(size, Image.BILINEAR), written straight into a padded
// buffer. Host code with a plain C interface, built with the host compiler
// by _native.py and called through ctypes by data/resize_native.py.
//
// Pillow's resample (libImaging/Resample.c) is exact integer arithmetic, so
// any evaluation order of its sums gives its bytes:
//   * per axis, precompute_coeffs builds a table in double precision:
//     filterscale = max(in / out, 1), support = filterscale, ksize =
//     ceil(support) * 2 + 1; output i reads inputs [xmin, xmin + n) with
//     center = (i + 0.5) * scale, xmin = (int)(center - support + 0.5)
//     clamped to 0, the end (int)(center + support + 0.5) clamped to in;
//     weight bilinear((x + xmin - center + 0.5) / filterscale), normalised
//     by the row's sum; normalize_coeffs_8bpc rounds each weight half away
//     from zero to 22-bit fixed point (PRECISION_BITS = 32 - 8 - 2);
//   * a horizontal pass over the input rows the vertical pass reads
//     (ImagingResampleInner's ybox_first .. ybox_last), then a vertical pass;
//     each output sum starts at 1 << 21 and ends in clip8 (>> 22, clamped to
//     0..255), so the intermediate rows are uint8 as in Pillow.
// Built with -ffp-contract=off: the tables' multiplies and adds round one by
// one, as Pillow's do, and no fast math.
//
// Design: zero weights contribute nothing to an integer sum, so each axis's
// table is trimmed to its nonzero taps and padded back with zero weights to
// one tap count for every output (start moved left where the padding would
// pass the input's end): an upscale has 2 taps (3 at most), a downscale by
// s about 2s. With AVX2 the horizontal pass takes 4 output pixels a step
// where their taps fit one 16-byte window of the source row (every upscale,
// downscales to about 1.3x); else scalar code. The vertical pass runs over a
// whole output row at a time with a fixed tap count, so the compiler
// vectorises it. The horizontal rows live in a ring of as
// many rows as the vertical pass has taps, each computed when an output row
// first needs it. The source's channel order can be reversed (a BGR view of
// RGB pixels, numpy's img[:, :, ::-1]) and the columns written mirrored
// (a horizontal flip) at no cost: the first swaps two sums' destinations,
// the second reverses the horizontal table. Only the margins of the padded
// buffer around the image are zeroed.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr int32_t kHalf = 1 << (kPrecisionBits - 1);

inline uint8_t clip8(int32_t in) {
  const int32_t v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// One axis: output i reads `taps` inputs from start[i] with the fixed-point
// weights weight[i * taps .. i * taps + taps).
struct Axis {
  int taps = 0;
  std::vector<int32_t> start;
  std::vector<int32_t> weight;
};

// Pillow's precompute_coeffs and normalize_coeffs_8bpc for the box
// (0, in_size), trimmed to the nonzero taps; `reverse` lists the outputs
// from the last.
Axis axis_table(int in_size, int out_size, bool reverse) {
  const double scale = static_cast<double>(static_cast<float>(in_size) - 0.0f) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<int32_t> fixed(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<int> first_in(out_size), lo(out_size), hi(out_size);
  std::vector<double> k(ksize);
  int taps = 1;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = 0.0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    first_in[xx] = xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    int32_t* q = &fixed[static_cast<size_t>(xx) * ksize];
    int first = -1, last = -1;
    for (int x = 0; x < xmax; ++x) {
      q[x] = k[x] < 0 ? static_cast<int32_t>(-0.5 + k[x] * (1 << kPrecisionBits))
                      : static_cast<int32_t>(0.5 + k[x] * (1 << kPrecisionBits));
      if (q[x] != 0) {
        if (first < 0) first = x;
        last = x;
      }
    }
    lo[xx] = first < 0 ? 0 : xmin + first;
    hi[xx] = first < 0 ? 0 : xmin + last + 1;
    if (hi[xx] - lo[xx] > taps) taps = hi[xx] - lo[xx];
  }
  Axis axis;
  axis.taps = taps;
  axis.start.resize(out_size);
  axis.weight.assign(static_cast<size_t>(out_size) * taps, 0);
  for (int i = 0; i < out_size; ++i) {
    const int xx = reverse ? out_size - 1 - i : i;
    const int start = lo[xx] < in_size - taps ? lo[xx] : in_size - taps;
    axis.start[i] = start;
    for (int p = lo[xx]; p < hi[xx]; ++p)
      axis.weight[static_cast<size_t>(i) * taps + (p - start)] =
          fixed[static_cast<size_t>(xx) * ksize + (p - first_in[xx])];
  }
  return axis;
}

// One output row of the horizontal pass, `width` pixels, in scalar code.
void horizontal_row(const uint8_t* src, const Axis& ax, int width, bool swap, uint8_t* __restrict dst) {
  const int taps = ax.taps;
  for (int i = 0; i < width; ++i) {
    const uint8_t* p = src + 3 * static_cast<int64_t>(ax.start[i]);
    const int32_t* k = ax.weight.data() + static_cast<int64_t>(i) * taps;
    int32_t s0 = kHalf, s1 = kHalf, s2 = kHalf;
    for (int t = 0; t < taps; ++t) {
      s0 += p[3 * t + 0] * k[t];
      s1 += p[3 * t + 1] * k[t];
      s2 += p[3 * t + 2] * k[t];
    }
    dst[3 * i + 0] = clip8(swap ? s2 : s0);
    dst[3 * i + 1] = clip8(s1);
    dst[3 * i + 2] = clip8(swap ? s0 : s2);
  }
}

// One output row of the vertical pass over `n` bytes of the horizontal
// rows, vectorised over i by the compiler; K > 0 fixes the tap count, which
// the vectoriser needs to keep the sums in registers.
template <int K>
void vertical_row(const uint8_t* const* rows, const int32_t* k, int runtime_taps, int64_t n, uint8_t* __restrict dst) {
  const int taps = K ? K : runtime_taps;
#pragma GCC ivdep
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = kHalf;
    for (int t = 0; t < taps; ++t) s += rows[t][i] * k[t];
    dst[i] = clip8(s);
  }
}

using VerticalFn = void (*)(const uint8_t* const*, const int32_t*, int, int64_t, uint8_t*);

// vertical_row for `taps`: fixed for 1..8 (an upscale's 2 or 3, a
// downscale's up to 4x), else at runtime.
template <int K = 1>
VerticalFn pick_vertical(int taps) {
  if constexpr (K > 8) {
    return vertical_row<0>;
  } else {
    return taps == K ? vertical_row<K> : pick_vertical<K + 1>(taps);
  }
}

// The horizontal pass. With AVX2, 4 output pixels (12 bytes) a step where
// every step's taps lie within a 16-byte window of the source row: per tap
// one 16-byte load, one byte shuffle that gathers the tap's pixel of each
// output (channels reversed when asked), and 8-lane 32-bit multiplies by
// the outputs' weights; else the scalar rows above.
class Horizontal {
 public:
  Horizontal(const Axis& axis, int in_w, int out_w, bool swap) : axis_(axis), out_w_(out_w), swap_(swap) {
#if defined(__AVX2__)
    vector_ = build_steps(in_w, swap);
#else
    (void)in_w;
#endif
  }

  // Writes 3 * out_w bytes and may write 16 more: dst has that room.
  void operator()(const uint8_t* src, uint8_t* dst) const {
#if defined(__AVX2__)
    if (vector_) return vector_row(src, dst);
#endif
    horizontal_row(src, axis_, out_w_, swap_, dst);
  }

 private:
  const Axis& axis_;
  const int out_w_;
  const bool swap_;
#if defined(__AVX2__)
  bool vector_ = false;
  // Per step s and tap t (index s * taps + t): the window's first byte,
  // the shuffle that picks 12 bytes from it (0x80: a zero byte), and the
  // 4 outputs' weights.
  std::vector<int32_t> base_;
  std::vector<uint8_t> shuffle_;
  std::vector<int32_t> weight_;

  bool build_steps(int in_w, bool swap) {
    const int taps = axis_.taps;
    if (3 * in_w < 16) return false;
    const int steps = (out_w_ + 3) / 4;
    base_.assign(static_cast<size_t>(steps) * taps, 0);
    shuffle_.assign(static_cast<size_t>(steps) * taps * 16, 0x80);
    weight_.assign(static_cast<size_t>(steps) * taps * 4, 0);
    for (int s = 0; s < steps; ++s) {
      const int n = out_w_ - 4 * s < 4 ? out_w_ - 4 * s : 4;
      int first = axis_.start[4 * s];
      for (int p = 1; p < n; ++p)
        if (axis_.start[4 * s + p] < first) first = axis_.start[4 * s + p];
      for (int t = 0; t < taps; ++t) {
        const size_t at = static_cast<size_t>(s) * taps + t;
        const int base = 3 * (first + t) < 3 * in_w - 16 ? 3 * (first + t) : 3 * in_w - 16;
        base_[at] = base;
        for (int p = 0; p < n; ++p) {
          const int i = 4 * s + p;
          for (int c = 0; c < 3; ++c) {
            const int byte = 3 * (axis_.start[i] + t) + (swap ? 2 - c : c) - base;
            if (byte > 15) return false;
            shuffle_[at * 16 + 3 * p + c] = static_cast<uint8_t>(byte);
          }
          weight_[at * 4 + p] = axis_.weight[static_cast<size_t>(i) * taps + t];
        }
      }
    }
    return true;
  }

  void vector_row(const uint8_t* src, uint8_t* dst) const {
    const int taps = axis_.taps;
    const int steps = (out_w_ + 3) / 4;
    // output byte 3p + c takes the weight of pixel p
    const __m256i spread_lo = _mm256_setr_epi32(0, 0, 0, 1, 1, 1, 2, 2);
    const __m256i spread_hi = _mm256_setr_epi32(2, 3, 3, 3, 3, 3, 3, 3);
    const int32_t* base = base_.data();
    const uint8_t* shuffle = shuffle_.data();
    const int32_t* weight = weight_.data();
    for (int s = 0; s < steps; ++s) {
      __m256i lo = _mm256_set1_epi32(kHalf), hi = lo;
      for (int t = 0; t < taps; ++t, ++base, shuffle += 16, weight += 4) {
        const __m128i window = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + *base));
        const __m128i bytes = _mm_shuffle_epi8(window, _mm_loadu_si128(reinterpret_cast<const __m128i*>(shuffle)));
        const __m256i w = _mm256_castsi128_si256(_mm_loadu_si128(reinterpret_cast<const __m128i*>(weight)));
        lo = _mm256_add_epi32(lo, _mm256_mullo_epi32(_mm256_cvtepu8_epi32(bytes), _mm256_permutevar8x32_epi32(w, spread_lo)));
        hi = _mm256_add_epi32(hi, _mm256_mullo_epi32(_mm256_cvtepu8_epi32(_mm_srli_si128(bytes, 8)),
                                                     _mm256_permutevar8x32_epi32(w, spread_hi)));
      }
      // clip8: >> 22, then the saturating packs clamp to 0..255
      const __m256i words = _mm256_permute4x64_epi64(
          _mm256_packus_epi32(_mm256_srai_epi32(lo, kPrecisionBits), _mm256_srai_epi32(hi, kPrecisionBits)), 0xD8);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + 12 * s),
                       _mm_packus_epi16(_mm256_castsi256_si128(words), _mm256_extracti128_si256(words, 1)));
    }
  }
#endif
};

}  // namespace

extern "C" {

// Resize src (in_h, in_w, 3) uint8, rows src_row_stride bytes apart and
// pixels 3 bytes apart, to (out_h, out_w) as PIL's BILINEAR does, into the
// top left of dst (dst_h, dst_w, 3), rows dst_row_stride bytes apart; the
// rest of dst's (dst_h, dst_w) is zeroed. swap_channels: the image is src's
// pixels with the channel order reversed; mirror: columns are written
// right to left. Returns 0, or 1 for arguments out of range.
int resize_bilinear_u8c3(const uint8_t* src, int64_t in_h, int64_t in_w, int64_t src_row_stride, int swap_channels,
                         uint8_t* dst, int64_t out_h, int64_t out_w, int64_t dst_h, int64_t dst_w,
                         int64_t dst_row_stride, int mirror) {
  const int64_t limit = 1 << 24;
  if (in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || in_h >= limit || in_w >= limit || out_h >= limit ||
      out_w >= limit || out_h > dst_h || out_w > dst_w || src_row_stride < 3 * in_w || dst_row_stride < 3 * dst_w)
    return 1;
  const Axis hx = axis_table(static_cast<int>(in_w), static_cast<int>(out_w), mirror != 0);
  const Axis vy = axis_table(static_cast<int>(in_h), static_cast<int>(out_h), false);
  const Horizontal horizontal(hx, static_cast<int>(in_w), static_cast<int>(out_w), swap_channels != 0);
  const VerticalFn vertical = pick_vertical(vy.taps);

  const int64_t row = 3 * out_w;
  const int64_t ring_row = row + 16;
  const int ring_rows = vy.taps;
  std::vector<uint8_t> ring(static_cast<size_t>(ring_rows) * ring_row);
  std::vector<int64_t> held(ring_rows, -1);
  std::vector<const uint8_t*> rows(ring_rows);
  for (int64_t yy = 0; yy < out_h; ++yy) {
    for (int t = 0; t < vy.taps; ++t) {
      const int64_t y = vy.start[yy] + t;
      const int slot = static_cast<int>(y % ring_rows);
      uint8_t* h = ring.data() + slot * ring_row;
      if (held[slot] != y) {
        horizontal(src + y * src_row_stride, h);
        held[slot] = y;
      }
      rows[t] = h;
    }
    uint8_t* out = dst + yy * dst_row_stride;
    vertical(rows.data(), vy.weight.data() + yy * vy.taps, vy.taps, row, out);
    if (dst_w > out_w) std::memset(out + row, 0, 3 * (dst_w - out_w));
  }
  for (int64_t yy = out_h; yy < dst_h; ++yy) std::memset(dst + yy * dst_row_stride, 0, 3 * dst_w);
  return 0;
}

}  // extern "C"
