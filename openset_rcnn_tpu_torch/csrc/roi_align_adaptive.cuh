// The sample geometry of RoIAlignV2 (aligned, -0.5 offset) and the adaptive
// grid's per-bin axis tables, shared by csrc/roi_align_fwd.cu (K1's adaptive
// mode: axis_table) and csrc/roi_align_bwd.cu (K2: every mode's geometry;
// the f32 adaptive mode sums axis_walk's weights per cell, which are the
// tables' weights). _native.py hashes this header into both libraries'
// names, so an edit rebuilds both.
//
// The adaptive grid (TPU.ROI_SAMPLING_RATIO -1, the gather path's,
// openset_rcnn_tpu/ops/roi_align.py:93-94, 124-135, 188-193): per RoI and
// axis n = clip(ceil(bin extent), 1, 8) samples a bin, at
// p + (j + 0.5) / n bin units; a bin's value is the sum of its n_y x n_x
// bilinear samples over n_y * n_x (samples outside (-1, extent) add 0 and
// stay in the count).
//
// Bilinear RoIAlign is separable, so a bin's value is
//   sum_r sum_c wy(r) * wx(c) * f[r, c] / (n_y * n_x),
// where wy(r) sums, over the bin's y-samples, ok * (1 - frac) where r is the
// sample's lower neighbour and ok * frac where it is the upper one (and wx
// likewise). axis_table lists a bin's (cell, weight) pairs on one axis in
// ascending cell order, one pair per distinct cell.
//
// Its width is bounded statically, so no pair is ever dropped:
//   * each sample touches at most 2 cells, so a table holds at most
//     2n <= kMaxPairs = 16 pairs (reached by long, thin boxes: a 1344 x 4 px
//     box on P2 spans 48 cells a bin, and its 8 samples lie 6 cells apart);
//   * when the bin spans at most 8 cells, n >= bin extent puts consecutive
//     samples at most one cell apart, so the bin touches at most n + 1
//     distinct cells;
//   * a cell appears once per table, so a row or column of the map meets at
//     most P bins of one RoI.
// The merge needs no search. Sample positions are monotone in j (n > 1
// only when the bin extent exceeds 1, and a clamp is monotone), so both
// neighbours are monotone, and the only earlier cell above a lower
// neighbour x can be x + 1, an upper neighbour whose own lower neighbour
// was x (and whose weight is nonzero only if x's is). So every cell either
// equals one of the two latest distinct cells or lies above both:
// axis_table keeps those two pending in registers and emits a pair once
// the walk has passed it.
// A non-finite box gives finite weights: its positions are clamped into the
// map (fminf/fmaxf drop a NaN) and its samples are out of range (ok = 0).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLattice = 8;              // the adaptive grid's samples per bin axis at most
constexpr int kMaxPairs = 2 * kLattice;  // an axis table's pairs at most

struct Sample {
  int lo, hi;  // floor neighbour, min(floor + 1, extent - 1)
  float frac, ok;
};

// sample idx of the axis [lo, hi] on a lattice of S samples a bin, of which
// the bin takes n (n == S but on the adaptive grid): the forward kernel's
// geometry, operation for operation
__device__ __forceinline__ Sample sample_at(float lo, float hi, int P, int S, int n, int idx, int extent) {
  const float bin = (hi - lo) / (float)P;
  const float in_bins = (float)(idx / S) + ((float)(idx % S) + 0.5f) / (float)n;
  float v = lo + in_bins * bin;
  const float ext = (float)extent;
  Sample s;
  s.ok = (v > -1.0f && v < ext) ? 1.0f : 0.0f;
  v = fminf(fmaxf(v, 0.0f), ext - 1.0f);
  const float v0 = floorf(v);
  const float v1 = fminf(v0 + 1.0f, ext - 1.0f);
  s.lo = (int)v0;
  s.hi = (int)v1;
  s.frac = v - v0;
  return s;
}

// a[i] of a kernel parameter's per-level array, i in [0, N), read with
// constant offsets: indexing a parameter at run time makes ptxas copy the
// whole parameter struct into every thread's local memory (the 80 B stack
// frame of the static forward kernel, sizeof(Levels))
template <class T, int N>
__device__ __forceinline__ T at_level(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (i == j) v = a[j];
  return v;
}

// the adaptive grid's samples per bin on the axis [lo, hi]: ceil of the bin's
// extent, clipped to [1, kLattice] (the gather path's n_y, n_x)
__device__ __forceinline__ int adaptive_count(float lo, float hi, int P) {
  return (int)fminf(fmaxf(ceilf((hi - lo) / (float)P), 1.0f), (float)kLattice);
}

// The walk of bin `bin` on the axis [lo, hi] of `extent` cells, n samples a
// bin: calls add(cell, weight) for the lower, then the upper neighbour of
// each sample in turn (weight ok * (1 - frac), then ok * frac; 0 included).
// Summing the weights per cell in call order gives the bin's table.
template <class Add>
__device__ __forceinline__ void axis_walk(float lo, float hi, int P, int n, int bin, int extent, Add&& add) {
  for (int j = 0; j < n; ++j) {
    const Sample s = sample_at(lo, hi, P, kLattice, n, bin * kLattice + j, extent);
    add(s.lo, (1.0f - s.frac) * s.ok);
    add(s.hi, s.frac * s.ok);
  }
}

// The table of bin `bin` on the axis [lo, hi] of `extent` cells, n samples a
// bin: calls emit(i, cell, weight) for its i-th pair, cells ascending and
// distinct, and returns the number of pairs (<= 2n <= kMaxPairs). Pairs of
// weight 0 (samples out of range, a zero fraction) are left out. Weights sum
// in axis_walk's order, so they equal its per-cell sums bitwise.
template <class Emit>
__device__ __forceinline__ int axis_table(float lo, float hi, int P, int n, int bin, int extent, Emit&& emit) {
  int k = 0;
  int c0 = -1, c1 = -1;  // the two latest distinct cells, c0 < c1; -1: none yet
  float w0 = 0.0f, w1 = 0.0f;
  auto put = [&](int cell, float w) {
    if (w == 0.0f) return;
    if (cell == c1) {
      w1 += w;
    } else if (cell == c0) {
      w0 += w;
    } else {  // above c1: c0 is complete
      if (c0 >= 0) emit(k++, c0, w0);
      c0 = c1;
      w0 = w1;
      c1 = cell;
      w1 = w;
    }
  };
  axis_walk(lo, hi, P, n, bin, extent, put);
  if (c0 >= 0) emit(k++, c0, w0);
  if (c1 >= 0) emit(k++, c1, w1);
  return k;
}

}  // namespace
