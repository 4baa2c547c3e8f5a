// Multilevel RoIAlignV2 backward (aligned, -0.5 offset) for Hopper (sm_90a):
// d(features) from d(pooled).
//
// Replaces the TPU kernel roi_align_pallas_v2_bwd
// (openset_rcnn_tpu/ops/pallas/roi_align_v2.py:487, body _bwd_kernel
// :339-484), the backward of the custom VJP at
// openset_rcnn_tpu/ops/roi_align.py:402-437, in both of its modes. It is the
// transpose of csrc/roi_align_fwd.cu: exact bilinear RoIAlign with the FPN
// level given in `levels`. Boxes get no gradient.
//
// Inputs: the cotangent (B*R, P, P, C) f32; boxes (B*R, 4) f32 xyxy; levels
// (B*R,) int32 in [0, 4). Output: four per-level accumulators
// (B, H_l, W_l, C), which the caller rounds to the features' type. The f32
// kernel adds into accumulators the caller zeroed; the bf16 kernel writes
// every cell itself.
//
// roi_align_bwd, f32 accumulators (TPU.ROI_ALIGN_BWD pallas). The TPU
// kernel sums each RoI's window gradient once in f32 and adds it to the
// accumulator window in one read-add-write (roi_align_v2.py:404-451); it is
// race-free only because its grid runs in order. Here the RoIs of one image
// overlap and run in parallel, so the adds into the accumulators are atomic.
// Bound on the H100: bytes, the cotangent read and the f32 accumulators
// written (0.144 ms at B=4, R=512, C=256 on the 832x1344 pyramid); what
// limits a scatter is the number of atomic operations: one per (sample,
// neighbour, channel) is 784 per RoI and channel at (7, 2), most of them
// into a cell the same RoI has just added to.
//
// Design: the TPU kernel's form, with one atomic per touched cell. One
// 256-thread block per RoI.
//   * The sample geometry of the RoI's y and x axes (the forward's
//     operations, sample_at), then per axis the distinct rows (columns) that
//     its 2 * P * S neighbour entries reach, ascending, and for each the list
//     of (bin, weight * in_range) entries in the TPU kernel's sample order
//     (collect_entries, which the bf16 kernel calls too), stored CSR-style:
//     each axis has exactly 2 * P * S entries, so P * S <= 32 fits.
//   * The warps take the touched cells (rows x columns) in turn; a lane holds
//     8 channels as two float4 groups. For each cell it sums the f32 window
//     gradient as the TPU kernel does: d(x-interp) over the column's entries,
//     then d(y-interp) over the row's entries, the cotangent scaled by
//     1/count and read through L1. Then one 16-byte vector atomicAdd (sm_90)
//     adds it to the accumulator; scalar atomics where C % 4 != 0 or a
//     pointer is not 16-byte aligned. Cells whose entries all have weight 0
//     (samples outside the map) are skipped.
// Each RoI's contribution is thus its f32 window sum, rounded as JAX rounds
// it; only the order of the RoIs within a cell changes from run to run, so
// the card holds the kernel to its plain version within a tolerance. Times
// of this design and of the one it replaced: PERF.md.
//
// roi_align_bwd_bf16, bf16 accumulators (TPU.ROI_ALIGN_BWD pallas_bf16): the
// TPU kernel sums each RoI's window gradient in f32 and adds it to the bf16
// accumulator window in one read-add-write (roi_align_v2.py:444-451), so
// every (RoI, cell, channel) contribution is rounded to bf16 once, and a
// cell sees its image's RoIs in index order (the image-interleaved grid,
// roi_align_v2.py:527-539).
//
// Bound on the H100: bytes. At B=16, R=512, C=256 on the 832x1344 pyramid
// the cotangent read is 0.411 GB and the bf16 accumulators written 0.760 GB:
// 0.350 ms at 3.35 TB/s. A scatter into bf16 words needs a CAS loop per
// cell and channel pair, each waiting its round trip to L2, and leaves the
// order of a cell's roundings to the scheduler.
//
// Design (the times of this design and of the variants tried are in
// PERF.md): a gather, with owners instead of atomics. One block owns one tile
// of 8 x 16 cells of one (image, level) and a slice of 256 channels (all of
// them at C = 256); each of its 1024 threads owns 4 cells x 8 channels, their
// bf16 accumulators held in registers as packed bf16x2.
//   * The block scans its image's R RoIs in index order, 1024 at a time, and
//     keeps (warp ballot, then a prefix over the warps) those of its level
//     whose touched cells meet the tile. Sample positions are monotone in the
//     sample index, so the two end samples of each axis, computed by the
//     forward's own geometry, bound the touched rows and columns. The kept
//     list is in ascending RoI order by construction; nothing is sorted.
//   * Kept RoIs go in rounds of 8: the sample geometry of all 8 (the
//     forward's operations), then, per RoI and per tile row and column, the
//     list of (bin, weight) entries that reach it, in the TPU kernel's
//     sample order (sub-sample-major, the lower neighbour's entry before the
//     upper one's, so an edge-clamped neighbour takes two separate adds,
//     roi_align_v2.py:414-442). Three barriers per round, not per RoI.
//   * Each thread computes its cells' f32 window gradient exactly as the TPU
//     kernel does, d(x-interp) over the column's entries, then d(y-interp)
//     over the row's entries, reading the cotangent (scaled by 1/count)
//     through L1, and applies acc = bf16(f32(acc) + win) in registers, RoI
//     after RoI. Cells a RoI does not touch are skipped (acc + 0 == acc).
//   * At the end the block writes its tile once with 16-byte stores, zeros
//     included, so the caller allocates without zeroing.
// Deterministic: there are no atomics, and every cell applies its image's
// RoIs in index order, the TPU's order, so two launches are bitwise equal.
// The f32 window sums follow the TPU kernel's order, operation for
// operation; the plain version sums them in another order, so the card
// compares against it by tolerance.
//
// Why 1024 threads over all 256 channels: every block repeats the scan and
// the rounds' geometry for its tile, so narrower channel slices multiply
// that work; the cotangent is read through L1 rather than staged, since a
// round's 8 RoIs x 49 bins x 256 channels would not fit shared memory. The
// cost is that one block fills an SM's registers, so nothing overlaps a
// block's barrier phases, and a cell under a small RoI walks up to
// (2*P*S)^2 entries while the rest of the block waits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kMaxSamples = 32;                   // out_size * sampling_ratio per axis
constexpr int kMaxAxisEntries = 2 * kMaxSamples;  // (bin, weight) entries of one axis of one RoI

struct Levels {
  float* grad[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
};

struct Sample {
  int lo, hi;  // floor neighbour, min(floor + 1, extent - 1)
  float frac, ok;
};

// sample idx of the axis [lo, hi]: the forward kernel's geometry, operation
// for operation
__device__ __forceinline__ Sample sample_at(float lo, float hi, int P, int S, int idx, int extent) {
  const float bin = (hi - lo) / (float)P;
  const float in_bins = (float)(idx / S) + ((float)(idx % S) + 0.5f) / (float)S;
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

// The (bin, weight * in_range) entries through which one axis's samples
// (lo, hi, frac, ok indexed by sample, bin-major) reach row or column
// `cell`, in the TPU kernel's sample order: sub-sample-major, the lower
// neighbour's entry before the upper one's, so an edge-clamped neighbour
// takes two separate adds (roi_align_v2.py:414-442). Returns their number.
__device__ __forceinline__ int collect_entries(const int* lo, const int* hi, const float* frac, const float* ok,
                                               int P, int S, int cell, unsigned char* bin, float* wt) {
  int m = 0;
  for (int a = 0; a < S; ++a) {
    for (int pb = 0; pb < P; ++pb) {
      const int p = pb * S + a;
      const float fr = frac[p], o = ok[p];
      if (lo[p] == cell) {
        bin[m] = (unsigned char)pb;
        wt[m] = (1.0f - fr) * o;
        ++m;
      }
      if (hi[p] == cell) {
        bin[m] = (unsigned char)pb;
        wt[m] = fr * o;
        ++m;
      }
    }
  }
  return m;
}

// ------------------------------------------------------------- f32 accumulators

constexpr int kF32Threads = 256;
constexpr int kF32Vec = 8;  // channels per lane and pass: two float4 groups, 128 channels apart

// n (<= 4) cotangent values / count from p: a 16-byte load when vec, else
// masked scalar loads, zero beyond n
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float inv_count, float* out) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) out[v] = v < n ? __ldg(p + v) : 0.0f;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) out[v] = out[v] * inv_count;  // d(mean), as the TPU kernel scales it
}

// acc[0..n) += win[0..n): one 16-byte vector reduction when vec, else scalar
__device__ __forceinline__ void add4(float* acc, int n, bool vec, const float* win) {
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(acc), make_float4(win[0], win[1], win[2], win[3]));
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < n) atomicAdd(acc + v, win[v]);
  }
}

__global__ void __launch_bounds__(kF32Threads) roi_align_bwd_kernel(
    Levels lv, const float* __restrict__ boxes, const int* __restrict__ levels, const float* __restrict__ cot,
    int R, int C, int P, int S, bool vec) {
  __shared__ int s_lo[2][kMaxSamples];  // [axis][sample], samples bin-major as the forward's
  __shared__ int s_hi[2][kMaxSamples];
  __shared__ float s_frac[2][kMaxSamples];
  __shared__ float s_ok[2][kMaxSamples];
  __shared__ int s_cand[2][kMaxAxisEntries];  // [axis][2 * sample + upper]: the cell it reaches
  __shared__ unsigned char s_first[2][kMaxAxisEntries];
  // [axis][k]: the k-th touched row or column, ascending; its entries are
  // s_bin/s_wt[axis][s_off[k] .. s_off[k + 1])
  __shared__ int s_cell[2][kMaxAxisEntries];
  __shared__ int s_off[2][kMaxAxisEntries + 1];
  __shared__ unsigned char s_live[2][kMaxAxisEntries];  // some entry has a nonzero weight
  __shared__ int s_ncell[2];
  __shared__ unsigned char s_bin[2][kMaxAxisEntries];
  __shared__ float s_wt[2][kMaxAxisEntries];

  const int roi = blockIdx.x;
  const int b = roi / R;
  const int l = levels[roi];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int PS = P * S, NE = 2 * PS;
  const int t = threadIdx.x;

  if (t < 2 * PS) {
    const int axis = t < PS ? 0 : 1;  // 0: y, 1: x
    const int idx = t - axis * PS;
    const float scale = lv.inv_stride[l];
    const float* bx = boxes + 4 * (size_t)roi;
    const float lo = (axis == 0 ? bx[1] : bx[0]) * scale - 0.5f;
    const float hi = (axis == 0 ? bx[3] : bx[2]) * scale - 0.5f;
    const Sample s = sample_at(lo, hi, P, S, idx, axis == 0 ? H : W);
    s_lo[axis][idx] = s.lo;
    s_hi[axis][idx] = s.hi;
    s_frac[axis][idx] = s.frac;
    s_ok[axis][idx] = s.ok;
  }
  __syncthreads();
  // each axis's 2 * P * S neighbour entries: which is the first to reach its cell
  const int axis = t / NE, e = t % NE;
  int v = 0;
  if (t < 2 * NE) {
    v = (e & 1) ? s_hi[axis][e >> 1] : s_lo[axis][e >> 1];
    bool first = true;
    for (int f = 0; f < e; ++f) first = first && ((f & 1) ? s_hi[axis][f >> 1] : s_lo[axis][f >> 1]) != v;
    s_cand[axis][e] = v;
    s_first[axis][e] = first;
  }
  __syncthreads();
  // the first entry of each touched cell files the cell and its entry list
  if (t < 2 * NE && s_first[axis][e]) {
    int rank = 0, off = 0;
    for (int f = 0; f < NE; ++f) {
      if (s_cand[axis][f] < v) {
        ++off;
        rank += s_first[axis][f];
      }
    }
    const int m = collect_entries(s_lo[axis], s_hi[axis], s_frac[axis], s_ok[axis], P, S, v, s_bin[axis] + off,
                                  s_wt[axis] + off);
    bool live = false;
    for (int f = 0; f < m; ++f) live = live || s_wt[axis][off + f] != 0.0f;
    s_cell[axis][rank] = v;
    s_off[axis][rank] = off;
    s_live[axis][rank] = live;
    if (off + m == NE) {  // the last touched cell
      s_ncell[axis] = rank + 1;
      s_off[axis][rank + 1] = NE;
    }
  }
  __syncthreads();

  // each touched cell's window gradient, summed once, added once
  const int ny = s_ncell[0], nx = s_ncell[1];
  const int lane = t & 31, warp = t >> 5;
  float* acc = lv.grad[l] + (size_t)b * H * W * C;
  const float* g = cot + (size_t)roi * P * P * C;
  const float inv_count = 1.0f / (float)(S * S);
  for (int cell = warp; cell < ny * nx; cell += kF32Threads / 32) {
    const int ry = cell / nx, rx = cell % nx;
    if (!s_live[0][ry] || !s_live[1][rx]) continue;
    const int e0 = s_off[0][ry], e1 = s_off[0][ry + 1];
    const int f0 = s_off[1][rx], f1 = s_off[1][rx + 1];
    float* dst = acc + ((size_t)s_cell[0][ry] * W + s_cell[1][rx]) * C;
    for (int c0 = 4 * lane; c0 < C; c0 += 32 * kF32Vec) {
      const int c1 = c0 + 128;  // the lane's second group
      const int n0 = min(4, C - c0), n1 = min(4, C - c1);
      float win[kF32Vec];
#pragma unroll
      for (int k = 0; k < kF32Vec; ++k) win[k] = 0.0f;
      for (int ei = e0; ei < e1; ++ei) {
        // d(x-interp) of y-bin s_bin[0][ei] at this column, then its d(y-interp)
        const float* row = g + (size_t)s_bin[0][ei] * P * C;
        float dt1[kF32Vec];
#pragma unroll
        for (int k = 0; k < kF32Vec; ++k) dt1[k] = 0.0f;
        for (int fi = f0; fi < f1; ++fi) {
          const float* p = row + (size_t)s_bin[1][fi] * C;
          const float wx = s_wt[1][fi];
          float cv[kF32Vec];
          load4(p + c0, n0, vec, inv_count, cv);
          if (n1 > 0) {
            load4(p + c1, n1, vec, inv_count, cv + 4);
          } else {
#pragma unroll
            for (int k = 4; k < kF32Vec; ++k) cv[k] = 0.0f;
          }
#pragma unroll
          for (int k = 0; k < kF32Vec; ++k) dt1[k] = dt1[k] + cv[k] * wx;
        }
        const float wy = s_wt[0][ei];
#pragma unroll
        for (int k = 0; k < kF32Vec; ++k) win[k] = win[k] + dt1[k] * wy;
      }
      add4(dst + c0, n0, vec, win);
      if (n1 > 0) add4(dst + c1, n1, vec, win + 4);
    }
  }
}

// ------------------------------------------------------------ bf16 accumulators

constexpr int kTileH = 8;    // cells per tile: rows
constexpr int kTileW = 16;   // and columns
constexpr int kLists = kTileH + kTileW;  // entry lists per RoI: tile rows, then tile columns
constexpr int kCSlice = 256;  // channels per block
constexpr int kVec = 8;       // channels per thread: one 16-byte bf16 store
constexpr int kThreads = 1024;
constexpr int kGroups = kCSlice / kVec;                     // 32
constexpr int kOwners = kThreads / kGroups;                 // 32
constexpr int kCellsPerThread = kTileH * kTileW / kOwners;  // 4
constexpr int kRoiGroup = 8;                                // kept RoIs prepared per round
constexpr int kMaxPS = 16;                                  // out_size * sampling_ratio
constexpr int kMaxEntries = 2 * kMaxPS;                     // (bin, weight) entries of a row or column

struct LevelsBf16 {
  __nv_bfloat16* acc[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
  int tiles_x[kLevels];
  int tile_start[kLevels + 1];  // each level's first tile within an image; [kLevels]: tiles per image
};

// kVec cotangent values / count from p: two 16-byte loads when vec, else
// masked scalar loads, zero beyond n
__device__ __forceinline__ void load_cot(const float* p, int n, bool vec, float inv_count, float* out) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v) out[v] = v < n ? __ldg(p + v) : 0.0f;
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) out[v] = out[v] * inv_count;  // d(mean), as the TPU kernel scales it
}

__device__ __forceinline__ float lo_f32(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned int*>(&h);
}

__global__ void __launch_bounds__(kThreads) roi_align_bwd_bf16_kernel(
    LevelsBf16 lv, const float* __restrict__ boxes, const int* __restrict__ levels,
    const float* __restrict__ cot, int R, int C, int P, int S, bool vec) {
  __shared__ int s_keep[kThreads];           // kept RoIs of the chunk, ascending
  __shared__ int s_warp[kThreads / 32 + 1];  // kept per warp -> prefix; [last]: total
  // [RoI of the round][axis][sample], samples bin-major as the forward's
  __shared__ int s_lo[kRoiGroup][2][kMaxPS];
  __shared__ int s_hi[kRoiGroup][2][kMaxPS];
  __shared__ float s_frac[kRoiGroup][2][kMaxPS];
  __shared__ float s_ok[kRoiGroup][2][kMaxPS];
  // [RoI of the round][tile row, then tile column]: entries reaching it
  __shared__ int s_n[kRoiGroup][kLists];
  __shared__ unsigned char s_bin[kRoiGroup][kLists][kMaxEntries];  // entry: the sample's bin on that axis
  __shared__ float s_wt[kRoiGroup][kLists][kMaxEntries];           // entry: its weight * in_range

  const int per_image = lv.tile_start[kLevels];
  const int b = blockIdx.x / per_image;
  int tile = blockIdx.x % per_image;
  int l = 0;
  while (l + 1 < kLevels && tile >= lv.tile_start[l + 1]) ++l;
  tile -= lv.tile_start[l];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int ty0 = (tile / lv.tiles_x[l]) * kTileH;
  const int tx0 = (tile % lv.tiles_x[l]) * kTileW;
  const int t = threadIdx.x;
  const int grp = t % kGroups, owner = t / kGroups;
  const int c = blockIdx.y * kCSlice + grp * kVec;
  const int n = min(kVec, C - c);  // this thread's channels; <= 0: none
  const int PS = P * S;
  const float scale = lv.inv_stride[l];
  const float inv_count = 1.0f / (float)(S * S);
  const int lane = t & 31, warp = t >> 5;

  // the owned cells' bf16 accumulators, channel pairs packed as bf16x2
  unsigned int acc[kCellsPerThread][kVec / 2];
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i)
#pragma unroll
    for (int v = 0; v < kVec / 2; ++v) acc[i][v] = 0u;

  for (int chunk = 0; chunk < R; chunk += kThreads) {
    // keep the chunk's RoIs of this level whose touched cells meet the tile
    const int r = chunk + t;
    bool hit = false;
    if (r < R && levels[b * R + r] == l) {
      const float* bx = boxes + 4 * ((size_t)b * R + r);
      const float ylo = bx[1] * scale - 0.5f, yhi = bx[3] * scale - 0.5f;
      const float xlo = bx[0] * scale - 0.5f, xhi = bx[2] * scale - 0.5f;
      const Sample ya = sample_at(ylo, yhi, P, S, 0, H), yb = sample_at(ylo, yhi, P, S, PS - 1, H);
      const Sample xa = sample_at(xlo, xhi, P, S, 0, W), xb = sample_at(xlo, xhi, P, S, PS - 1, W);
      hit = max(ya.hi, yb.hi) >= ty0 && min(ya.lo, yb.lo) < ty0 + kTileH &&
            max(xa.hi, xb.hi) >= tx0 && min(xa.lo, xb.lo) < tx0 + kTileW;
    }
    const unsigned int mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    if (t == 0) {
      int sum = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int k = s_warp[w];
        s_warp[w] = sum;
        sum += k;
      }
      s_warp[kThreads / 32] = sum;
    }
    __syncthreads();
    if (hit) s_keep[s_warp[warp] + __popc(mask & ((1u << lane) - 1u))] = r;
    const int n_keep = s_warp[kThreads / 32];
    __syncthreads();

    for (int k0 = 0; k0 < n_keep; k0 += kRoiGroup) {
      const int kg = min(kRoiGroup, n_keep - k0);
      // the round's sample geometry: one sample of one axis of one RoI per thread
      if (t < kg * 2 * PS) {
        const int k = t / (2 * PS), j = t % (2 * PS);
        const int axis = j < PS ? 0 : 1;  // 0: y, 1: x
        const int idx = j - axis * PS;
        const float* bx = boxes + 4 * ((size_t)b * R + s_keep[k0 + k]);
        const float lo = (axis == 0 ? bx[1] : bx[0]) * scale - 0.5f;
        const float hi = (axis == 0 ? bx[3] : bx[2]) * scale - 0.5f;
        const Sample s = sample_at(lo, hi, P, S, idx, axis == 0 ? H : W);
        s_lo[k][axis][idx] = s.lo;
        s_hi[k][axis][idx] = s.hi;
        s_frac[k][axis][idx] = s.frac;
        s_ok[k][axis][idx] = s.ok;
      }
      __syncthreads();
      // each tile row's and column's entries, in the TPU kernel's sample
      // order: sub-sample-major, lower neighbour before upper
      if (t < kg * kLists) {
        const int k = t / kLists, j = t % kLists;
        const int axis = j < kTileH ? 0 : 1;
        const int cell = axis == 0 ? ty0 + j : tx0 + j - kTileH;
        s_n[k][j] = collect_entries(s_lo[k][axis], s_hi[k][axis], s_frac[k][axis], s_ok[k][axis], P, S, cell,
                                    s_bin[k][j], s_wt[k][j]);
      }
      __syncthreads();
      if (n > 0) {
        for (int k = 0; k < kg; ++k) {  // the round's RoIs, in index order
          const float* g = cot + ((size_t)b * R + s_keep[k0 + k]) * P * P * C + c;
#pragma unroll
          for (int i = 0; i < kCellsPerThread; ++i) {
            const int cell = owner + i * kOwners;
            const int ty = cell / kTileW, tx = kTileH + cell % kTileW;
            const int ny = s_n[k][ty], nx = s_n[k][tx];
            if (ny == 0 || nx == 0) continue;
            float win[kVec];
#pragma unroll
            for (int v = 0; v < kVec; ++v) win[v] = 0.0f;
            for (int e = 0; e < ny; ++e) {
              // d(x-interp) of y-bin pb at this column, then its d(y-interp)
              const float* row = g + (size_t)s_bin[k][ty][e] * P * C;
              float dt1[kVec];
#pragma unroll
              for (int v = 0; v < kVec; ++v) dt1[v] = 0.0f;
              for (int f = 0; f < nx; ++f) {
                float cv[kVec];
                load_cot(row + (size_t)s_bin[k][tx][f] * C, n, vec, inv_count, cv);
                const float wx = s_wt[k][tx][f];
#pragma unroll
                for (int v = 0; v < kVec; ++v) dt1[v] = dt1[v] + cv[v] * wx;
              }
              const float wy = s_wt[k][ty][e];
#pragma unroll
              for (int v = 0; v < kVec; ++v) win[v] = win[v] + dt1[v] * wy;
            }
#pragma unroll
            for (int v = 0; v < kVec / 2; ++v)
              acc[i][v] = pack_bf16x2(lo_f32(acc[i][v]) + win[2 * v], hi_f32(acc[i][v]) + win[2 * v + 1]);
          }
        }
      }
      __syncthreads();
    }
  }

  // the tile, written once
  if (n <= 0) return;
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    const int cell = owner + i * kOwners;
    const int y = ty0 + cell / kTileW, x = tx0 + cell % kTileW;
    if (y >= H || x >= W) continue;
    __nv_bfloat16* p = lv.acc[l] + (((size_t)b * H + y) * W + x) * C + c;
    if (vec) {
      *reinterpret_cast<uint4*>(p) = make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (v < n) q[v] = (unsigned short)((v & 1) ? acc[i][v / 2] >> 16 : acc[i][v / 2] & 0xffffu);
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// grads: 4 NHWC f32 level accumulators with their (h, w) and 1/stride,
// zeroed by the caller. Returns cudaGetLastError() after the launch (0 on
// success).
int roi_align_bwd(void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1, int h2,
                  int w2, int h3, int w3, float s0, float s1, float s2, float s3,
                  const float* boxes, const int* levels, const float* cot, int n_rois,
                  int rois_per_image, int C, int P, int S, void* stream) {
  if (P < 1 || S < 1 || P * S > kMaxSamples || C < 1 || n_rois <= 0 || rois_per_image <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.grad[0] = (float*)g0;
  lv.grad[1] = (float*)g1;
  lv.grad[2] = (float*)g2;
  lv.grad[3] = (float*)g3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.inv_stride[0] = s0; lv.inv_stride[1] = s1; lv.inv_stride[2] = s2; lv.inv_stride[3] = s3;
  bool vec = C % 4 == 0 && ((uintptr_t)cot % 16) == 0;
  for (int i = 0; i < kLevels; ++i) vec = vec && ((uintptr_t)lv.grad[i] % 16) == 0;
  roi_align_bwd_kernel<<<n_rois, kF32Threads, 0, (cudaStream_t)stream>>>(
      lv, boxes, levels, cot, rois_per_image, C, P, S, vec);
  return (int)cudaGetLastError();
}

// bf16 accumulators: grads are 4 NHWC bf16 level accumulators, every cell
// written by the kernel (no zeroing needed); C even and P * S <= 16.
// Returns cudaGetLastError() after the launch (0 on success).
int roi_align_bwd_bf16(void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1,
                       int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
                       const float* boxes, const int* levels, const float* cot, int n_rois,
                       int rois_per_image, int C, int P, int S, void* stream) {
  if (P < 1 || S < 1 || P * S > kMaxPS || (C & 1) || C < 2 || n_rois <= 0 || rois_per_image <= 0)
    return (int)cudaErrorInvalidValue;
  LevelsBf16 lv;
  lv.acc[0] = (__nv_bfloat16*)g0;
  lv.acc[1] = (__nv_bfloat16*)g1;
  lv.acc[2] = (__nv_bfloat16*)g2;
  lv.acc[3] = (__nv_bfloat16*)g3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.inv_stride[0] = s0; lv.inv_stride[1] = s1; lv.inv_stride[2] = s2; lv.inv_stride[3] = s3;
  bool vec = C % kVec == 0 && ((uintptr_t)cot % 16) == 0;
  lv.tile_start[0] = 0;
  for (int i = 0; i < kLevels; ++i) {
    vec = vec && ((uintptr_t)lv.acc[i] % 16) == 0;
    lv.tiles_x[i] = (lv.w[i] + kTileW - 1) / kTileW;
    lv.tile_start[i + 1] = lv.tile_start[i] + lv.tiles_x[i] * ((lv.h[i] + kTileH - 1) / kTileH);
  }
  const int batch = n_rois / rois_per_image;
  const dim3 grid(batch * lv.tile_start[kLevels], (C + kCSlice - 1) / kCSlice);
  roi_align_bwd_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      lv, boxes, levels, cot, rois_per_image, C, P, S, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
