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
// (B, H_l, W_l, C), f32 (roi_align_bwd, TPU.ROI_ALIGN_BWD pallas) or bf16
// (roi_align_bwd_bf16, pallas_bf16), which the caller rounds to the
// features' type. The kernel writes every cell, so the caller allocates
// without zeroing.
//
// What the TPU kernel computes: per RoI, the f32 window gradient (the two
// interpolation steps transposed: d(x-interp), then d(y-interp)), added to
// the accumulator window in one read-add-write (roi_align_v2.py:404-451),
// so every (RoI, cell, channel) contribution is one add in the accumulator's
// type (one bf16 rounding in the bf16 mode), and a cell sees its image's
// RoIs in index order (the image-interleaved grid, roi_align_v2.py:527-539).
// It is race-free only because its grid runs in order.
//
// Bound on the H100: bytes, the cotangent read and the accumulators written
// once: at R=512, C=256 on the 832x1344 pyramid 0.144 ms f32 at B=4 and
// 0.350 ms bf16 at B=16 (3.35 TB/s). Here the RoIs run in parallel: a
// scatter needs atomics (an f32 atomic add per cell, a CAS loop per bf16
// pair), whose order changes from run to run.
//
// Design: a gather, with owners instead of atomics (the times of this design
// and of those it replaced are in PERF.md). One template serves both modes;
// an accumulator policy (F32Acc, Bf16Acc) fixes how a thread holds its
// channels. One block owns one tile of 8 x 16 cells of one (image, level)
// and a slice of channels; each of its 1024 threads owns 4 cells x kVec
// channels in registers: bf16 8 channels as packed bf16x2 (a 256-channel
// slice), f32 4 channels (a 128-channel slice, two slices at C = 256), so
// both hold 16 accumulator registers.
//   * The block scans its image's R RoIs in index order, 1024 at a time, and
//     keeps (warp ballot, then a prefix over the warps) those of its level
//     whose touched cells meet the tile. Sample positions are monotone in the
//     sample index, so the two end samples of each axis, computed by the
//     forward's own geometry (sample_at), bound the touched rows and columns.
//     The kept list is in ascending RoI order by construction.
//   * Kept RoIs go in rounds of 8: the sample geometry of all 8, then, per
//     RoI and per tile row and column, the list of (bin, weight * in_range)
//     entries that reach it, in the TPU kernel's sample order
//     (collect_entries: sub-sample-major, the lower neighbour's entry before
//     the upper one's, so an edge-clamped neighbour takes two separate adds,
//     roi_align_v2.py:414-442). Three barriers per round, not per RoI.
//   * Each thread computes its cells' f32 window gradient as the TPU kernel
//     does, d(x-interp) over the column's entries, then d(y-interp) over the
//     row's entries, reading the cotangent (scaled by 1/count) through L1,
//     and applies it in registers, RoI after RoI: acc = acc + win (f32) or
//     acc = bf16(f32(acc) + win) (bf16). Cells a RoI does not touch are
//     skipped (acc + 0 == acc).
//   * At the end the block writes its tile once with 16-byte stores (scalar
//     stores where C is not a multiple of kVec or a pointer is not 16-byte
//     aligned), zeros included.
// Deterministic: there are no atomics, and every cell applies its image's
// RoIs in index order, the TPU's order, so two launches are bitwise equal.
// The window sums follow the TPU kernel's order, operation for operation;
// the plain version sums in another order, so the card compares against it
// by tolerance.
//
// Costs: every block repeats the scan and the rounds' geometry for its tile
// (twice per tile at C = 256 in the f32 mode); the cotangent is read through
// L1 rather than staged, since a round's 8 RoIs x 49 bins x C channels would
// not fit shared memory; one block fills an SM's registers, so nothing
// overlaps a block's barrier phases; a cell under a small RoI walks up to
// (2*P*S)^2 entries while the rest of the block waits.
//
// The adaptive grid (S == -1, TPU.ROI_SAMPLING_RATIO -1; f32 accumulators
// only) has its own kernel, roi_align_bwd_adaptive_kernel, on the per-bin
// axis tables of csrc/roi_align_adaptive.cuh (n = clip(ceil(bin extent),
// 1, 8) samples a bin axis, up to 16 distinct cells per bin and axis).
// Owners, the scan and the order of RoIs are the static grid's, so it is
// deterministic too; the sums within a RoI are reassociated (the gather
// path's VJP, its reference, sums in XLA's order):
//   * 512 threads, one warp per tile column (16), a lane per 4 channels
//     (two 128-channel slices at C = 256): a thread holds the column's
//     8 rows x 4 f32 accumulators, 64 registers without spills or stack,
//     two blocks an SM, so one block's barrier phases overlap the other's
//     work. The scan and the tables are repeated per slice; one slice of 8
//     channels a thread (120 registers, one block an SM) measured slower
//     (PERF.md §6).
//   * Kept RoIs go in rounds of kRound = 32. Per round, one thread per
//     (RoI, axis, bin) walks its bin (axis_walk) and sums each sample's
//     neighbour weights per cell into dense per-tile arrays, which gives
//     the bin's table weights bitwise: wy[RoI][y-bin][tile row] (times the
//     RoI's 1 / (n_y * n_x): the count enters once, not per load) and
//     wx[RoI][tile column][x-bin], zero where the bin misses the row or
//     column. A row or column meets at most P = 7 bins of a RoI, so a
//     round's weights take ~21 KB where the static layout's per-sample
//     entry lists took 8 x 24 x 112 entries; the whole block ~24 KB. One
//     barrier before the round's work, one after.
//   * The per-level fields are read with constant offsets (at_level), so
//     no thread copies the parameters into local memory.
//   * Per RoI a warp takes the bins that meet its column (a ballot over the
//     x-weights) and the y-bins that meet the tile's rows: per y-bin
//     dt = sum over the x-bins of wx * cot[y-bin, x-bin] (one 16-byte load
//     each, 1-4 a RoI in the usual case), then acc[row] += wy[y-bin][row] *
//     dt for the 8 rows (zero weights where the bin misses the row).
//   * The tile is written once at the end, zeros included, as above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_adaptive.cuh"

namespace {

constexpr int kLevels = 4;

// The (bin, weight * in_range) entries through which one axis's samples
// (lo, hi, frac, ok indexed by sample, bin-major, S a bin of which the
// first n are taken) reach row or column `cell`, in the TPU kernel's sample
// order: sub-sample-major, the lower neighbour's entry before the upper
// one's, so an edge-clamped neighbour takes two separate adds
// (roi_align_v2.py:414-442). Returns their number.
__device__ __forceinline__ int collect_entries(const int* lo, const int* hi, const float* frac, const float* ok,
                                               int P, int S, int n, int cell, unsigned char* bin, float* wt) {
  int m = 0;
  for (int a = 0; a < n; ++a) {
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

// ---------------------------------------------------------- the owner kernel
//
// One template for both accumulator types; an accumulator policy says how
// a thread holds its channels, adds a window sum and stores its cells.

constexpr int kTileH = 8;    // cells per tile: rows
constexpr int kTileW = 16;   // and columns
constexpr int kLists = kTileH + kTileW;  // entry lists per RoI: tile rows, then tile columns
constexpr int kThreads = 1024;
constexpr int kGroups = 32;                                 // channel groups per block: a warp's lanes
constexpr int kOwners = kThreads / kGroups;                 // 32
constexpr int kCellsPerThread = kTileH * kTileW / kOwners;  // 4
constexpr int kRoiGroup = 8;                                // kept RoIs prepared per round

// bf16 accumulators: 8 channels a thread, packed as bf16x2 words, rounded
// once per RoI (acc = bf16(f32(acc) + win)); P * S <= 16.
struct Bf16Acc {
  using Elem = __nv_bfloat16;
  using Word = unsigned int;
  static constexpr int kVec = 8;    // channels per thread: one 16-byte store
  static constexpr int kWords = 4;
  static constexpr int kMaxPS = 16;

  __device__ static float lo_f32(unsigned int w) { return __uint_as_float(w << 16); }
  __device__ static float hi_f32(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static void add(Word* acc, const float* win) {
#pragma unroll
    for (int v = 0; v < kWords; ++v) {
      __nv_bfloat162 h = __floats2bfloat162_rn(lo_f32(acc[v]) + win[2 * v], hi_f32(acc[v]) + win[2 * v + 1]);
      acc[v] = *reinterpret_cast<unsigned int*>(&h);
    }
  }
  __device__ static void store(Elem* p, const Word* acc, int n, bool vec) {
    if (vec) {
      *reinterpret_cast<uint4*>(p) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (v < n) q[v] = (unsigned short)((v & 1) ? acc[v / 2] >> 16 : acc[v / 2] & 0xffffu);
    }
  }
};

// f32 accumulators: 4 channels a thread (as many accumulator registers as
// the bf16 policy), acc = acc + win; P * S <= 32.
struct F32Acc {
  using Elem = float;
  using Word = float;
  static constexpr int kVec = 4;    // channels per thread: one 16-byte store
  static constexpr int kWords = 4;
  static constexpr int kMaxPS = 32;

  __device__ static void add(Word* acc, const float* win) {
#pragma unroll
    for (int v = 0; v < kWords; ++v) acc[v] = acc[v] + win[v];
  }
  __device__ static void store(Elem* p, const Word* acc, int n, bool vec) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (v < n) p[v] = acc[v];
    }
  }
};

struct OwnerLevels {
  void* acc[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
  int tiles_x[kLevels];
  int tile_start[kLevels + 1];  // each level's first tile within an image; [kLevels]: tiles per image
};

// The block's shared memory (dynamic: above 48 KB for the f32 policy's
// 32-sample axes).
template <class Acc>
struct OwnerShared {
  int keep[kThreads];           // kept RoIs of the chunk, ascending
  int warp[kThreads / 32 + 1];  // kept per warp -> prefix; [last]: total
  // [RoI of the round][axis][sample], samples bin-major as the forward's
  int lo[kRoiGroup][2][Acc::kMaxPS];
  int hi[kRoiGroup][2][Acc::kMaxPS];
  float frac[kRoiGroup][2][Acc::kMaxPS];
  float ok[kRoiGroup][2][Acc::kMaxPS];
  int cnt[kRoiGroup][2];  // [RoI of the round][axis]: samples a bin takes
  // [RoI of the round][tile row, then tile column]: entries reaching it
  int n[kRoiGroup][kLists];
  float wt[kRoiGroup][kLists][2 * Acc::kMaxPS];           // entry: its weight * in_range
  unsigned char bin[kRoiGroup][kLists][2 * Acc::kMaxPS];  // entry: the sample's bin on that axis
};

// kVec f32 values from p: 16-byte loads when vec, else masked scalar loads,
// zero beyond n
template <int kVec>
__device__ __forceinline__ void load_f32(const float* p, int n, bool vec, float* out) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      out[4 * q] = a.x; out[4 * q + 1] = a.y; out[4 * q + 2] = a.z; out[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v) out[v] = v < n ? __ldg(p + v) : 0.0f;
  }
}

// kVec cotangent values from p, times inv_count: d(mean), as the TPU kernel
// scales it
template <int kVec>
__device__ __forceinline__ void load_cot(const float* p, int n, bool vec, float inv_count, float* out) {
  load_f32<kVec>(p, n, vec, out);
#pragma unroll
  for (int v = 0; v < kVec; ++v) out[v] = out[v] * inv_count;
}

template <class Acc>
__device__ __forceinline__ void owner_body(OwnerShared<Acc>& sh, const OwnerLevels& lv,
                                           const float* __restrict__ boxes, const int* __restrict__ levels,
                                           const float* __restrict__ cot, int R, int C, int P, int S, bool vec) {
  constexpr int kVec = Acc::kVec;
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
  const int c = (blockIdx.y * kGroups + grp) * kVec;
  const int n = min(kVec, C - c);  // this thread's channels; <= 0: none
  const int PS = P * S;
  const float scale = lv.inv_stride[l];
  const float inv_count = 1.0f / (float)(S * S);
  const int lane = t & 31, warp = t >> 5;

  typename Acc::Word acc[kCellsPerThread][Acc::kWords];
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i)
#pragma unroll
    for (int v = 0; v < Acc::kWords; ++v) acc[i][v] = 0;

  for (int chunk = 0; chunk < R; chunk += kThreads) {
    // keep the chunk's RoIs of this level whose touched cells meet the tile
    const int r = chunk + t;
    bool hit = false;
    if (r < R && levels[b * R + r] == l) {
      const float* bx = boxes + 4 * ((size_t)b * R + r);
      const float ylo = bx[1] * scale - 0.5f, yhi = bx[3] * scale - 0.5f;
      const float xlo = bx[0] * scale - 0.5f, xhi = bx[2] * scale - 0.5f;
      // the first and the last sample taken on each axis
      const int ny = S, nx = S;
      const int ly = (P - 1) * S + ny - 1, lx = (P - 1) * S + nx - 1;
      const Sample ya = sample_at(ylo, yhi, P, S, ny, 0, H), yb = sample_at(ylo, yhi, P, S, ny, ly, H);
      const Sample xa = sample_at(xlo, xhi, P, S, nx, 0, W), xb = sample_at(xlo, xhi, P, S, nx, lx, W);
      hit = max(ya.hi, yb.hi) >= ty0 && min(ya.lo, yb.lo) < ty0 + kTileH &&
            max(xa.hi, xb.hi) >= tx0 && min(xa.lo, xb.lo) < tx0 + kTileW;
    }
    const unsigned int mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) sh.warp[warp] = __popc(mask);
    __syncthreads();
    if (t == 0) {
      int sum = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int k = sh.warp[w];
        sh.warp[w] = sum;
        sum += k;
      }
      sh.warp[kThreads / 32] = sum;
    }
    __syncthreads();
    if (hit) sh.keep[sh.warp[warp] + __popc(mask & ((1u << lane) - 1u))] = r;
    const int n_keep = sh.warp[kThreads / 32];
    __syncthreads();

    for (int k0 = 0; k0 < n_keep; k0 += kRoiGroup) {
      const int kg = min(kRoiGroup, n_keep - k0);
      // the round's sample geometry: one sample of one axis of one RoI per thread
      if (t < kg * 2 * PS) {
        const int k = t / (2 * PS), j = t % (2 * PS);
        const int axis = j < PS ? 0 : 1;  // 0: y, 1: x
        const int idx = j - axis * PS;
        const float* bx = boxes + 4 * ((size_t)b * R + sh.keep[k0 + k]);
        const float lo = (axis == 0 ? bx[1] : bx[0]) * scale - 0.5f;
        const float hi = (axis == 0 ? bx[3] : bx[2]) * scale - 0.5f;
        const int na = S;
        const Sample s = sample_at(lo, hi, P, S, na, idx, axis == 0 ? H : W);
        if (idx == 0) sh.cnt[k][axis] = na;
        sh.lo[k][axis][idx] = s.lo;
        sh.hi[k][axis][idx] = s.hi;
        sh.frac[k][axis][idx] = s.frac;
        sh.ok[k][axis][idx] = s.ok;
      }
      __syncthreads();
      // each tile row's and column's entries, in the TPU kernel's sample
      // order: sub-sample-major, lower neighbour before upper
      if (t < kg * kLists) {
        const int k = t / kLists, j = t % kLists;
        const int axis = j < kTileH ? 0 : 1;
        const int cell = axis == 0 ? ty0 + j : tx0 + j - kTileH;
        sh.n[k][j] = collect_entries(sh.lo[k][axis], sh.hi[k][axis], sh.frac[k][axis], sh.ok[k][axis], P, S,
                                     sh.cnt[k][axis], cell, sh.bin[k][j], sh.wt[k][j]);
      }
      __syncthreads();
      if (n > 0) {
        for (int k = 0; k < kg; ++k) {  // the round's RoIs, in index order
          const float* g = cot + ((size_t)b * R + sh.keep[k0 + k]) * P * P * C + c;
#pragma unroll
          for (int i = 0; i < kCellsPerThread; ++i) {
            const int cell = owner + i * kOwners;
            const int ty = cell / kTileW, tx = kTileH + cell % kTileW;
            const int ny = sh.n[k][ty], nx = sh.n[k][tx];
            if (ny == 0 || nx == 0) continue;  // untouched: acc + 0 == acc
            float win[kVec];
#pragma unroll
            for (int v = 0; v < kVec; ++v) win[v] = 0.0f;
            for (int e = 0; e < ny; ++e) {
              // d(x-interp) of y-bin pb at this column, then its d(y-interp)
              const float* row = g + (size_t)sh.bin[k][ty][e] * P * C;
              float dt1[kVec];
#pragma unroll
              for (int v = 0; v < kVec; ++v) dt1[v] = 0.0f;
              for (int f = 0; f < nx; ++f) {
                float cv[kVec];
                load_cot<kVec>(row + (size_t)sh.bin[k][tx][f] * C, n, vec, inv_count, cv);
                const float wx = sh.wt[k][tx][f];
#pragma unroll
                for (int v = 0; v < kVec; ++v) dt1[v] = dt1[v] + cv[v] * wx;
              }
              const float wy = sh.wt[k][ty][e];
#pragma unroll
              for (int v = 0; v < kVec; ++v) win[v] = win[v] + dt1[v] * wy;
            }
            Acc::add(acc[i], win);
          }
        }
      }
      __syncthreads();
    }
  }

  // the tile, written once
  if (n <= 0) return;
  typename Acc::Elem* base = static_cast<typename Acc::Elem*>(lv.acc[l]);
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i) {
    const int cell = owner + i * kOwners;
    const int y = ty0 + cell / kTileW, x = tx0 + cell % kTileW;
    if (y >= H || x >= W) continue;
    Acc::store(base + (((size_t)b * H + y) * W + x) * C + c, acc[i], n, vec);
  }
}

// Two entry points with their own names, so a profile tells the modes apart.
__global__ void __launch_bounds__(kThreads) roi_align_bwd_kernel(
    OwnerLevels lv, const float* __restrict__ boxes, const int* __restrict__ levels,
    const float* __restrict__ cot, int R, int C, int P, int S, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  owner_body<F32Acc>(*reinterpret_cast<OwnerShared<F32Acc>*>(smem), lv, boxes, levels, cot, R, C, P, S, vec);
}

__global__ void __launch_bounds__(kThreads) roi_align_bwd_bf16_kernel(
    OwnerLevels lv, const float* __restrict__ boxes, const int* __restrict__ levels,
    const float* __restrict__ cot, int R, int C, int P, int S, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  owner_body<Bf16Acc>(*reinterpret_cast<OwnerShared<Bf16Acc>*>(smem), lv, boxes, levels, cot, R, C, P, S, vec);
}

// ------------------------------------------------- the adaptive grid (f32)

constexpr int kAThreads = 512;
constexpr int kRound = 32;  // kept RoIs per round
constexpr int kMaxAP = 7;   // the adaptive grid's out_size at most (out_size * kLattice <= 56)
constexpr int kAVec = 4;     // channels a thread: two 128-channel slices at C = 256
static_assert(kAThreads / kGroups == kTileW, "one warp per tile column");
static_assert(kRound * 2 * kMaxAP <= kAThreads, "one thread per (RoI, axis, bin) of a round");

struct AdaptiveShared {
  // [RoI of the round][y-bin][tile row]: the weight * (1 / (n_y * n_x)), 0
  // where the bin misses the row
  __align__(16) float wy[kRound][kMaxAP][kTileH];
  float wx[kRound][kTileW][kMaxAP];  // [RoI of the round][tile column][x-bin]: the weight, or 0
  unsigned char yhit[kRound][kMaxAP];  // the y-bin meets a tile row
  int keep[kAThreads];                  // kept RoIs of the chunk, ascending
  int warp[kAThreads / 32 + 1];         // kept per warp -> prefix; [last]: total
};

// The adaptive grid's scan, as owner_body's: keeps, in sh.keep, the RoIs r
// in [chunk, chunk + kAThreads) of image b at level l whose touched cells
// meet the tile [ty0, ty0 + kTileH) x [tx0, tx0 + kTileW), ascending (a
// ballot per warp, then a prefix over the warps); returns their number. The
// two end samples of each axis bound the touched rows and columns.
// It is a copy of owner_body's scan, and the two must keep the same hit
// test and order. owner_body keeps its own inline copy (and its per-RoI
// sample count, always S there) because the static kernels were tuned as
// they stand: a build that called one shared scan from both moved the
// static f32 kernel's spills (76/128 B to 80/140 B stores/loads) and ran
// it ~1% slower (PERF.md §6).
__device__ __forceinline__ int keep_rois(AdaptiveShared& sh, const float* __restrict__ boxes,
                                         const int* __restrict__ levels, int b, int R, int chunk, int l, float scale,
                                         int H, int W, int ty0, int tx0, int P) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r = chunk + t;
  bool hit = false;
  if (r < R && levels[b * R + r] == l) {
    const float* bx = boxes + 4 * ((size_t)b * R + r);
    const float ylo = bx[1] * scale - 0.5f, yhi = bx[3] * scale - 0.5f;
    const float xlo = bx[0] * scale - 0.5f, xhi = bx[2] * scale - 0.5f;
    const int ny = adaptive_count(ylo, yhi, P), nx = adaptive_count(xlo, xhi, P);
    const int ly = (P - 1) * kLattice + ny - 1, lx = (P - 1) * kLattice + nx - 1;
    const Sample ya = sample_at(ylo, yhi, P, kLattice, ny, 0, H), yb = sample_at(ylo, yhi, P, kLattice, ny, ly, H);
    const Sample xa = sample_at(xlo, xhi, P, kLattice, nx, 0, W), xb = sample_at(xlo, xhi, P, kLattice, nx, lx, W);
    hit = max(ya.hi, yb.hi) >= ty0 && min(ya.lo, yb.lo) < ty0 + kTileH &&
          max(xa.hi, xb.hi) >= tx0 && min(xa.lo, xb.lo) < tx0 + kTileW;
  }
  const unsigned int mask = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) sh.warp[warp] = __popc(mask);
  __syncthreads();
  if (t == 0) {
    int sum = 0;
#pragma unroll 1  // unrolled, its 16 loads spill at the 64 registers of two blocks an SM
    for (int w = 0; w < kAThreads / 32; ++w) {
      const int k = sh.warp[w];
      sh.warp[w] = sum;
      sum += k;
    }
    sh.warp[kAThreads / 32] = sum;
  }
  __syncthreads();
  if (hit) sh.keep[sh.warp[warp] + __popc(mask & ((1u << lane) - 1u))] = r;
  const int n_keep = sh.warp[kAThreads / 32];
  __syncthreads();
  return n_keep;
}

__global__ void __launch_bounds__(kAThreads, 2) roi_align_bwd_adaptive_kernel(
    OwnerLevels lv, const float* __restrict__ boxes, const int* __restrict__ levels,
    const float* __restrict__ cot, int R, int C, int P, bool vec) {
  __shared__ AdaptiveShared sh;
  const int per_image = lv.tile_start[kLevels];
  const int b = blockIdx.x / per_image;
  int tile = blockIdx.x % per_image;
  int l = 0;  // the last level starting at or below the tile (tile_start ascends)
#pragma unroll
  for (int i = 1; i < kLevels; ++i)
    if (tile >= lv.tile_start[i]) l = i;
  tile -= at_level(lv.tile_start, l);
  const int H = at_level(lv.h, l);
  const int W = at_level(lv.w, l);
  const int tiles_x = at_level(lv.tiles_x, l);
  const int ty0 = (tile / tiles_x) * kTileH;
  const int tx0 = (tile % tiles_x) * kTileW;
  const int t = threadIdx.x;
  const int lane = t & 31, col = t >> 5;  // a lane's channels; a warp's tile column
  const int c = (blockIdx.y * kGroups + lane) * kAVec;
  const int n = min(kAVec, C - c);  // this thread's channels; <= 0: none
  const float scale = at_level(lv.inv_stride, l);

  float acc[kTileH][kAVec];
#pragma unroll
  for (int i = 0; i < kTileH; ++i)
#pragma unroll
    for (int v = 0; v < kAVec; ++v) acc[i][v] = 0.0f;

  for (int chunk = 0; chunk < R; chunk += kAThreads) {
    const int n_keep = keep_rois(sh, boxes, levels, b, R, chunk, l, scale, H, W, ty0, tx0, P);
    for (int k0 = 0; k0 < n_keep; k0 += kRound) {
      const int kg = min(kRound, n_keep - k0);
      // the round's tables: one thread per (RoI, axis, bin) sums its bin's
      // walk per cell into the tile's dense arrays (the table's weights,
      // bitwise), zeros included
      if (t < kg * 2 * P) {
        const int k = t / (2 * P), j = t % (2 * P);
        const int axis = j < P ? 0 : 1;  // 0: y, 1: x
        const int bin = j - axis * P;
        const float* bx = boxes + 4 * ((size_t)b * R + sh.keep[k0 + k]);
        const float xlo = bx[0] * scale - 0.5f, xhi = bx[2] * scale - 0.5f;
        const int n_x = adaptive_count(xlo, xhi, P);
        if (axis == 0) {
          const float ylo = bx[1] * scale - 0.5f, yhi = bx[3] * scale - 0.5f;
          const int n_y = adaptive_count(ylo, yhi, P);
          float* w = sh.wy[k][bin];
#pragma unroll
          for (int r = 0; r < kTileH; ++r) w[r] = 0.0f;
          axis_walk(ylo, yhi, P, n_y, bin, H, [&](int cell, float wt) {
            const unsigned r = (unsigned)(cell - ty0);
            if (r < kTileH) w[r] += wt;
          });
          // one division, not one a row: each may call the division's slow
          // path, and the call spills at 64 registers
          const float inv = 1.0f / (float)(n_y * n_x);
          bool hit = false;
#pragma unroll
          for (int r = 0; r < kTileH; ++r) {
            hit = hit || w[r] != 0.0f;
            w[r] = w[r] * inv;
          }
          sh.yhit[k][bin] = hit;
        } else {
#pragma unroll
          for (int x = 0; x < kTileW; ++x) sh.wx[k][x][bin] = 0.0f;
          axis_walk(xlo, xhi, P, n_x, bin, W, [&](int cell, float wt) {
            const unsigned x = (unsigned)(cell - tx0);
            if (x < kTileW) sh.wx[k][x][bin] += wt;
          });
        }
      }
      __syncthreads();
      for (int k = 0; k < kg; ++k) {  // the round's RoIs, in index order
        // the x-bins that meet this warp's column, the y-bins that meet the tile's rows
        const unsigned int xm = __ballot_sync(0xffffffffu, lane < P && sh.wx[k][col][lane] != 0.0f);
        const unsigned int ym = __ballot_sync(0xffffffffu, lane < P && sh.yhit[k][lane]);
        if (xm == 0 || n <= 0) continue;
        const float* g = cot + ((size_t)b * R + sh.keep[k0 + k]) * P * P * C + c;
        for (unsigned int my = ym; my; my &= my - 1) {
          const int by = __ffs(my) - 1;
          // d(x-interp) of y-bin by at this column, then its d(y-interp) per row
          float dt[kAVec];
#pragma unroll
          for (int v = 0; v < kAVec; ++v) dt[v] = 0.0f;
          for (unsigned int mx = xm; mx; mx &= mx - 1) {
            const int bx = __ffs(mx) - 1;
            float cv[kAVec];
            load_f32<kAVec>(g + (size_t)(by * P + bx) * C, n, vec, cv);
            const float wx = sh.wx[k][col][bx];
#pragma unroll
            for (int v = 0; v < kAVec; ++v) dt[v] = fmaf(wx, cv[v], dt[v]);
          }
          const float4* wr = reinterpret_cast<const float4*>(sh.wy[k][by]);
#pragma unroll
          for (int q = 0; q < kTileH / 4; ++q) {
            const float4 w4 = wr[q];
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int v = 0; v < kAVec; ++v) acc[4 * q + i][v] = fmaf(w[i], dt[v], acc[4 * q + i][v]);
          }
        }
      }
      __syncthreads();
    }
  }

  // the tile's column, written once
  const int x = tx0 + col;
  if (n <= 0 || x >= W) return;
  float* base = static_cast<float*>(at_level(lv.acc, l));
#pragma unroll
  for (int i = 0; i < kTileH; ++i) {
    const int y = ty0 + i;
    if (y >= H) break;
    float* p = base + (((size_t)b * H + y) * W + x) * C + c;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kAVec / 4; ++q)
        reinterpret_cast<float4*>(p)[q] = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                                                      acc[i][4 * q + 3]);
    } else {
#pragma unroll
      for (int v = 0; v < kAVec; ++v)
        if (v < n) p[v] = acc[i][v];
    }
  }
}

// The tiles of every level: the per-level fields of OwnerLevels; vec: the
// accumulators' 16-byte alignment
OwnerLevels owner_levels(void* const* accs, const int* hw, const float* inv_stride, bool& vec) {
  OwnerLevels lv;
  lv.tile_start[0] = 0;
  for (int i = 0; i < kLevels; ++i) {
    lv.acc[i] = accs[i];
    lv.h[i] = hw[2 * i];
    lv.w[i] = hw[2 * i + 1];
    lv.inv_stride[i] = inv_stride[i];
    vec = vec && ((uintptr_t)accs[i] % 16) == 0;
    lv.tiles_x[i] = (lv.w[i] + kTileW - 1) / kTileW;
    lv.tile_start[i + 1] = lv.tile_start[i] + lv.tiles_x[i] * ((lv.h[i] + kTileH - 1) / kTileH);
  }
  return lv;
}

using OwnerKernel = void (*)(OwnerLevels, const float*, const int*, const float*, int, int, int, int, bool);

// Tiles every (image, level) of the grid, one block per tile and slice of
// kGroups * kVec channels; returns cudaGetLastError() after the launch.
template <class Acc>
int launch_owner(OwnerKernel kernel, void* const* accs, const int* hw, const float* inv_stride,
                 const float* boxes, const int* levels, const float* cot, int n_rois, int rois_per_image,
                 int C, int P, int S, void* stream) {
  if (P < 1 || S < 1 || P * S > Acc::kMaxPS || C < 1 || n_rois <= 0 || rois_per_image <= 0)
    return (int)cudaErrorInvalidValue;
  bool vec = C % Acc::kVec == 0 && ((uintptr_t)cot % 16) == 0;
  const OwnerLevels lv = owner_levels(accs, hw, inv_stride, vec);
  const int smem = (int)sizeof(OwnerShared<Acc>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int batch = n_rois / rois_per_image;
  const int slice = kGroups * Acc::kVec;
  const dim3 grid(batch * lv.tile_start[kLevels], (C + slice - 1) / slice);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(lv, boxes, levels, cot, rois_per_image, C, P, S, vec);
  return (int)cudaGetLastError();
}

// The adaptive grid's tiles, one block per tile and slice of kGroups * kAVec
// channels; returns cudaGetLastError() after the launch.
int launch_adaptive(void* const* accs, const int* hw, const float* inv_stride, const float* boxes,
                    const int* levels, const float* cot, int n_rois, int rois_per_image, int C, int P,
                    void* stream) {
  if (P < 1 || P > kMaxAP || C < 1 || n_rois <= 0 || rois_per_image <= 0) return (int)cudaErrorInvalidValue;
  bool vec = C % kAVec == 0 && ((uintptr_t)cot % 16) == 0;
  const OwnerLevels lv = owner_levels(accs, hw, inv_stride, vec);
  const int batch = n_rois / rois_per_image;
  const int slice = kGroups * kAVec;
  const dim3 grid(batch * lv.tile_start[kLevels], (C + slice - 1) / slice);
  roi_align_bwd_adaptive_kernel<<<grid, kAThreads, 0, (cudaStream_t)stream>>>(lv, boxes, levels, cot,
                                                                              rois_per_image, C, P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// grads: 4 NHWC f32 level accumulators with their (h, w) and 1/stride; the
// kernel writes every cell (no zeroing needed); P * S <= 32, or S == -1 (the
// adaptive grid) with P * 8 <= 56. Returns cudaGetLastError() after the
// launch (0 on success).
int roi_align_bwd(void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1, int h2,
                  int w2, int h3, int w3, float s0, float s1, float s2, float s3,
                  const float* boxes, const int* levels, const float* cot, int n_rois,
                  int rois_per_image, int C, int P, int S, void* stream) {
  void* accs[kLevels] = {g0, g1, g2, g3};
  const int hw[2 * kLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const float inv_stride[kLevels] = {s0, s1, s2, s3};
  if (S == -1)
    return launch_adaptive(accs, hw, inv_stride, boxes, levels, cot, n_rois, rois_per_image, C, P, stream);
  return launch_owner<F32Acc>(roi_align_bwd_kernel, accs, hw, inv_stride, boxes, levels, cot, n_rois,
                              rois_per_image, C, P, S, stream);
}

// bf16 accumulators: grads are 4 NHWC bf16 level accumulators, every cell
// written by the kernel; C even and P * S <= 16. Returns cudaGetLastError()
// after the launch (0 on success).
int roi_align_bwd_bf16(void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1,
                       int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
                       const float* boxes, const int* levels, const float* cot, int n_rois,
                       int rois_per_image, int C, int P, int S, void* stream) {
  if (C & 1) return (int)cudaErrorInvalidValue;
  void* accs[kLevels] = {g0, g1, g2, g3};
  const int hw[2 * kLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const float inv_stride[kLevels] = {s0, s1, s2, s3};
  return launch_owner<Bf16Acc>(roi_align_bwd_bf16_kernel, accs, hw, inv_stride, boxes, levels, cot, n_rois,
                               rois_per_image, C, P, S, stream);
}

}  // extern "C"
