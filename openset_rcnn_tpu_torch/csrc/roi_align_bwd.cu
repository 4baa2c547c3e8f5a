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
// roi_align_bwd, f32 accumulators (TPU.ROI_ALIGN_BWD pallas): one block per
// RoI, threads along C, the sample geometry of the RoI's y and x axes in
// shared memory exactly as the forward kernel computes it. For each bin and
// sample, each of the 4 bilinear neighbours gets (cotangent / count) *
// in_range * weight through an f32 atomicAdd; a warp adds to 32 neighbouring
// channels of one cell, one coalesced 128-byte atomic per warp. The TPU
// kernel is race-free only because its grid runs in order; here RoIs of one
// image overlap and run in parallel, so the adds are atomic and their order,
// and so the f32 rounding of each cell's sum, changes from run to run (a
// tolerance, not bitwise equality, against the plain version). Samples
// outside the map (in_range 0) add nothing and are skipped. Bound: bytes,
// the cotangent read and the f32 accumulators written.
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
constexpr int kMaxSamples = 32;  // out_size * sampling_ratio per axis

struct Levels {
  float* grad[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
};

__global__ void roi_align_bwd_kernel(Levels lv, const float* __restrict__ boxes,
                                     const int* __restrict__ levels,
                                     const float* __restrict__ cot, int R, int C, int P, int S) {
  __shared__ int s_lo[2][kMaxSamples];  // [axis][sample]: floor neighbour
  __shared__ int s_hi[2][kMaxSamples];  // min(floor + 1, extent - 1)
  __shared__ float s_frac[2][kMaxSamples];
  __shared__ float s_ok[2][kMaxSamples];  // 1 inside (-1, extent), else 0

  const int roi = blockIdx.x;
  const int b = roi / R;
  const int l = levels[roi];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int PS = P * S;
  const int t = threadIdx.x;

  if (t < 2 * PS) {  // the forward kernel's geometry, operation for operation
    const int axis = t < PS ? 0 : 1;  // 0: y, 1: x
    const int idx = t - axis * PS;
    const float scale = lv.inv_stride[l];
    const float* bx = boxes + 4 * (size_t)roi;
    const float lo = (axis == 0 ? bx[1] : bx[0]) * scale - 0.5f;
    const float hi = (axis == 0 ? bx[3] : bx[2]) * scale - 0.5f;
    const float bin = (hi - lo) / (float)P;
    const float in_bins = (float)(idx / S) + ((float)(idx % S) + 0.5f) / (float)S;
    float v = lo + in_bins * bin;
    const float ext = (float)(axis == 0 ? H : W);
    s_ok[axis][idx] = (v > -1.0f && v < ext) ? 1.0f : 0.0f;
    v = fminf(fmaxf(v, 0.0f), ext - 1.0f);
    const float v0 = floorf(v);
    const float v1 = fminf(v0 + 1.0f, ext - 1.0f);
    s_lo[axis][idx] = (int)v0;
    s_hi[axis][idx] = (int)v1;
    s_frac[axis][idx] = v - v0;
  }
  __syncthreads();

  float* acc = lv.grad[l] + (size_t)b * H * W * C;
  const float* g = cot + (size_t)roi * P * P * C;
  const float count = (float)(S * S);
  for (int c = t; c < C; c += blockDim.x) {
    for (int py = 0; py < P; ++py) {
      for (int px = 0; px < P; ++px) {
        const float gv = g[((size_t)py * P + px) * C + c] / count;  // d(mean)
        for (int sy = 0; sy < S; ++sy) {
          const int iy = py * S + sy;
          const int y0 = s_lo[0][iy], y1 = s_hi[0][iy];
          const float ly = s_frac[0][iy];
          for (int sx = 0; sx < S; ++sx) {
            const int ix = px * S + sx;
            const float d = gv * (s_ok[0][iy] * s_ok[1][ix]);  // d(val * ok)
            if (d == 0.0f) continue;
            const int x0 = s_lo[1][ix], x1 = s_hi[1][ix];
            const float lx = s_frac[1][ix];
            const float w00 = (1.0f - ly) * (1.0f - lx);
            const float w01 = (1.0f - ly) * lx;
            const float w10 = ly * (1.0f - lx);
            const float w11 = ly * lx;
            atomicAdd(acc + ((size_t)y0 * W + x0) * C + c, d * w00);
            atomicAdd(acc + ((size_t)y0 * W + x1) * C + c, d * w01);
            atomicAdd(acc + ((size_t)y1 * W + x0) * C + c, d * w10);
            atomicAdd(acc + ((size_t)y1 * W + x1) * C + c, d * w11);
          }
        }
      }
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
        int m = 0;
        for (int a = 0; a < S; ++a) {
          for (int pb = 0; pb < P; ++pb) {
            const int p = pb * S + a;
            const float fr = s_frac[k][axis][p], ok = s_ok[k][axis][p];
            if (s_lo[k][axis][p] == cell) {
              s_bin[k][j][m] = (unsigned char)pb;
              s_wt[k][j][m] = (1.0f - fr) * ok;
              ++m;
            }
            if (s_hi[k][axis][p] == cell) {
              s_bin[k][j][m] = (unsigned char)pb;
              s_wt[k][j][m] = fr * ok;
              ++m;
            }
          }
        }
        s_n[k][j] = m;
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

// grads: 4 NHWC f32 level accumulators with their (h, w) and 1/stride.
// Returns cudaGetLastError() after the launch (0 on success).
int roi_align_bwd(void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1, int h2,
                  int w2, int h3, int w3, float s0, float s1, float s2, float s3,
                  const float* boxes, const int* levels, const float* cot, int n_rois,
                  int rois_per_image, int C, int P, int S, void* stream) {
  if (P * S > kMaxSamples || n_rois <= 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.grad[0] = (float*)g0;
  lv.grad[1] = (float*)g1;
  lv.grad[2] = (float*)g2;
  lv.grad[3] = (float*)g3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.inv_stride[0] = s0; lv.inv_stride[1] = s1; lv.inv_stride[2] = s2; lv.inv_stride[3] = s3;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 2 * P * S) threads = ((2 * P * S + 31) / 32) * 32;
  roi_align_bwd_kernel<<<n_rois, threads, 0, (cudaStream_t)stream>>>(
      lv, boxes, levels, cot, rois_per_image, C, P, S);
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
