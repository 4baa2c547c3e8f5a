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
// (B, H_l, W_l, C), zeroed by the caller, who rounds them to the features'
// type.
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
// outside the map (in_range 0) add nothing and are skipped.
//
// roi_align_bwd_bf16, bf16 accumulators (TPU.ROI_ALIGN_BWD pallas_bf16): the
// TPU kernel sums each RoI's window gradient in f32 and adds it to the bf16
// accumulator window in one read-add-write (roi_align_v2.py:444-451), so
// every (RoI, cell, channel) contribution is rounded to bf16 once. Here one
// block takes one RoI and a slice of 16 channels. Sample positions along an
// axis are monotone, so the RoI touches at most 2*P*S distinct rows and
// columns (28 at P=7, S=2); the block compacts them (a sample's upper
// neighbour is often the next one's lower) and keeps the window gradient
// over those rows x columns in shared memory, f32, at most 28*28*16*4 =
// 50 KB. It runs the TPU kernel's separable transpose in the TPU kernel's
// order, d(x-interp) then d(y-interp), samples sub-sample-major, so the f32
// window sums are the TPU kernel's, operation for operation. Then one CAS per
// touched cell and channel pair adds the pair to the bf16x2 word in f32 and
// rounds once: the TPU kernel's semantics. (A native bf16x2 atomicAdd would
// round the f32 sum to bf16 before the add as well: a second rounding.)
// RoIs of one image run in parallel, so the order of the roundings at a cell
// differs from the TPU grid's and from the plain version's, and the card
// compares by tolerance.
//
// Bound on the H100: bytes. The cotangent read (B*R*P*P*C*4, ~103 MB at
// B=4, R=512, C=256) and the accumulators written (~380 MB of f32, ~190 MB
// of bf16, for P2-P5 of an 832x1344 batch of 4); the ~4*S*S adds per
// cotangent value are far below the f32 rate. The f32 kernel makes no
// attempt to merge the adds of neighbouring samples that hit one cell before
// they reach memory; the bf16 kernel merges them in shared memory, and
// waits on each CAS.
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


constexpr int kSlice = 16;             // channels per block of the bf16 kernel
constexpr int kMaxPS = 16;             // its out_size * sampling_ratio
constexpr int kMaxIdx = 2 * kMaxPS;    // distinct neighbour indices per axis

struct LevelsBf16 {
  __nv_bfloat16* acc[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
};

// acc = bf16(f32(acc) + v) on both halves of a bf16x2 word, one rounding each.
__device__ __forceinline__ void add_bf16x2(__nv_bfloat162* p, float v0, float v1) {
  unsigned int* word = reinterpret_cast<unsigned int*>(p);
  unsigned int old = __ldcg(word);
  while (true) {
    __nv_bfloat162 cur = *reinterpret_cast<__nv_bfloat162*>(&old);
    __nv_bfloat162 sum = __floats2bfloat162_rn(__low2float(cur) + v0, __high2float(cur) + v1);
    const unsigned int want = *reinterpret_cast<unsigned int*>(&sum);
    const unsigned int seen = atomicCAS(word, old, want);
    if (seen == old) return;
    old = seen;
  }
}

__global__ void roi_align_bwd_bf16_kernel(LevelsBf16 lv, const float* __restrict__ boxes,
                                          const int* __restrict__ levels,
                                          const float* __restrict__ cot, int R, int C, int P,
                                          int S) {
  extern __shared__ float s_dyn[];       // window [ny][nx][kSlice], then cotangent [P*P][kSlice]
  __shared__ int s_lo[2][kMaxPS];        // [axis][sample], samples bin-major as the forward's
  __shared__ int s_hi[2][kMaxPS];
  __shared__ float s_frac[2][kMaxPS];
  __shared__ float s_ok[2][kMaxPS];
  __shared__ int s_cand[2][kMaxIdx];     // candidate 2i: sample i's lower neighbour, 2i+1: upper
  __shared__ int s_first[2][kMaxIdx];    // 1 if no earlier candidate has the same index
  __shared__ int s_slot[2][kMaxIdx];     // candidate -> compact slot (rank among distinct)
  __shared__ int s_val[2][kMaxIdx];      // slot -> row / column
  __shared__ int s_n[2];                 // distinct rows, columns
  __shared__ int s_xstart[kMaxIdx + 1];  // column slot -> its (sample, weight) entries, CSR
  __shared__ int s_xq[kMaxIdx];          // entry: x sample
  __shared__ float s_xw[kMaxIdx];        // entry: its weight

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * kSlice;
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
  const int n_cand = 2 * PS;
  const int axis = t / n_cand, k = t % n_cand;  // one candidate per thread, both axes
  if (t < 2 * n_cand) s_cand[axis][k] = (k & 1) ? s_hi[axis][k >> 1] : s_lo[axis][k >> 1];
  __syncthreads();
  if (t < 2 * n_cand) {
    int first = 1;
    for (int j = 0; j < k; ++j) first &= s_cand[axis][j] != s_cand[axis][k];
    s_first[axis][k] = first;
  }
  __syncthreads();
  if (t < 2 * n_cand) {
    int slot = 0, n = 0;
    for (int j = 0; j < n_cand; ++j) {
      slot += s_first[axis][j] && s_cand[axis][j] < s_cand[axis][k];
      n += s_first[axis][j];
    }
    s_slot[axis][k] = slot;
    if (s_first[axis][k]) s_val[axis][slot] = s_cand[axis][k];
    if (k == 0) s_n[axis] = n;
  }
  __syncthreads();
  const int ny = s_n[0], nx = s_n[1];
  if (t == 0) {  // each column slot's x-interpolation entries, in the TPU kernel's sample order
    for (int j = 0; j <= nx; ++j) s_xstart[j] = 0;
    for (int k2 = 0; k2 < n_cand; ++k2) s_xstart[s_slot[1][k2] + 1] += 1;
    for (int j = 0; j < nx; ++j) s_xstart[j + 1] += s_xstart[j];
    int fill[kMaxIdx];
    for (int j = 0; j < nx; ++j) fill[j] = s_xstart[j];
    for (int a = 0; a < S; ++a) {
      for (int qb = 0; qb < P; ++qb) {
        const int q = qb * S + a;
        const float lx = s_frac[1][q], ok = s_ok[1][q];
        const int e0 = fill[s_slot[1][2 * q]]++;
        s_xq[e0] = q;
        s_xw[e0] = (1.0f - lx) * ok;
        const int e1 = fill[s_slot[1][2 * q + 1]]++;
        s_xq[e1] = q;
        s_xw[e1] = lx * ok;
      }
    }
  }
  float* s_win = s_dyn;
  float* s_cot = s_dyn + (size_t)ny * nx * kSlice;
  const float inv_count = 1.0f / (float)(S * S);  // d(mean), as the TPU kernel scales the cotangent
  const float* g = cot + (size_t)roi * P * P * C;
  for (int i = t; i < P * P * kSlice; i += blockDim.x) {
    const int c = c0 + i % kSlice;
    s_cot[i] = c < C ? g[(size_t)(i / kSlice) * C + c] * inv_count : 0.0f;
  }
  for (int i = t; i < ny * nx * kSlice; i += blockDim.x) s_win[i] = 0.0f;
  __syncthreads();

  // d(x-interp) then d(y-interp): thread (column slot xs, channel cc) owns
  // window column xs of channel cc, so no two threads add to one value.
  for (int task = t; task < nx * kSlice; task += blockDim.x) {
    const int xs = task / kSlice, cc = task % kSlice;
    for (int a = 0; a < S; ++a) {
      for (int pb = 0; pb < P; ++pb) {
        const int p = pb * S + a;
        float dt1 = 0.0f;
        for (int e = s_xstart[xs]; e < s_xstart[xs + 1]; ++e)
          dt1 = dt1 + s_cot[(pb * P + s_xq[e] / S) * kSlice + cc] * s_xw[e];
        const float ly = s_frac[0][p], ok = s_ok[0][p];
        float* w0 = s_win + ((size_t)s_slot[0][2 * p] * nx + xs) * kSlice + cc;
        *w0 = *w0 + dt1 * ((1.0f - ly) * ok);
        float* w1 = s_win + ((size_t)s_slot[0][2 * p + 1] * nx + xs) * kSlice + cc;
        *w1 = *w1 + dt1 * (ly * ok);
      }
    }
  }
  __syncthreads();

  // one read-add-round per touched cell and channel pair
  __nv_bfloat16* acc = lv.acc[l] + (size_t)b * H * W * C;
  constexpr int kPairs = kSlice / 2;
  for (int i = t; i < ny * nx * kPairs; i += blockDim.x) {
    const int cell = i / kPairs, pair = i % kPairs;
    const int c = c0 + 2 * pair;
    if (c >= C) continue;
    const float v0 = s_win[(size_t)cell * kSlice + 2 * pair];
    const float v1 = s_win[(size_t)cell * kSlice + 2 * pair + 1];
    if (v0 == 0.0f && v1 == 0.0f) continue;  // bf16(acc + 0) == acc
    const int row = s_val[0][cell / nx], col = s_val[1][cell % nx];
    add_bf16x2(reinterpret_cast<__nv_bfloat162*>(acc + ((size_t)row * W + col) * C + c), v0, v1);
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

// bf16 accumulators: grads are 4 NHWC bf16 level accumulators; C even and
// P * S <= 16. Returns cudaGetLastError() after the launch (0 on success).
int roi_align_bwd_bf16(void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1,
                       int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
                       const float* boxes, const int* levels, const float* cot, int n_rois,
                       int rois_per_image, int C, int P, int S, void* stream) {
  if (P * S > kMaxPS || (C & 1) || n_rois <= 0) return (int)cudaErrorInvalidValue;
  LevelsBf16 lv;
  lv.acc[0] = (__nv_bfloat16*)g0;
  lv.acc[1] = (__nv_bfloat16*)g1;
  lv.acc[2] = (__nv_bfloat16*)g2;
  lv.acc[3] = (__nv_bfloat16*)g3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.inv_stride[0] = s0; lv.inv_stride[1] = s1; lv.inv_stride[2] = s2; lv.inv_stride[3] = s3;
  const int n_idx = 2 * P * S;
  const size_t smem = ((size_t)n_idx * n_idx + (size_t)P * P) * kSlice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_rois, (C + kSlice - 1) / kSlice);
  roi_align_bwd_bf16_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      lv, boxes, levels, cot, rois_per_image, C, P, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
