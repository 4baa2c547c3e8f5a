// Multilevel RoIAlignV2 backward (aligned, -0.5 offset) for Hopper (sm_90a):
// d(features) from d(pooled).
//
// Replaces the TPU kernel roi_align_pallas_v2_bwd
// (openset_rcnn_tpu/ops/pallas/roi_align_v2.py:487, body _bwd_kernel
// :339-484), the backward of the custom VJP at
// openset_rcnn_tpu/ops/roi_align.py:402-437. It is the transpose of
// csrc/roi_align_fwd.cu: the exact gather path with the FPN level given in
// `levels`, no window classes and no level bump. Boxes get no gradient.
//
// Inputs: the cotangent (B*R, P, P, C) f32; boxes (B*R, 4) f32 xyxy; levels
// (B*R,) int32 in [0, 4). Output: four per-level f32 accumulators
// (B, H_l, W_l, C), zeroed by the caller; the caller rounds them to the
// features' dtype.
//
// Design: one block per RoI, threads along C, the sample geometry of the
// RoI's y and x axes in shared memory exactly as the forward kernel computes
// it. For each bin and sample, each of the 4 bilinear neighbours gets
// (cotangent / count) * in_range * weight through an f32 atomicAdd; a warp
// adds to 32 neighbouring channels of one cell, one coalesced 128-byte
// atomic per warp. The TPU kernel is race-free only because its grid runs in
// order; here RoIs of one image overlap and run in parallel, so the adds are
// atomic and their order, and so the f32 rounding of each cell's sum,
// changes from run to run (a tolerance, not bitwise equality, against the
// plain version). Samples outside the map (in_range 0) add nothing and are
// skipped.
//
// Bound on the H100: bytes. The cotangent read (B*R*P*P*C*4, ~103 MB at
// B=4, R=512, C=256) and the accumulators written (~380 MB for P2-P5 of an
// 832x1344 batch of 4); the ~4*S*S adds per cotangent value are far below
// the f32 rate. This first version makes no attempt to merge the adds of
// neighbouring samples that hit one cell before they reach memory.
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

}  // extern "C"
