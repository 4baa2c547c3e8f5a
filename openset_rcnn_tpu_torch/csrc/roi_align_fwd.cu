// Multilevel RoIAlignV2 forward (aligned, -0.5 offset) for Hopper (sm_90a).
//
// One source for two TPU kernels:
//   * roi_align_fwd replaces roi_align_pallas_v2
//     (openset_rcnn_tpu/ops/pallas/roi_align_v2.py:269, body _kernel
//     :164-266): bf16 features in, f32 out;
//   * roi_align_window_fwd replaces roi_align_pallas_fwd
//     (openset_rcnn_tpu/ops/pallas/roi_align_kernel.py:177, body _fwd_kernel
//     :123-174): f32 or bf16 features in, the output in the features' type.
// Both compute exact bilinear RoIAlign, what the gather path computes
// (openset_rcnn_tpu/ops/roi_align.py:111-193), from the FPN level given in
// `levels`. That level is computed once in torch, shared with the plain
// version: the gather rule, or the TPU kernels' window-fit rule
// (roi_align_kernel.py:59-64), which is what makes K5 (and K1 on the TPU)
// differ from the gather path. Away from its window DMA, K5 is exactly
// bilinear RoIAlign at the window-fit level: MAX_EXTENT guarantees that every
// sample fits its 56x64 window, so the window changes no value. The TPU-only
// structure (window DMA, SMEM scalar tables, CHUNK=2048) has nothing to port
// here, and a second copy of the same bilinear loop would only drift from
// this one; the two entry points instantiate one templated kernel. K5
// interpolates in the features' type on the TPU; here the arithmetic is f32
// and a bf16 output is rounded once, at the end.
//
// Inputs: P2-P5 as NHWC (B, H_l, W_l, C) of type In; boxes (B*R, 4) f32
// xyxy; levels (B*R,) int32 in [0, 4). Output (B*R, P, P, C) of type Out.
//
// Design: one block per RoI, threads along C. The first 2*P*S threads work
// out the sample geometry of the RoI's y and x axes into shared memory
// (positions, clamps, floor, neighbours, fractions and masks, all f32 in the
// order of the gather path); then each thread walks the P*P bins x S*S
// samples for its channel. Each bilinear neighbour read is one coalesced row
// of C values across the block, and each output row of C values is written
// once.
//
// Bound on the H100: bytes. The output (B*R*P*P*C values, ~1.7 GB in f32 at
// the serving shapes) dominates the feature reads (~0.38 GB in bf16); the
// arithmetic (~40 flops per output value) is far below the f32 rate. This
// first version makes no attempt at the neighbour reuse between samples or at
// TMA staging; it is the simple kernel that is right.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kMaxSamples = 32;  // out_size * sampling_ratio per axis

template <typename In>
struct Levels {
  const In* feat[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename In, typename Out>
__global__ void roi_align_fwd_kernel(Levels<In> lv, const float* __restrict__ boxes,
                                     const int* __restrict__ levels, int R, int C, int P,
                                     int S, Out* __restrict__ out) {
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

  if (t < 2 * PS) {
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

  const In* f = lv.feat[l] + (size_t)b * H * W * C;
  Out* o = out + (size_t)roi * P * P * C;
  const float inv_count = 1.0f / (float)(S * S);
  for (int c = t; c < C; c += blockDim.x) {
    for (int py = 0; py < P; ++py) {
      for (int px = 0; px < P; ++px) {
        float acc = 0.0f;
        for (int sy = 0; sy < S; ++sy) {
          const int iy = py * S + sy;
          const int y0 = s_lo[0][iy], y1 = s_hi[0][iy];
          const float ly = s_frac[0][iy];
          for (int sx = 0; sx < S; ++sx) {
            const int ix = px * S + sx;
            const int x0 = s_lo[1][ix], x1 = s_hi[1][ix];
            const float lx = s_frac[1][ix];
            const float g00 = to_f32(f[((size_t)y0 * W + x0) * C + c]);
            const float g01 = to_f32(f[((size_t)y0 * W + x1) * C + c]);
            const float g10 = to_f32(f[((size_t)y1 * W + x0) * C + c]);
            const float g11 = to_f32(f[((size_t)y1 * W + x1) * C + c]);
            const float w00 = (1.0f - ly) * (1.0f - lx);
            const float w01 = (1.0f - ly) * lx;
            const float w10 = ly * (1.0f - lx);
            const float w11 = ly * lx;
            const float val = g00 * w00 + g01 * w01 + g10 * w10 + g11 * w11;
            acc += val * (s_ok[0][iy] * s_ok[1][ix]);
          }
        }
        store(o + ((size_t)py * P + px) * C + c, acc * inv_count);
      }
    }
  }
}

template <typename In, typename Out>
int launch(const void* f0, const void* f1, const void* f2, const void* f3, int h0, int w0, int h1,
           int w1, int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
           const float* boxes, const int* levels, int n_rois, int rois_per_image, int C, int P,
           int S, void* out, void* stream) {
  if (P * S > kMaxSamples || n_rois <= 0) return (int)cudaErrorInvalidValue;
  Levels<In> lv;
  lv.feat[0] = (const In*)f0;
  lv.feat[1] = (const In*)f1;
  lv.feat[2] = (const In*)f2;
  lv.feat[3] = (const In*)f3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.inv_stride[0] = s0; lv.inv_stride[1] = s1; lv.inv_stride[2] = s2; lv.inv_stride[3] = s3;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 2 * P * S) threads = ((2 * P * S + 31) / 32) * 32;
  roi_align_fwd_kernel<In, Out><<<n_rois, threads, 0, (cudaStream_t)stream>>>(
      lv, boxes, levels, rois_per_image, C, P, S, (Out*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1: feats are 4 NHWC bf16 level pointers with their (h, w) and 1/stride;
// the output is f32. Returns cudaGetLastError() after the launch (0 on
// success).
int roi_align_fwd(const void* f0, const void* f1, const void* f2, const void* f3, int h0,
                  int w0, int h1, int w1, int h2, int w2, int h3, int w3, float s0, float s1,
                  float s2, float s3, const float* boxes, const int* levels, int n_rois,
                  int rois_per_image, int C, int P, int S, float* out, void* stream) {
  return launch<__nv_bfloat16, float>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, s0, s1, s2,
                                      s3, boxes, levels, n_rois, rois_per_image, C, P, S, out,
                                      stream);
}

// K5: as roi_align_fwd, but features and output are both f32 (bf16 == 0) or
// both bf16 (bf16 == 1).
int roi_align_window_fwd(const void* f0, const void* f1, const void* f2, const void* f3, int h0,
                         int w0, int h1, int w1, int h2, int w2, int h3, int w3, float s0,
                         float s1, float s2, float s3, const float* boxes, const int* levels,
                         int n_rois, int rois_per_image, int C, int P, int S, int bf16, void* out,
                         void* stream) {
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3,
                                                s0, s1, s2, s3, boxes, levels, n_rois,
                                                rois_per_image, C, P, S, out, stream);
  return launch<float, float>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, s0, s1, s2, s3,
                              boxes, levels, n_rois, rois_per_image, C, P, S, out, stream);
}

}  // extern "C"
