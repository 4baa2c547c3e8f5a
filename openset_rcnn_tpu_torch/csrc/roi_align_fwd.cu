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
// here; the two entry points instantiate one templated kernel. K5
// interpolates in the features' type on the TPU; here the arithmetic is f32
// and a bf16 output is rounded once, at the end.
//
// Inputs: P2-P5 as NHWC (B, H_l, W_l, C) of type In; boxes (B*R, 4) f32
// xyxy; levels (B*R,) int32 in [0, 4). Output (B*R, P, P, C) of type Out.
//
// Bound on the H100: bytes. The output (B*R*P*P*C values, 1.715 GB in f32
// at the serving shapes B=8, R=4273, C=256) dominates the feature reads
// (0.381 GB in bf16): 0.626 ms at 3.35 TB/s. The arithmetic (~33 flops per
// output value) is far below the f32 rate.
//
// Design (the times of this design and of the variants tried are in
// PERF.md):
//   * A block takes one RoI. Thread (g, w): channel group g of V channels
//     (V = 8 for bf16, 4 for f32: one 16-byte load, so a warp reads 16 bytes
//     per lane instead of 2), worker w. One warp covers a 256-channel bf16
//     cell in four full 128-byte lines; with more groups than a block has
//     threads (512), a thread loops over its groups. A worker takes one bin
//     at a time (P workers of P bins each where the channels allow), so its
//     accumulator is V registers.
//   * P and S are template parameters for the config's (7, 2), so the
//     sample loops unroll and the compiler issues a bin's S*S*4 independent
//     16-byte neighbour loads ahead of their arithmetic. One loop serves
//     both instantiations: the generic one (runtime P and S) serves every
//     other P*S <= 32 and is slower at (7, 2) (PERF.md).
//   * Neighbour reuse through L1. The P workers of a block run neighbouring
//     bins of one RoI at the same time, so a cell that several samples share
//     is read from device memory once and from L1 after. Staging the RoI's
//     distinct rows x columns in shared memory does not fit (up to 28 x 28
//     cells x 512 B); a channel slice at a time would repeat the geometry
//     per slice. Keeping the last sample's columns in registers makes every
//     load wait on a select chain and spills.
//   * Stores are 16-byte vectors (float4 for an f32 output).
//   * C not a multiple of V, or an unaligned pointer, takes masked scalar
//     loads and stores in the same kernel.
//   * The arithmetic and its order are the first version's, sample for
//     sample: val = g00*w00 + g01*w01 + g10*w10 + g11*w11, acc += val * ok
//     over (sy, sx), then acc * (1 / (S*S)); with --fmad=false the result is
//     bitwise the plain version's.
//
// The adaptive grid (S == -1, TPU.ROI_SAMPLING_RATIO -1; K1 only) has its
// own kernel, roi_align_fwd_adaptive_kernel, on the per-bin axis tables of
// csrc/roi_align_adaptive.cuh. A bin takes 1 to 64 samples there (n_y x
// n_x, n = clip(ceil(bin extent), 1, 8) per axis), and a sample's 4
// neighbour loads and FMA chain each would wait on the sample's shared
// geometry in a loop that cannot unroll. Instead:
//   * The block's threads first build the RoI's 2 x P tables in shared
//     memory: per axis and bin the distinct (cell, weight) pairs, at most
//     16 (the header proves the bound), the y-weights divided by the RoI's
//     n_y * n_x.
//   * A worker then computes its bin as a separable pass: per y-pair
//     t = sum over the x-pairs of wx * f[row, cx], 16-byte loads in chunks
//     of 2 under a compile-time bound of 16 with predication, so a chunk's
//     loads issue ahead of its arithmetic; then acc += wy * t. A bin costs
//     k_y * k_x loads and FMA chains (9 at n_y = n_x = 2, whose 4 samples
//     take 16 neighbour loads one by one), and no geometry is read per
//     sample.
//   * P = 7 (every config's POOLER_RESOLUTION) is a compile-time
//     instantiation; another P runs the same code with a runtime P.
//   * The 16-byte loads and stores, the masked tail and the channel-group
//     loop are the static kernel's.
// The sums are reassociated (merged weights, FMAs, the count folded into the
// y-weights), so the result is no longer bitwise the plain version's: it is
// held to atol 2e-5 + rtol 1e-5 of it. The bytes, and so the bound, are the
// static grid's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "roi_align_adaptive.cuh"

namespace {

constexpr int kLevels = 4;
constexpr int kMaxSamples = 32;  // out_size * sampling_ratio per axis
constexpr int kMaxAdaptiveP = 7;  // the adaptive grid's out_size at most (out_size * kLattice <= 56)
constexpr int kMaxThreads = 512;

template <typename In>
struct Levels {
  const In* feat[kLevels];
  int h[kLevels];
  int w[kLevels];
  float inv_stride[kLevels];
};

// V channels of one cell as one 16-byte vector
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
};

__device__ __forceinline__ float elem(const uint4& r, int v) {
  const unsigned int w = (&r.x)[v >> 1];
  return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));  // bf16 -> f32, exact
}
__device__ __forceinline__ float elem(const float4& r, int v) { return (&r.x)[v]; }

// n valid channels from p: one 16-byte load when vec (n == N, aligned),
// else masked scalar loads, zero beyond n
__device__ __forceinline__ uint4 load_raw(const __nv_bfloat16* p, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned int lo = 2 * i < n ? s[2 * i] : 0u;
    const unsigned int hi = 2 * i + 1 < n ? s[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ float4 load_raw(const float* p, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(0 < n ? p[0] : 0.f, 1 < n ? p[1] : 0.f, 2 < n ? p[2] : 0.f, 3 < n ? p[3] : 0.f);
}

template <int N>
__device__ __forceinline__ void store_vals(float* p, const float* v, int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = v[i];
  }
}
template <int N>
__device__ __forceinline__ void store_vals(__nv_bfloat16* p, const float* v, int n, bool vec) {
  if (vec) {
    unsigned int w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<unsigned int*>(&h);
    }
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) q[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// acc += one sample's bilinear value * in_range, per channel, in the plain
// version's order of operations
template <int N, typename Raw>
__device__ __forceinline__ void add_sample(float* acc, const Raw& g00, const Raw& g01, const Raw& g10,
                                           const Raw& g11, float ly, float lx, float ok) {
  const float w00 = (1.0f - ly) * (1.0f - lx);
  const float w01 = (1.0f - ly) * lx;
  const float w10 = ly * (1.0f - lx);
  const float w11 = ly * lx;
#pragma unroll
  for (int v = 0; v < N; ++v) {
    const float val = elem(g00, v) * w00 + elem(g01, v) * w01 + elem(g10, v) * w10 + elem(g11, v) * w11;
    acc[v] += val * ok;
  }
}

// kP, kS > 0: compile-time grid (the config's (7, 2)), the sample loops
// unrolled; kP == kS == 0: the generic instantiation, runtime (P, S).
template <typename In, typename Out, int kP, int kS>
__global__ void __launch_bounds__(kMaxThreads) roi_align_fwd_kernel(
    Levels<In> lv, const float* __restrict__ boxes, const int* __restrict__ levels, int R, int C,
    int P_rt, int S_rt, int groups, int n_groups, bool vec, Out* __restrict__ out) {
  constexpr int N = Vec<In>::N;
  __shared__ int s_lo[2][kMaxSamples];  // [axis][sample]: floor neighbour
  __shared__ int s_hi[2][kMaxSamples];  // min(floor + 1, extent - 1)
  __shared__ float s_frac[2][kMaxSamples];
  __shared__ float s_ok[2][kMaxSamples];  // 1 inside (-1, extent), else 0

  const int P = kP > 0 ? kP : P_rt;
  const int S = kS > 0 ? kS : S_rt;
  const int roi = blockIdx.x;
  const int b = roi / R;
  const int l = levels[roi];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int PS = P * S;
  const int t = threadIdx.x;

  for (int i = t; i < 2 * PS; i += blockDim.x) {
    const int axis = i < PS ? 0 : 1;  // 0: y, 1: x
    const int idx = i - axis * PS;
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

  const int workers = blockDim.x / groups;
  const float inv_count = 1.0f / (float)(S * S);
  // a thread's channel groups (one unless C > groups * N), then its bins: one
  // bin per worker at a time, all channels of the group
  for (int g = t % groups; g < n_groups; g += groups)
  for (int bin = t / groups; bin < P * P; bin += workers) {
    const int c = g * N;
    const int n = min(N, C - c);
    const In* f = lv.feat[l] + (size_t)b * H * W * C + c;
    Out* o = out + (size_t)roi * P * P * C + c;
    const int py = bin / P, px = bin % P;
    float acc[N];
#pragma unroll
    for (int v = 0; v < N; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int sy = 0; sy < S; ++sy) {
      const int iy = py * S + sy;
      const In* r0 = f + (size_t)s_lo[0][iy] * W * C;
      const In* r1 = f + (size_t)s_hi[0][iy] * W * C;
#pragma unroll
      for (int sx = 0; sx < S; ++sx) {
        const int ix = px * S + sx;
        const size_t x0 = (size_t)s_lo[1][ix] * C, x1 = (size_t)s_hi[1][ix] * C;
        add_sample<N>(acc, load_raw(r0 + x0, n, vec), load_raw(r0 + x1, n, vec), load_raw(r1 + x0, n, vec),
                      load_raw(r1 + x1, n, vec), s_frac[0][iy], s_frac[1][ix], s_ok[0][iy] * s_ok[1][ix]);
      }
    }
    float res[N];
#pragma unroll
    for (int v = 0; v < N; ++v) res[v] = acc[v] * inv_count;
    store_vals<N>(o + (size_t)bin * C, res, n, vec);
  }
}

// The adaptive grid (K1's S == -1), on the RoI's axis tables; kP == 7 or 0
// (runtime P <= kMaxAdaptiveP). Threads as in roi_align_fwd_kernel.
template <int kP>
__global__ void __launch_bounds__(kMaxThreads) roi_align_fwd_adaptive_kernel(
    Levels<__nv_bfloat16> lv, const float* __restrict__ boxes, const int* __restrict__ levels, int R, int C,
    int P_rt, int groups, int n_groups, bool vec, float* __restrict__ out) {
  using In = __nv_bfloat16;
  using Raw = Vec<In>::Raw;
  constexpr int N = Vec<In>::N;
  constexpr int kChunk = 2;  // x-pairs whose loads issue together (4 spill in the 64 registers ptxas picks)
  // [axis][bin][pair]: y: the row's offset cell * W, x: the column; the
  // weight (y: divided by n_y * n_x); [axis][bin]: the pairs
  __shared__ int s_cell[2][kMaxAdaptiveP][kMaxPairs];
  __shared__ float s_w[2][kMaxAdaptiveP][kMaxPairs];
  __shared__ int s_k[2][kMaxAdaptiveP];

  const int P = kP > 0 ? kP : P_rt;
  const int roi = blockIdx.x;
  const int b = roi / R;
  const int l = levels[roi];
  const int H = at_level(lv.h, l);
  const int W = at_level(lv.w, l);
  const int t = threadIdx.x;

  for (int i = t; i < 2 * P; i += blockDim.x) {  // one thread per table
    const int axis = i < P ? 0 : 1;  // 0: y, 1: x
    const int bin = i - axis * P;
    const float scale = at_level(lv.inv_stride, l);
    const float* bx = boxes + 4 * (size_t)roi;
    const float ylo = bx[1] * scale - 0.5f, yhi = bx[3] * scale - 0.5f;
    const float xlo = bx[0] * scale - 0.5f, xhi = bx[2] * scale - 0.5f;
    const int n_y = adaptive_count(ylo, yhi, P), n_x = adaptive_count(xlo, xhi, P);
    int* cell = s_cell[axis][bin];
    float* w = s_w[axis][bin];
    if (axis == 0) {
      const float count = (float)(n_y * n_x);
      s_k[0][bin] = axis_table(ylo, yhi, P, n_y, bin, H, [&](int j, int c, float wt) {
        cell[j] = c * W;
        w[j] = wt / count;
      });
    } else {
      s_k[1][bin] = axis_table(xlo, xhi, P, n_x, bin, W, [&](int j, int c, float wt) {
        cell[j] = c;
        w[j] = wt;
      });
    }
  }
  __syncthreads();

  const In* const feat = at_level(lv.feat, l);
  const int workers = blockDim.x / groups;
  for (int g = t % groups; g < n_groups; g += groups)
  for (int bin = t / groups; bin < P * P; bin += workers) {
    const int c = g * N;
    const int n = min(N, C - c);
    const In* f = feat + (size_t)b * H * W * C + c;
    const int py = bin / P, px = bin % P;
    const int ky = s_k[0][py], kx = s_k[1][px];
    const int* xc = s_cell[1][px];
    const float* xw = s_w[1][px];
    float acc[N];
#pragma unroll
    for (int v = 0; v < N; ++v) acc[v] = 0.0f;
    for (int e = 0; e < ky; ++e) {
      const In* row = f + (size_t)s_cell[0][py][e] * C;
      float tx[N];
#pragma unroll
      for (int v = 0; v < N; ++v) tx[v] = 0.0f;
#pragma unroll
      for (int q0 = 0; q0 < kMaxPairs; q0 += kChunk) {
        if (q0 >= kx) break;
        Raw r[kChunk];
        float wx[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const bool on = q0 + i < kx;
          wx[i] = on ? xw[q0 + i] : 0.0f;
          r[i] = on ? load_raw(row + (size_t)xc[q0 + i] * C, n, vec) : Raw{};
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
#pragma unroll
          for (int v = 0; v < N; ++v) tx[v] = fmaf(wx[i], elem(r[i], v), tx[v]);
      }
      const float wy = s_w[0][py][e];
#pragma unroll
      for (int v = 0; v < N; ++v) acc[v] = fmaf(wy, tx[v], acc[v]);
    }
    store_vals<N>(out + ((size_t)roi * P * P + bin) * C + c, acc, n, vec);
  }
}

template <typename In, typename Out>
int launch(const void* f0, const void* f1, const void* f2, const void* f3, int h0, int w0, int h1,
           int w1, int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
           const float* boxes, const int* levels, int n_rois, int rois_per_image, int C, int P,
           int S, void* out, void* stream) {
  constexpr int N = Vec<In>::N;
  // the adaptive grid: K1 (bf16 in, f32 out) only
  constexpr bool kAdaptiveOk = std::is_same<In, __nv_bfloat16>::value && std::is_same<Out, float>::value;
  const bool adaptive = S == -1;
  if (adaptive ? !kAdaptiveOk || P < 1 || P > kMaxAdaptiveP : P < 1 || S < 1 || P * S > kMaxSamples)
    return (int)cudaErrorInvalidValue;
  if (n_rois <= 0 || C < 1) return (int)cudaErrorInvalidValue;
  Levels<In> lv;
  lv.feat[0] = (const In*)f0;
  lv.feat[1] = (const In*)f1;
  lv.feat[2] = (const In*)f2;
  lv.feat[3] = (const In*)f3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.inv_stride[0] = s0; lv.inv_stride[1] = s1; lv.inv_stride[2] = s2; lv.inv_stride[3] = s3;
  // 16-byte vectors need every cell row (C * size) and every base aligned
  bool vec = C % N == 0 && ((uintptr_t)out % 16) == 0;
  for (int i = 0; i < kLevels; ++i) vec = vec && ((uintptr_t)lv.feat[i] % 16) == 0;
  const int n_groups = (C + N - 1) / N;
  const int groups = n_groups < kMaxThreads ? n_groups : kMaxThreads;  // threads along C
  const bool fixed = P == 7 && S == 2;
  int workers = kMaxThreads / groups;  // P workers of P bins each, where the channels allow
  if (workers > P) workers = P;
  const int threads = groups * workers;
  cudaStream_t st = (cudaStream_t)stream;
  if (adaptive) {
    if constexpr (kAdaptiveOk) {
      if (P == 7)
        roi_align_fwd_adaptive_kernel<7><<<n_rois, threads, 0, st>>>(lv, boxes, levels, rois_per_image, C, P, groups,
                                                                      n_groups, vec, (float*)out);
      else
        roi_align_fwd_adaptive_kernel<0><<<n_rois, threads, 0, st>>>(lv, boxes, levels, rois_per_image, C, P, groups,
                                                                      n_groups, vec, (float*)out);
    }
  } else if (fixed)
    roi_align_fwd_kernel<In, Out, 7, 2><<<n_rois, threads, 0, st>>>(
        lv, boxes, levels, rois_per_image, C, P, S, groups, n_groups, vec, (Out*)out);
  else
    roi_align_fwd_kernel<In, Out, 0, 0><<<n_rois, threads, 0, st>>>(
        lv, boxes, levels, rois_per_image, C, P, S, groups, n_groups, vec, (Out*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1: feats are 4 NHWC bf16 level pointers with their (h, w) and 1/stride;
// the output is f32; S == -1 is the adaptive grid. Returns
// cudaGetLastError() after the launch (0 on success).
int roi_align_fwd(const void* f0, const void* f1, const void* f2, const void* f3, int h0,
                  int w0, int h1, int w1, int h2, int w2, int h3, int w3, float s0, float s1,
                  float s2, float s3, const float* boxes, const int* levels, int n_rois,
                  int rois_per_image, int C, int P, int S, float* out, void* stream) {
  return launch<__nv_bfloat16, float>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, s0, s1, s2,
                                      s3, boxes, levels, n_rois, rois_per_image, C, P, S, out, stream);
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
