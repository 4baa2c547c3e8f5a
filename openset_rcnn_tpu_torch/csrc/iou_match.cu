// Fused IoU + matcher for RPN target assignment, for Hopper (sm_90a).
//
// Replaces the TPU kernel iou_match_pallas
// (openset_rcnn_tpu/ops/pallas/iou_match_kernel.py:100, body _kernel :30-97)
// and the XLA fallback it stands for (openset_rcnn_tpu/models/rpn.py:111-119
// plus the gt_boxes[matched_idx] gather). The (G x R) IoU matrix is never
// formed. Per image b and anchor r:
//   max_iou[b, r]       best IoU over the valid GT, -1 when no GT is valid;
//   matched_idx[b, r]   the first GT reaching it (0 when none);
//   matched_boxes[b, r] that GT's box (GT row 0 when none);
//   rescued[b, r]       1 if the anchor ties a valid GT's best IoU over all
//                       anchors and that best is > 0 (low-quality rescue).
//
// Inputs: anchors (R, 4) f32 xyxy, 16-byte aligned, shared by the batch; gt
// (B, G, 4) f32; gt_valid (B, G) bool (one byte each). partial
// (B, ceil(R / kChunk), G) f32 is scratch that the kernels fill themselves,
// so the caller allocates it without filling it.
//
// Bound on the H100: bytes, the anchors read and 4 + 4 + 1 + 16 bytes written
// per anchor and image (0.0116 ms at B=16, R = 93,093); the IoUs (~15 flops
// and an IEEE division per anchor and valid GT, 28M at B=16) take less at
// the f32 rate, but their divisions make pass 1 the larger of the two.
//
// Design. On the TPU one program holds all R anchors of an image, so the
// per-GT maximum over anchors is a local reduction. Here the anchors spread
// over blocks, so the maximum crosses blocks and the work takes two launches,
// and nothing else (no fill, no memset):
//   pass 1 (iou_match_best_kernel), grid (nb, B) sized to the card: each
//     block stages its image's valid GT rows, ascending, in shared memory;
//     each thread holds kPerThread anchors (strided by the block, so the
//     16-byte anchor loads and the stores stay coalesced) and loops over the
//     GT once: the running best IoU and its first GT per anchor, and per GT
//     the block's maximum. A warp pushes to that maximum only when one of
//     its lanes beats the block's current value (__any_sync); the value only
//     grows, so a skipped value can never be the maximum. Each block writes
//     its maxima to its own row of `partial`: no global atomics.
//   pass 2 (iou_match_rescue_kernel), the same grid over the same anchors:
//     each block reduces its image's rows of `partial` to the per-GT best.
//     An anchor of block j can tie GT g only if block j's own maximum for g
//     is g's best, and only if best[g] <= max_iou[a] (max_iou[a] is the
//     maximum of the same IoU bits). So a block lists the GT whose best > 0
//     it attains (most blocks: none, and they only write zeros), t is the
//     smallest of their bests, an anchor with max_iou < t writes 0 at the
//     cost of one load, and a candidate recomputes the IoU only for the
//     listed GT with best[g] <= max_iou[a].
// Both passes compute the IoU with one __device__ function, the expression of
// ops/boxes.py::pairwise_iou operation for operation, built with
// --fmad=false, so `iou == best` in pass 2 compares identical bits and every
// output equals the plain PyTorch version exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                     // anchors a thread holds at once
constexpr int kChunk = kThreads * kPerThread;     // anchors a block takes per step (ops/iou_match.py CHUNK)
constexpr int kMaxGt = 1024;                      // shared memory: 28 bytes per GT row
constexpr int kBlocksPerSm = 4;                   // pass grids: this many blocks per SM, spread over the images
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float pairwise_iou(float4 g, float g_area, float4 a, float a_area) {
  // lt = max(gt[:2], a[:2]); rb = min(gt[2:], a[2:]); wh = clamp(rb - lt, 0)
  const float iw = fmaxf(fminf(g.z, a.z) - fmaxf(g.x, a.x), 0.0f);
  const float ih = fmaxf(fminf(g.w, a.w) - fmaxf(g.y, a.y), 0.0f);
  const float inter = iw * ih;
  const float uni = g_area + a_area - inter;
  return inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
}

__device__ __forceinline__ float area_of(float4 b) { return (b.z - b.x) * (b.w - b.y); }

// Image b's valid GT rows in shared memory, in ascending index order (so a
// strict '>' over them keeps the first maximum): box, area, index.
struct GtRows {
  float4* box;
  float* area;
  int* idx;
  unsigned int* mask;  // [32]: validity bits of GT rows 32k .. 32k + 31
};

__device__ __forceinline__ GtRows carve(unsigned char* smem, int G) {
  GtRows s;
  s.box = reinterpret_cast<float4*>(smem);
  s.area = reinterpret_cast<float*>(s.box + G);
  s.idx = reinterpret_cast<int*>(s.area + G);
  s.mask = reinterpret_cast<unsigned int*>(s.idx + G);
  return s;
}

// Stage the valid rows (every thread of the block calls it); returns their
// number.
__device__ int stage_valid_gt(const float* __restrict__ gt, const uint8_t* __restrict__ gt_valid, int b, int G,
                              GtRows s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (G + 31) / 32;
  for (int k = warp; k < groups; k += kThreads / 32) {
    const int g = 32 * k + lane;
    const unsigned int m = __ballot_sync(kFull, g < G && gt_valid[(size_t)b * G + g] != 0);
    if (lane == 0) s.mask[k] = m;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const int k = g >> 5, bit = g & 31;
    if (!((s.mask[k] >> bit) & 1u)) continue;
    int off = __popc(s.mask[k] & ((1u << bit) - 1u));
    for (int q = 0; q < k; ++q) off += __popc(s.mask[q]);
    const float* p = gt + ((size_t)b * G + g) * 4;
    const float4 box = make_float4(p[0], p[1], p[2], p[3]);
    s.box[off] = box;
    s.area[off] = area_of(box);
    s.idx[off] = g;
  }
  int n = 0;
  for (int q = 0; q < groups; ++q) n += __popc(s.mask[q]);
  __syncthreads();
  return n;
}

__global__ void __launch_bounds__(kThreads) iou_match_best_kernel(
    const float4* __restrict__ anchors, const float* __restrict__ gt, const uint8_t* __restrict__ gt_valid,
    int G, int R, float* __restrict__ partial, float* __restrict__ max_iou, int* __restrict__ matched_idx,
    float4* __restrict__ matched_boxes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GtRows s = carve(smem, G);
  int* s_best = reinterpret_cast<int*>(s.mask + 32);  // [nv]: the block's max per valid GT, as f32 bits
  const int b = blockIdx.y, nb = gridDim.x;
  const int nv = stage_valid_gt(gt, gt_valid, b, G, s);
  // IoUs are >= 0, and the int order of non-negative floats is their float
  // order; -1.0f has a negative int and stays below every IoU
  for (int k = threadIdx.x; k < nv; k += kThreads) s_best[k] = __float_as_int(-1.0f);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const float4 row0 = make_float4(gt[(size_t)b * G * 4], gt[(size_t)b * G * 4 + 1], gt[(size_t)b * G * 4 + 2],
                                  gt[(size_t)b * G * 4 + 3]);
  for (int base = blockIdx.x * kChunk; base < R; base += nb * kChunk) {
    float4 a[kPerThread];
    float a_area[kPerThread], best[kPerThread];
    int best_k[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = base + j * kThreads + threadIdx.x;
      a[j] = r < R ? anchors[r] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a_area[j] = area_of(a[j]);
      best[j] = -1.0f;
      best_k[j] = -1;
    }
    for (int k = 0; k < nv; ++k) {
      const float4 g = s.box[k];
      const float g_area = s.area[k];
      float m = -1.0f;  // this thread's maximum for GT k; inactive anchors stay at -1
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float iou = pairwise_iou(g, g_area, a[j], a_area[j]);
        if (iou > best[j]) {  // strict: the first maximum wins
          best[j] = iou;
          best_k[j] = k;
        }
        if (base + j * kThreads + (int)threadIdx.x < R) m = fmaxf(m, iou);
      }
      const float cur = __int_as_float(reinterpret_cast<volatile int*>(s_best)[k]);
      if (__any_sync(kFull, m > cur)) {
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        if (lane == 0) atomicMax(&s_best[k], __float_as_int(m));
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = base + j * kThreads + threadIdx.x;
      if (r >= R) continue;
      const size_t o = (size_t)b * R + r;
      max_iou[o] = best[j];
      matched_idx[o] = best_k[j] < 0 ? 0 : s.idx[best_k[j]];
      matched_boxes[o] = best_k[j] < 0 ? row0 : s.box[best_k[j]];
    }
  }
  __syncthreads();
  float* mine = partial + ((size_t)b * nb + blockIdx.x) * G;
  for (int k = threadIdx.x; k < nv; k += kThreads) mine[k] = __int_as_float(s_best[k]);
}

__global__ void __launch_bounds__(kThreads) iou_match_rescue_kernel(
    const float4* __restrict__ anchors, const float* __restrict__ gt, const uint8_t* __restrict__ gt_valid,
    int G, int R, const float* __restrict__ partial, const float* __restrict__ max_iou,
    uint8_t* __restrict__ rescued) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GtRows s = carve(smem, G);
  int* s_best = reinterpret_cast<int*>(s.mask + 32);  // [nv]: best over all anchors, as f32 bits
  int* s_list = s_best + G;                           // [s_n]: the GT whose best this block attains
  int* s_n = s_list + G;
  int* s_t = s_n + 1;                                 // the smallest of their bests, as f32 bits
  const int b = blockIdx.y, nb = gridDim.x;
  const int nv = stage_valid_gt(gt, gt_valid, b, G, s);
  if (threadIdx.x == 0) {
    *s_n = 0;
    *s_t = 0x7f800000;  // +inf: no anchor is a candidate
  }
  __syncthreads();
  // k's best: a warp per GT, its lanes over the blocks' rows (independent
  // loads, then a shuffle reduction)
  const float* rows = partial + (size_t)b * nb * G;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < nv; k += kThreads / 32) {
    float m = -1.0f;
    for (int j = lane; j < nb; j += 32) m = fmaxf(m, rows[(size_t)j * G + k]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) s_best[k] = __float_as_int(m);
  }
  __syncthreads();
  // An anchor of this block ties GT k only if the block's own maximum for k
  // (its row of partial, over the same anchors as in pass 1) is k's best.
  const float* mine = rows + (size_t)blockIdx.x * G;
  for (int k = threadIdx.x; k < nv; k += kThreads) {
    if (__int_as_float(s_best[k]) > 0.0f && __float_as_int(mine[k]) == s_best[k]) {
      s_list[atomicAdd(s_n, 1)] = k;
      atomicMin(s_t, s_best[k]);
    }
  }
  __syncthreads();
  const int n_list = *s_n;
  const float t = __int_as_float(*s_t);

  for (int base = blockIdx.x * kChunk; base < R; base += nb * kChunk) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int r = base + j * kThreads + threadIdx.x;
      if (r >= R) continue;
      const size_t o = (size_t)b * R + r;
      bool tie = false;
      if (n_list > 0) {
        const float mi = max_iou[o];
        if (mi >= t) {  // a candidate: recompute the IoU against the GT it can tie
          const float4 a = anchors[r];
          const float a_area = area_of(a);
          for (int q = 0; q < n_list && !tie; ++q) {
            const int k = s_list[q];
            const float gb = __int_as_float(s_best[k]);
            if (gb <= mi) tie = pairwise_iou(s.box[k], s.area[k], a, a_area) == gb;
          }
        }
      }
      rescued[o] = tie ? 1 : 0;
    }
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Two launches on `stream`; returns cudaGetLastError() after them (0 on
// success).
int iou_match(const float* anchors, const float* gt, const uint8_t* gt_valid, int B, int G, int R,
              float* partial, float* max_iou, int* matched_idx, uint8_t* rescued, float* matched_boxes,
              void* stream) {
  if (B <= 0 || R <= 0 || G <= 0 || G > kMaxGt || ((uintptr_t)anchors % 16) != 0 ||
      ((uintptr_t)matched_boxes % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (R + kChunk - 1) / kChunk;
  const int per_image = (kBlocksPerSm * sm_count() + B - 1) / B;
  const dim3 grid(chunks < per_image ? chunks : per_image, B);
  // GtRows (28 bytes per row), the 32 mask words, then per-GT bests, a GT
  // list, its length and t
  const size_t smem = (size_t)G * (sizeof(float4) + 2 * sizeof(int)) + 32 * sizeof(int) + (2 * G + 2) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* a4 = reinterpret_cast<const float4*>(anchors);
  iou_match_best_kernel<<<grid, kThreads, smem, s>>>(a4, gt, gt_valid, G, R, partial, max_iou, matched_idx,
                                                     reinterpret_cast<float4*>(matched_boxes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  iou_match_rescue_kernel<<<grid, kThreads, smem, s>>>(a4, gt, gt_valid, G, R, partial, max_iou, rescued);
  return (int)cudaGetLastError();
}

}  // extern "C"
