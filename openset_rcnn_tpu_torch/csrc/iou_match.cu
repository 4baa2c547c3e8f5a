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
// Inputs: anchors (R, 4) f32 xyxy, shared by the batch; gt (B, G, 4) f32;
// gt_valid (B, G) bool (one byte each). gt_best (B, G) f32 is scratch that
// the caller fills with -1.
//
// Design. On the TPU one program holds all R anchors of an image, so the
// per-GT maximum over anchors is a local reduction. Here the anchors spread
// over many blocks, so the maximum is a reduction across blocks and the work
// takes two launches:
//   pass 1, grid (ceil(R / 256), B), one thread per anchor, the image's GT in
//     shared memory: the running best IoU, its GT index and box; and per GT a
//     warp max, a shared atomicMax and one global atomicMax per block into
//     gt_best. The atomics act on the int bits of the float: IoUs are >= 0,
//     and the int order of non-negative floats is their float order; -1.0f
//     has a negative int and so stays below every IoU, which is how a GT that
//     is invalid keeps -1;
//   pass 2, the same grid: recompute the IoUs and set rescued.
// Both passes compute the IoU with one __device__ function, the expression of
// ops/boxes.py::pairwise_iou operation for operation, built with
// --fmad=false, so `row == best` in pass 2 compares identical bits and every
// output equals the plain PyTorch version exactly.
//
// Bound on the H100: operations. B * G * R IoU evaluations (~74.5M at B=4,
// G=100, R=93,093), ~15 flops each, twice (one per pass); the bytes (anchors
// read, 4 + 4 + 1 + 16 bytes written per anchor and image) take less.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGt = 1024;  // shared memory: 28 bytes per GT row

struct Gt {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ float pairwise_iou(const Gt& g, float ax1, float ay1, float ax2,
                                              float ay2, float a_area) {
  // lt = max(gt[:2], a[:2]); rb = min(gt[2:], a[2:]); wh = clamp(rb - lt, 0)
  const float iw = fmaxf(fminf(g.x2, ax2) - fmaxf(g.x1, ax1), 0.0f);
  const float ih = fmaxf(fminf(g.y2, ay2) - fmaxf(g.y1, ay1), 0.0f);
  const float inter = iw * ih;
  const float uni = g.area + a_area - inter;
  return inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
}

// Stage image b's GT rows (box, area, validity) in shared memory.
__device__ __forceinline__ void load_gt(const float* __restrict__ gt,
                                        const uint8_t* __restrict__ gt_valid, int b, int G,
                                        Gt* s_gt, int* s_valid) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* p = gt + ((size_t)b * G + g) * 4;
    Gt row;
    row.x1 = p[0];
    row.y1 = p[1];
    row.x2 = p[2];
    row.y2 = p[3];
    row.area = (row.x2 - row.x1) * (row.y2 - row.y1);
    s_gt[g] = row;
    s_valid[g] = gt_valid[(size_t)b * G + g] != 0;
  }
}

__global__ void iou_match_pass1(const float* __restrict__ anchors, const float* __restrict__ gt,
                                const uint8_t* __restrict__ gt_valid, int G, int R,
                                int* __restrict__ gt_best, float* __restrict__ max_iou,
                                int* __restrict__ matched_idx,
                                float* __restrict__ matched_boxes) {
  extern __shared__ unsigned char smem[];
  Gt* s_gt = reinterpret_cast<Gt*>(smem);
  int* s_valid = reinterpret_cast<int*>(s_gt + G);
  int* s_best = s_valid + G;  // block max per GT, as f32 bits
  const int b = blockIdx.y;
  load_gt(gt, gt_valid, b, G, s_gt, s_valid);
  for (int g = threadIdx.x; g < G; g += blockDim.x) s_best[g] = __float_as_int(-1.0f);
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < R;
  float ax1 = 0.0f, ay1 = 0.0f, ax2 = 0.0f, ay2 = 0.0f;
  if (active) {
    ax1 = anchors[4 * (size_t)r + 0];
    ay1 = anchors[4 * (size_t)r + 1];
    ax2 = anchors[4 * (size_t)r + 2];
    ay2 = anchors[4 * (size_t)r + 3];
  }
  const float a_area = (ax2 - ax1) * (ay2 - ay1);
  float best = -1.0f;
  int best_g = 0;
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < G; ++g) {
    if (!s_valid[g]) continue;  // uniform across the block: an invalid row is -1 and never wins
    const float row = pairwise_iou(s_gt[g], ax1, ay1, ax2, ay2, a_area);
    if (row > best) {  // strict: the first maximum wins
      best = row;
      best_g = g;
    }
    float m = active ? row : -1.0f;
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && m >= 0.0f) atomicMax(&s_best[g], __float_as_int(m));
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (s_valid[g] && s_best[g] >= 0) atomicMax(&gt_best[(size_t)b * G + g], s_best[g]);
  }
  if (!active) return;
  const size_t o = (size_t)b * R + r;
  max_iou[o] = best;
  matched_idx[o] = best_g;
  const Gt& m = s_gt[best_g];
  matched_boxes[4 * o + 0] = m.x1;
  matched_boxes[4 * o + 1] = m.y1;
  matched_boxes[4 * o + 2] = m.x2;
  matched_boxes[4 * o + 3] = m.y2;
}

__global__ void iou_match_pass2(const float* __restrict__ anchors, const float* __restrict__ gt,
                                const uint8_t* __restrict__ gt_valid, int G, int R,
                                const float* __restrict__ gt_best,
                                uint8_t* __restrict__ rescued) {
  extern __shared__ unsigned char smem[];
  Gt* s_gt = reinterpret_cast<Gt*>(smem);
  int* s_valid = reinterpret_cast<int*>(s_gt + G);
  float* s_best = reinterpret_cast<float*>(s_valid + G);
  const int b = blockIdx.y;
  load_gt(gt, gt_valid, b, G, s_gt, s_valid);
  for (int g = threadIdx.x; g < G; g += blockDim.x) s_best[g] = gt_best[(size_t)b * G + g];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ax1 = anchors[4 * (size_t)r + 0];
  const float ay1 = anchors[4 * (size_t)r + 1];
  const float ax2 = anchors[4 * (size_t)r + 2];
  const float ay2 = anchors[4 * (size_t)r + 3];
  const float a_area = (ax2 - ax1) * (ay2 - ay1);
  bool tie = false;
  for (int g = 0; g < G; ++g) {
    const float gm = s_best[g];
    if (!s_valid[g] || !(gm > 0.0f)) continue;
    tie |= pairwise_iou(s_gt[g], ax1, ay1, ax2, ay2, a_area) == gm;
  }
  rescued[(size_t)b * R + r] = tie ? 1 : 0;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Two launches on `stream`; returns cudaGetLastError() after them (0 on
// success). gt_best must hold -1.0f in every entry.
int iou_match(const float* anchors, const float* gt, const uint8_t* gt_valid, int B, int G, int R,
              float* gt_best, float* max_iou, int* matched_idx, uint8_t* rescued,
              float* matched_boxes, void* stream) {
  if (B <= 0 || R <= 0 || G <= 0 || G > kMaxGt) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)G * (sizeof(Gt) + 2 * sizeof(int));
  cudaStream_t s = (cudaStream_t)stream;
  iou_match_pass1<<<grid, kThreads, smem, s>>>(anchors, gt, gt_valid, G, R, (int*)gt_best,
                                               max_iou, matched_idx, matched_boxes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  iou_match_pass2<<<grid, kThreads, smem, s>>>(anchors, gt, gt_valid, G, R, gt_best, rescued);
  return (int)cudaGetLastError();
}

}  // extern "C"
