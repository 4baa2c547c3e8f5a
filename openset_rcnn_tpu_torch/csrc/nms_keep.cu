// Greedy NMS keep mask over score-sorted boxes, batched over images, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel nms_keep_pallas
// (openset_rcnn_tpu/ops/pallas/nms_kernel.py:61, body _nms_kernel :27-58).
// Same function: box i (in score order) is kept iff it is valid and no kept
// box before it overlaps it with IoU strictly above the threshold, where
// IoU = union > 0 ? inter / max(union, 1e-12) : 0 and union = area_i +
// area_j - inter. Invalid boxes are never kept and never suppress.
//
// Inputs: boxes (B, N, 4) f32 xyxy, already sorted; valid (B, N) uint8.
// Output: keep (B, N) uint8 (0/1; a torch.bool tensor).
//
// Design: one block per image; the image's boxes, areas and a suppressed
// flag per box live in shared memory (21 bytes a box). The block walks i in
// order. A box that is already suppressed is skipped by every thread alike
// (its flag was last written before the previous barrier), so only a kept
// box costs a step: its IoU row against the boxes after it, threads over j,
// then one barrier. At the end keep[j] = !suppressed[j].
//
// Bound on the H100: neither bytes (16 bytes a box) nor operations (~15
// flops per IoU, at most N^2/2 of them) but the chain of dependent steps,
// one per kept box, each ending in a block barrier. Images run in parallel,
// one per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

size_t smem_bytes(int N) { return (size_t)N * (5 * sizeof(float) + 1); }

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid, int N, float thresh,
                                uint8_t* __restrict__ keep) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + N;
  float* x2 = y1 + N;
  float* y2 = x2 + N;
  float* area = y2 + N;
  uint8_t* sup = reinterpret_cast<uint8_t*>(area + N);

  const int b = blockIdx.x;
  const float* bx = boxes + (size_t)b * N * 4;
  const uint8_t* vb = valid + (size_t)b * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float a = bx[4 * j], c = bx[4 * j + 1], d = bx[4 * j + 2], e = bx[4 * j + 3];
    x1[j] = a;
    y1[j] = c;
    x2[j] = d;
    y2[j] = e;
    area[j] = (d - a) * (e - c);
    sup[j] = vb[j] ? 0 : 1;  // an invalid box is never alive
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    if (sup[i]) continue;  // uniform across the block
    const float bx1 = x1[i], by1 = y1[i], bx2 = x2[i], by2 = y2[i], barea = area[i];
    for (int j = i + 1 + threadIdx.x; j < N; j += blockDim.x) {
      const float iw = fmaxf(fminf(bx2, x2[j]) - fmaxf(bx1, x1[j]), 0.0f);
      const float ih = fmaxf(fminf(by2, y2[j]) - fmaxf(by1, y1[j]), 0.0f);
      const float inter = iw * ih;
      const float uni = barea + area[j] - inter;
      const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-12f) : 0.0f;
      if (iou > thresh) sup[j] = 1;
    }
    __syncthreads();
  }

  uint8_t* kb = keep + (size_t)b * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) kb[j] = sup[j] ? 0 : 1;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Returns cudaGetLastError() after the launch (0 on success).
int nms_keep(const float* boxes, const uint8_t* valid, int B, int N, float thresh,
             uint8_t* keep, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(boxes, valid, N, thresh, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
