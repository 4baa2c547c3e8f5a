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
// Output: keep (B, N) uint8 (0/1; a torch.bool tensor). Scratch: the
// suppression mask, (B, nw, 64 * nw) uint64 with nw = ceil(N / 64), which
// the caller allocates and need not zero.
//
// Bound on the H100: neither bytes (16 bytes a box) nor operations (~15
// flops per IoU, at most N^2/2 of them) but the greedy chain: whether box i
// is kept depends on every kept box before it. Done as one block-wide step
// per kept box (an IoU row, then a barrier) the chain costs ~1 us a kept box
// on 8 of 132 SMs. Two launches on one stream take it apart:
//   * nms_iou_mask_kernel, the N^2/2 IoU tests in parallel over the card: one
//     64-thread block per (row block, column block >= row block, image)
//     stages its 64 column boxes in shared memory; thread i writes word
//     mask[b][cb][i], whose bit j is set iff j > i and IoU(i, j) > thresh
//     (the expression above, operand for operand, built with --fmad=false,
//     so the mask holds exactly the pairs the plain version tests). The
//     layout is word-major, so the 64 threads write 512 contiguous bytes.
//   * nms_walk_kernel, the chain, one block per image: a single warp walks
//     the rows in score order holding the "removed" bitmask in registers
//     (lane w owns words w, w + 32, ...), starting from ~valid. Within a
//     64-row chunk every lane holds the chunk's word; __ffsll jumps to the
//     next row still alive, which is kept, and its mask row is ORed in
//     (its first word into the chunk's word, the rest by the owning lanes).
//     So a kept row costs a shared-memory load and a few ALU operations, a
//     removed row nothing. The other warps stage the next chunk's mask rows
//     (words >= the chunk's, which pass 1 wrote) into a shared-memory double
//     buffer with cp.async while the walk runs, and the block meets at one
//     barrier per chunk. Last, keep = ~removed, written by the whole block.
// Times of this design and of the one-block form it replaced: PERF.md.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // rows (and columns) of a mask tile: one uint64 word
constexpr int kWalkThreads = 256;  // one walking warp, seven staging warps
constexpr int kMaxWordsPerLane = 8;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) { return (x2 - x1) * (y2 - y1); }

__global__ void __launch_bounds__(kRows) nms_iou_mask_kernel(const float* __restrict__ boxes, int N, int nw,
                                                             float thresh, unsigned long long* __restrict__ mask) {
  __shared__ float sx1[kRows], sy1[kRows], sx2[kRows], sy2[kRows], sarea[kRows];
  // blockIdx.x enumerates the tiles (rb, cb) with cb >= rb, row by row
  int rb = 0, rest = blockIdx.x;
  while (rest >= nw - rb) {
    rest -= nw - rb;
    ++rb;
  }
  const int cb = rb + rest;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float* bx = boxes + (size_t)b * N * 4;
  const int j = cb * kRows + t;
  if (j < N) {
    const float* c = bx + 4 * (size_t)j;
    sx1[t] = c[0];
    sy1[t] = c[1];
    sx2[t] = c[2];
    sy2[t] = c[3];
    sarea[t] = box_area(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();
  const int i = rb * kRows + t;
  if (i >= N) return;
  const float* ri = bx + 4 * (size_t)i;
  const float rx1 = ri[0], ry1 = ri[1], rx2 = ri[2], ry2 = ri[3];
  const float rarea = box_area(rx1, ry1, rx2, ry2);
  const int ncols = min(kRows, N - cb * kRows);
  unsigned long long bits = 0ull;
  for (int jj = rb == cb ? t + 1 : 0; jj < ncols; ++jj) {
    const float iw = fmaxf(fminf(rx2, sx2[jj]) - fmaxf(rx1, sx1[jj]), 0.0f);
    const float ih = fmaxf(fminf(ry2, sy2[jj]) - fmaxf(ry1, sy1[jj]), 0.0f);
    const float inter = iw * ih;
    const float uni = rarea + sarea[jj] - inter;
    const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-12f) : 0.0f;
    if (iou > thresh) bits |= 1ull << jj;
  }
  mask[((size_t)b * nw + cb) * ((size_t)nw * kRows) + i] = bits;
}

// Stage words [k, nw) of rows [64k, 64k + 64) into buf[row * ld + (w - k)].
__device__ __forceinline__ void stage_chunk(const unsigned long long* __restrict__ mb, int k, int nw, int N,
                                            unsigned long long* buf, int ld, int tid, int nthreads) {
  const int rows = min(kRows, N - k * kRows);
  const int n = (nw - k) * kRows;
  for (int e = tid; e < n; e += nthreads) {
    const int r = e % kRows, wi = e / kRows;
    if (r >= rows) continue;
    __pipeline_memcpy_async(buf + r * ld + wi, mb + (size_t)(k + wi) * nw * kRows + k * kRows + r, 8);
  }
  __pipeline_commit();
}

template <int WPL>
__global__ void __launch_bounds__(kWalkThreads) nms_walk_kernel(const unsigned long long* __restrict__ mask,
                                                                const uint8_t* __restrict__ valid, int N, int nw,
                                                                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  const int ld = nw | 1;  // odd row stride: the stagers' 8-byte stores spread over the banks
  unsigned long long* buf[2] = {smem, smem + kRows * ld};
  unsigned long long* s_removed = smem + 2 * kRows * ld;

  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned long long* mb = mask + (size_t)b * nw * nw * kRows;
  const uint8_t* vb = valid + (size_t)b * N;

  if (warp != 0) stage_chunk(mb, 0, nw, N, buf[0], ld, t - 32, kWalkThreads - 32);
  // removed starts as ~valid; rows past N count as removed
  unsigned int* s_removed32 = reinterpret_cast<unsigned int*>(s_removed);
  for (int h = warp; h < 2 * nw; h += kWalkThreads / 32) {
    const int j = h * 32 + lane;
    const unsigned int alive = __ballot_sync(0xffffffffu, j < N && vb[j]);
    if (lane == 0) s_removed32[h] = ~alive;
  }
  if (warp != 0) __pipeline_wait_prior(0);
  __syncthreads();

  unsigned long long rem[WPL];
#pragma unroll
  for (int s = 0; s < WPL; ++s) {
    const int w = lane + 32 * s;
    rem[s] = w < nw ? s_removed[w] : ~0ull;
  }

  for (int k = 0; k < nw; ++k) {
    const unsigned long long* cur = buf[k & 1];
    if (warp != 0) {
      if (k + 1 < nw) stage_chunk(mb, k + 1, nw, N, buf[(k + 1) & 1], ld, t - 32, kWalkThreads - 32);
    } else {
      // the chunk's word, broadcast from its owner lane
      unsigned long long mine = 0ull;
#pragma unroll
      for (int s = 0; s < WPL; ++s)
        if (s == k / 32) mine = rem[s];
      unsigned long long word = __shfl_sync(0xffffffffu, mine, k & 31);
      unsigned long long avail = ~word;
      while (avail) {
        const int r = __ffsll((long long)avail) - 1;  // the next row still alive: kept
        const unsigned long long* row = cur + r * ld;
        word |= row[0];
#pragma unroll
        for (int s = 0; s < WPL; ++s) {
          const int w = lane + 32 * s;
          if (w >= k && w < nw) rem[s] |= row[w - k];
        }
        avail = r == 63 ? 0ull : ~word & (~0ull << (r + 1));
      }
    }
    if (warp != 0) __pipeline_wait_prior(0);
    __syncthreads();
  }

  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      const int w = lane + 32 * s;
      if (w < nw) s_removed[w] = rem[s];
    }
  }
  __syncthreads();
  uint8_t* kb = keep + (size_t)b * N;
  for (int j = t; j < N; j += kWalkThreads) kb[j] = (s_removed[j >> 6] >> (j & 63)) & 1ull ? 0 : 1;
}

size_t walk_smem_bytes(int nw) { return ((size_t)2 * kRows * (nw | 1) + nw) * sizeof(unsigned long long); }

template <int WPL>
cudaError_t launch_walk(const unsigned long long* mask, const uint8_t* valid, int B, int N, int nw, uint8_t* keep,
                        cudaStream_t stream) {
  const size_t smem = walk_smem_bytes(nw);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(nms_walk_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  nms_walk_kernel<WPL><<<B, kWalkThreads, smem, stream>>>(mask, valid, N, nw, keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The largest N the walk's shared memory takes.
int nms_max_boxes() {
  int nw = 1;
  while (nw + 1 <= kMaxWordsPerLane * 32 && walk_smem_bytes(nw + 1) <= 232448) ++nw;
  return nw * kRows;
}

// Both passes, back to back on the stream: the suppression mask into `mask`
// ((B, nw, 64 * nw) uint64, nw = ceil(N / 64)), then the walk into `keep`.
// Returns cudaGetLastError() (0 on success).
int nms_keep(const float* boxes, const uint8_t* valid, int B, int N, float thresh, void* mask, uint8_t* keep,
             void* stream) {
  if (B <= 0 || N <= 0 || N > nms_max_boxes()) return (int)cudaErrorInvalidValue;
  const int nw = (N + kRows - 1) / kRows;
  unsigned long long* m = (unsigned long long*)mask;
  cudaStream_t s = (cudaStream_t)stream;
  nms_iou_mask_kernel<<<dim3(nw * (nw + 1) / 2, B), kRows, 0, s>>>(boxes, N, nw, thresh, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nw <= 32) err = launch_walk<1>(m, valid, B, N, nw, keep, s);
  else if (nw <= 64) err = launch_walk<2>(m, valid, B, N, nw, keep, s);
  else if (nw <= 128) err = launch_walk<4>(m, valid, B, N, nw, keep, s);
  else err = launch_walk<8>(m, valid, B, N, nw, keep, s);
  return (int)err;
}

}  // extern "C"
