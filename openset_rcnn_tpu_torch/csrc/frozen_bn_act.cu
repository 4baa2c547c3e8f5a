// FrozenBN's affine, with an optional residual and ReLU, in one pass over
// the activations, for Hopper (sm_90a).
//
// Replaces no TPU kernel. XLA fused the per-channel multiply-add of
// FrozenBN (openset_rcnn_tpu/models/resnet.py) into the neighbouring
// elementwise fusions, so the JAX package never paid for it; PyTorch runs it
// as separate broadcast passes (x * w, + b, the residual's add, ReLU) and
// seven small kernels that fold the four buffers into w and b, every call.
// This kernel is those passes as one, launched by ops/frozen_bn.py
// (operator openset_rcnn::frozen_bn_act) from models/resnet.py.
//
// Per element, with w_c = scale_c / sqrt(var_c + eps), b_c = bias_c -
// mean_c * w_c (each operation rounded in f32, then w_c and b_c rounded to
// the activation dtype T):
//   y = act( rnd(rnd(x * w_c) + b_c)  [ + rnd(rnd(r * wr_c) + br_c)  or  + r ] )
// with rnd the round to nearest even into T (bf16 or f32) and the residual's
// sum rounded once more: what the plain version in PyTorch computes
// (ops/frozen_bn.py, frozen_bn_act_plain), every product and sum rounded on
// its own (--fmad=false). PyTorch computes a bf16 op in f32 and rounds the
// result to bf16; the product or sum of two bf16 values rounded to f32 and
// then to bf16 is the exact result rounded to bf16 once (f32's 24 bits are
// more than twice bf16's 8 plus 2, so the double rounding is innocuous), so
// bf16 vectors take the card's bf16x2 instructions (mul.rn, add.rn): the
// same bits without a conversion an element. act is ReLU as PyTorch's
// clamp_min writes it on the card: NaN kept, else max(v, 0).
//
// Layouts: channels_last (NHWC memory) or contiguous NCHW, x, r and y with
// the same strides; the wrapper checks them. Nothing is cached between
// calls: w and b are folded from the buffers in every launch, so a buffer
// changed in place after a CUDA graph was captured is read at replay.
//
// Bound on the H100: bytes. An element reads 2 bytes of bf16 x (and 2 of
// r) and writes 2 of y; the folding is a few operations a channel. At the
// 832x1344 bucket and batch 1 R50's 49 launches move ~1.06 GB, ~0.32 ms at
// 3.35 TB/s. The design moves 16 bytes a thread a load (8 bf16 or 4 f32
// values), in a grid-stride loop over as many blocks as the SMs hold at
// once; a thread issues its first loads before the folding, so their
// latency and the folding's overlap, and holds one vector at a time (two or
// four, loaded before the first store, measured slower on the H100: the
// registers cost more blocks an SM than the loads in flight gain):
//   * channels_last: a block is (tx channel groups) x (ty positions); a
//     warp's lanes hold neighbouring 16-byte channel groups, so a warp reads
//     whole lines. A block touches at most 32 groups (256 bf16 channels): it
//     folds their w and b once, one channel a thread, into shared memory,
//     and each thread keeps its own channels' (in T) in registers while it
//     walks the positions.
//   * NCHW: blockIdx.y walks the (n, c) planes, the block's threads the
//     plane's vectors, each thread with the plane's one w and b.
// Where C (NHWC) or H * W (NCHW) is no multiple of the vector width, or a
// pointer is not 16-byte aligned, the same kernel runs one element a load,
// in f32 arithmetic rounded to T after each operation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerBlock = 32;  // channel groups of one block (NHWC): one warp's width

enum Residual { kNone = 0, kIdentity = 1, kFrozenBN = 2 };

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float widen(float v) { return v; }
  __device__ static float narrow(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 narrow(float v) { return __float2bfloat16_rn(v); }  // RNE, as c10 on sm_80+
};

// v rounded to T, as an f32 again
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Elem<T>::widen(Elem<T>::narrow(v));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

struct Params {
  const void* x;
  const void* r;
  void* y;
  const float *scale, *bias, *mean, *var;
  float eps;
  const float *r_scale, *r_bias, *r_mean, *r_var;
  float r_eps;
  int64_t N, C, HW;
  int residual, relu;
};

// A vector's channels' w and b (and the residual's), in T
template <typename T, int kVec>
struct Folds {
  Pack<T, kVec> w, b, wr, br;
};

// w = scale / sqrt(var + eps), b = bias - mean * w, in f32 as PyTorch's ops
// compute them, then each rounded to T
template <typename T>
__device__ __forceinline__ void fold(const float* scale, const float* bias, const float* mean, const float* var,
                                     float eps, int64_t c, T& w_out, T& b_out) {
  const float w = __fdiv_rn(scale[c], __fsqrt_rn(__fadd_rn(var[c], eps)));
  const float b = __fsub_rn(bias[c], __fmul_rn(mean[c], w));
  w_out = Elem<T>::narrow(w);
  b_out = Elem<T>::narrow(b);
}

// channel c's folds into slot i of w, b (and of wr, br for a residual with
// its own FrozenBN)
template <typename T>
__device__ __forceinline__ void fold_channel(const Params& p, int64_t c, T* w, T* b, T* wr, T* br, int i) {
  fold<T>(p.scale, p.bias, p.mean, p.var, p.eps, c, w[i], b[i]);
  if (p.residual == kFrozenBN) fold<T>(p.r_scale, p.r_bias, p.r_mean, p.r_var, p.r_eps, c, wr[i], br[i]);
}

// One element in f32 arithmetic, rounded to T after each operation
template <typename T>
__device__ __forceinline__ T finish(T x, T r, T w, T b, T wr, T br, int residual, int relu) {
  const auto affine = [](T x, T w, T b) {
    return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(Elem<T>::widen(x), Elem<T>::widen(w))), Elem<T>::widen(b)));
  };
  float v = affine(x, w, b);
  if (residual == kFrozenBN) {
    v = rnd<T>(__fadd_rn(v, affine(r, wr, br)));
  } else if (residual == kIdentity) {
    v = rnd<T>(__fadd_rn(v, Elem<T>::widen(r)));
  }
  if (relu && !isnan(v)) v = fmaxf(v, 0.0f);  // clamp_min(v, 0): NaN stays
  return Elem<T>::narrow(v);
}

// Two bf16 lanes at once, each operation the bf16 instruction's one rounding
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// max(v, 0) a lane, NaN for a NaN lane
__device__ __forceinline__ uint32_t relu2(uint32_t a) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> finish_vector(const Pack<T, kVec>& x, const Pack<T, kVec>& r,
                                                       const Folds<T, kVec>& f, int residual, int relu) {
  Pack<T, kVec> y;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && kVec % 2 == 0) {
    const auto u = [](const Pack<T, kVec>& v) { return reinterpret_cast<const uint32_t*>(v.v); };
    uint32_t* out = reinterpret_cast<uint32_t*>(y.v);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      uint32_t v = add2(mul2(u(x)[k], u(f.w)[k]), u(f.b)[k]);
      if (residual == kFrozenBN) {
        v = add2(v, add2(mul2(u(r)[k], u(f.wr)[k]), u(f.br)[k]));
      } else if (residual == kIdentity) {
        v = add2(v, u(r)[k]);
      }
      out[k] = relu ? relu2(v) : v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      y.v[k] = finish<T>(x.v[k], r.v[k], f.w.v[k], f.b.v[k], f.wr.v[k], f.br.v[k], residual, relu);
  }
  return y;
}

// The vectors base + i * stride (in elements) for i = first, first + step,
// ... < count: kVec values each from x (and r) to y. The first vector's
// loads are issued before ready(), which every thread calls once and which
// gives the folds.
template <typename T, int kVec, typename Ready>
__device__ __forceinline__ void walk(const Params& p, int64_t base, int64_t stride, int64_t first, int64_t count,
                                     int64_t step, Ready ready) {
  using V = Pack<T, kVec>;
  const V* x = reinterpret_cast<const V*>(static_cast<const T*>(p.x) + base);
  const V* r = reinterpret_cast<const V*>(static_cast<const T*>(p.r) + base);
  V* y = reinterpret_cast<V*>(static_cast<T*>(p.y) + base);
  const int64_t vstride = stride / kVec;  // stride is a multiple of kVec
  V xv, rv;
  const auto load = [&](int64_t i) {
    if (i < count) {
      xv = x[i * vstride];
      rv = p.residual != kNone ? r[i * vstride] : xv;
    }
  };
  load(first);
  const Folds<T, kVec> f = ready();
  for (int64_t i = first; i < count; i += step) {
    y[i * vstride] = finish_vector<T, kVec>(xv, rv, f, p.residual, p.relu);
    load(i + step);
  }
}

// channels_last: threadIdx.x a group of kVec channels (blockIdx.y the block
// of groups), threadIdx.y a position
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) frozen_bn_act_nhwc(Params p) {
  using V = Pack<T, kVec>;
  __shared__ V s_w[kGroupsPerBlock], s_b[kGroupsPerBlock], s_wr[kGroupsPerBlock], s_br[kGroupsPerBlock];
  const int64_t c_begin = int64_t(blockIdx.y) * blockDim.x * kVec;
  const int64_t c0 = c_begin + int64_t(threadIdx.x) * kVec;
  const int64_t count = c0 < p.C ? p.N * p.HW : 0;  // the positions, for a thread with channels
  const auto ready = [&] {
    const int64_t block_channels = int64_t(blockDim.x) * kVec;
    const int64_t channels = p.C - c_begin < block_channels ? p.C - c_begin : block_channels;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < channels; i += blockDim.x * blockDim.y)
      fold_channel<T>(p, c_begin + i, s_w[0].v, s_b[0].v, s_wr[0].v, s_br[0].v, i);  // one slot a channel
    __syncthreads();
    Folds<T, kVec> f;
    if (c0 < p.C) f = {s_w[threadIdx.x], s_b[threadIdx.x], s_wr[threadIdx.x], s_br[threadIdx.x]};
    return f;
  };
  walk<T, kVec>(p, c0, p.C, int64_t(blockIdx.x) * blockDim.y + threadIdx.y, count, int64_t(gridDim.x) * blockDim.y,
                ready);
}

// contiguous NCHW: blockIdx.y walks the (n, c) planes, the block's threads
// a plane's vectors
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) frozen_bn_act_nchw(Params p) {
  const int64_t vectors = p.HW / kVec, planes = p.N * p.C;
  for (int64_t plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const auto ready = [&] {
      T w, b, wr, br;
      fold_channel<T>(p, plane % p.C, &w, &b, &wr, &br, 0);
      Folds<T, kVec> f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        f.w.v[k] = w;
        f.b.v[k] = b;
        f.wr.v[k] = wr;
        f.br.v[k] = br;
      }
      return f;
    };
    walk<T, kVec>(p, plane * p.HW, kVec, int64_t(blockIdx.x) * blockDim.x + threadIdx.x, vectors,
                  int64_t(gridDim.x) * blockDim.x, ready);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// blocks of kThreads threads of kernel that one SM holds at once
template <typename Kernel>
int64_t resident(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess) {
    cudaGetLastError();  // not this launch's fault: one block an SM, and the launch reports its own
    n = 1;
  }
  return n > 0 ? n : 1;
}

// as many blocks as the SMs hold at once (fewer for a small tensor), each
// walking its share of the rest
template <typename T, int kVec>
cudaError_t launch(const Params& p, bool channels_last, int sms, cudaStream_t stream) {
  if (channels_last) {
    static const int64_t per_sm = resident(frozen_bn_act_nhwc<T, kVec>);
    const int64_t most = sms * per_sm;
    const int64_t groups = p.C / kVec;
    const int tx = int(groups < kGroupsPerBlock ? groups : kGroupsPerBlock), ty = kThreads / tx;
    const int64_t gy = ceil_div(groups, tx);
    int64_t gx = ceil_div(p.N * p.HW, ty), cap = most / gy > 1 ? most / gy : 1;
    if (gx > cap) gx = cap;
    frozen_bn_act_nhwc<T, kVec><<<dim3(unsigned(gx), unsigned(gy)), dim3(tx, ty), 0, stream>>>(p);
  } else {
    static const int64_t per_sm = resident(frozen_bn_act_nchw<T, kVec>);
    const int64_t most = sms * per_sm;
    const int64_t planes = p.N * p.C;
    const int64_t gy = planes < 65535 ? planes : 65535;
    int64_t gx = ceil_div(p.HW / kVec, kThreads), cap = most / gy > 1 ? most / gy : 1;
    if (gx > cap) gx = cap;
    frozen_bn_act_nchw<T, kVec><<<dim3(unsigned(gx), unsigned(gy)), kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, bool channels_last, bool vectorized, int sms, cudaStream_t stream) {
  return vectorized ? launch<T, Elem<T>::kVec>(p, channels_last, sms, stream)
                    : launch<T, 1>(p, channels_last, sms, stream);
}

}  // namespace

extern "C" {

// x, r, y: (N, C, H, W) in T, with the same strides (channels_last when
// channels_last is 1, else contiguous); r is read when residual is 1
// (identity) or 2 (its own FrozenBN, from the r_* buffers). Buffers: (C,)
// f32. bf16: T is bf16, else f32. vectorized: the wrapper found C
// (channels_last) or HW (NCHW) a multiple of 16 bytes' values and every
// pointer 16-byte aligned. Returns a cudaError_t, 0 on success.
int frozen_bn_act(const void* x, const void* r, void* y, const float* scale, const float* bias, const float* mean,
                  const float* var, float eps, const float* r_scale, const float* r_bias, const float* r_mean,
                  const float* r_var, float r_eps, int64_t N, int64_t C, int64_t HW, int bf16, int channels_last,
                  int residual, int relu, int vectorized, void* stream) {
  if (N * C * HW == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Params p{x, r, y, scale, bias, mean, var, eps, r_scale, r_bias, r_mean, r_var, r_eps, N, C, HW, residual,
                 relu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(p, channels_last, vectorized, sms, s)
              : dispatch<float>(p, channels_last, vectorized, sms, s);
}

const char* cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
