// MViT's attention pooling of q, k and v in one pass, for Hopper (sm_90a):
// the split of the qkv Linear's output, the depthwise 3x3 convolution, the
// LayerNorm over the head width and, in windowed blocks, the window cut.
//
// Replaces no TPU kernel: the JAX package has no MViT. PyTorch ran the
// pooling (ops/mvit_pool.py, mvit_pool_norm_plain, as models/mvit.py
// composed it) as five passes over the same data: a copy of the Linear's
// whole output into (3, B * heads, H, W, d), cuDNN's depthwise convolution,
// LayerNorm over rows of d = 72 floats (PyTorch's kernel gives each row a
// block of 128 threads, 18 of which load), and _window_partition's zero pad
// and window copy. This kernel is those passes as one, launched by
// ops/mvit_pool.py (operator openset_rcnn::mvit_pool_norm) once a block of
// models/mvit.py.
//
// Per output token (tensor t of q, k, v; image b; head j; pooled position
// (y, x)) and channel c < d, with s the tensor's stride:
//   p_c = sum over the 3x3 taps (a, e) of w[c, a, e] * in[s*y - 1 + a, s*x - 1 + e, t, j, c]
//         (zero outside the grid), each tap one f32 fused multiply-add
//   mean = sum_c p_c * (1/d), var = sum_c (p_c - mean)^2 * (1/d) (the
//   centred sum, both in f32), out_c = (p_c - mean) * (rsqrt(var + eps) *
//   scale_c) + bias_c
// written at the token's window position (windowed) or its grid position
// (global); positions of a window beyond the pooled grid are written as
// zeros. The plain version sums in cuDNN's and PyTorch's orders, so the two
// agree to f32 rounding, not bit for bit.
//
// Bound on the H100: bytes. MViTv2-L's 48 launches at 832x1344 and batch 8
// read the Linear's output once (16.5 GB; 15.8 GB of it are rows and columns
// a tap reads) and write the windowed q, k and v once (13.0 GB): ~8.6 ms at
// 3.35 TB/s, against ~9 multiply-adds and ~10 more operations an output
// value. Measured, the arithmetic and the shared-memory reads around it are
// what hold a design back once the loads are in flight, so the design moves
// each byte once and spends few instructions a value:
//   * one launch a block: the grid's x runs over (tile, tensor, head), the
//     heads fastest, its y over the images;
//   * a block stages its tile's input halo for one head into shared memory
//     (at most 48 KB, so no opt-in) with cp.async copies: 16 bytes a thread,
//     consecutive threads on consecutive bytes of a token's d contiguous
//     channels, zero fill outside the grid, no register on the way, all in
//     flight at once; at stride 4 it stages only the rows and columns the
//     3x3 taps read;
//   * a token's channels sit on a group of G = 16 lanes (32 above d = 192),
//     c = lane + G * k, each lane with its channels' nine weights, scale and
//     bias in registers; a group computes two neighbouring tokens of a row
//     at a time, reading each staged column of their windows once (at
//     stride 1, 12 reads for 18 taps); the two sums of the statistics
//     reduce over the group by warp shuffles, with no block barrier a token;
//     a staged position's pitch is chosen so a warp's two groups start in
//     distinct banks;
//   * each output value is written once; no atomics, so a launch repeats
//     bit for bit, and a graph replay equals the eager call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPair = 2;     // neighbouring tokens of a row a group computes at a time
constexpr int kKernel = 3;   // the pooling kernel's side
constexpr int kTaps = kKernel * kKernel;
constexpr int kPad = kKernel / 2;
constexpr int kMaxTileH = 64, kMaxTileW = 32;     // a tile's output rows and columns, at most
constexpr int kMaxStaged = (kMaxTileW - 1) * kKernel + kKernel;  // staged columns, at most (96)
// the staged halo's most: with the tables below, within the 48 KB a block has without the opt-in
constexpr int kSmemBytes = 48 * 1024 - (kMaxStaged + kMaxTileH + kMaxTileW) * 4;

// q, or k and v: the tensor's stride, window and grids, and a block's tile
struct Part {
  int stride, window;    // window 0: global
  int out_h, out_w;      // the pooled grid
  int cover_h, cover_w;  // the grid written: the pooled grid, padded to whole windows
  int tile_h, tile_w;    // output tokens a block: tile_h x tile_w
  int stage_h, stage_w;  // input positions it stages
  int pitch;             // floats a staged position (>= d, a multiple of 4)
  int tiles_x, tiles;    // tiles a row of the cover, and an image x head
};

struct Params {
  const float* qkv;  // (B, H, W, 3, heads, d)
  float* out[3];
  const float* weight[3];  // (d, 1, 3, 3)
  const float* scale[3];
  const float* bias[3];
  float eps;
  int H, W, heads, d;
  int same_tiles;  // q's stride and window are k's and v's
  Part part[2];    // q; k and v
};

// staged rows (or columns) a step of one output: the stride, where
// neighbouring outputs' taps overlap, else the three taps
__host__ __device__ __forceinline__ int rows_a_step(int stride) { return stride < kKernel ? stride : kKernel; }

__host__ __device__ __forceinline__ int staged_side(int tile, int stride) {
  return (tile - 1) * rows_a_step(stride) + kKernel;
}

// The input row (or column) of staged row i of a tile whose first output
// row is first
__device__ __forceinline__ int staged_index(int first, int i, int stride) {
  const int sr = rows_a_step(stride);
  return (first + i / sr) * stride - kPad + i % sr;
}

// 16 bytes from global to shared memory without a register (cp.async, L1
// bypassed); zeros where !in
__device__ __forceinline__ void copy16(float4* dst, const float* src, bool in) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(in ? 16 : 0));
}

// What a block's rounds read: its staged halo, its output and where each
// token goes (row index = out_base + orow[tile row] + ocol[tile column])
struct Tile {
  const float* xs;
  float* out;
  int64_t out_base;
  const int *orow, *ocol;
  int ty0, tx0, tile_shift, group, lane;
  float inv_d;
};

// The tile's tokens, kPair neighbours of one row a group a round, SR the
// staged columns a step of one output: the group reads each staged column
// of their 3x3 windows once and adds it to every token whose taps read it
template <int G, int NC, int SR>
__device__ __forceinline__ void tile_tokens(const Params& p, const Part& a, const Tile& tl,
                                            const float (&w)[kTaps][NC], const float (&gamma)[NC],
                                            const float (&beta)[NC]) {
  constexpr int kGroups = kThreads / G, kCols = (kPair - 1) * SR + kKernel;
  const int d = p.d, lane = tl.lane, n_out = a.tile_h * a.tile_w;
  // every thread runs every round, so each warp's shuffles see all its lanes
  for (int o0 = 0; o0 < n_out; o0 += kGroups * kPair) {
    const int o = o0 + tl.group * kPair;  // the tile is a whole number of pairs wide
    const int ly = o >> tl.tile_shift, lx = o & (a.tile_w - 1);
    const int oy = tl.ty0 + ly;
    bool store[kPair], valid[kPair];
    float acc[kPair][NC];
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      const int ox = tl.tx0 + lx + q;
      store[q] = o < n_out && oy < a.cover_h && ox < a.cover_w;
      valid[q] = store[q] && oy < a.out_h && ox < a.out_w;
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[q][k] = 0.f;
    }
    if (valid[0]) {  // else neither token has data
#pragma unroll
      for (int ky = 0; ky < kKernel; ++ky) {
        const float* row = tl.xs + ((ly * SR + ky) * a.stage_w + lx * SR) * a.pitch + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float x[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) x[k] = lane + G * k < d ? row[c * a.pitch + G * k] : 0.f;
#pragma unroll
          for (int q = 0; q < kPair; ++q) {
            const int kx = c - q * SR;
            if (kx >= 0 && kx < kKernel) {
#pragma unroll
              for (int k = 0; k < NC; ++k) acc[q][k] = __fmaf_rn(x[k], w[ky * kKernel + kx][k], acc[q][k]);
            }
          }
        }
      }
    }
    float s1[kPair], s2[kPair], mean[kPair];
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      s1[q] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (lane + G * k < d) s1[q] = __fadd_rn(s1[q], acc[q][k]);
    }
#pragma unroll
    for (int m = 1; m < G; m <<= 1)
#pragma unroll
      for (int q = 0; q < kPair; ++q) s1[q] = __fadd_rn(s1[q], __shfl_xor_sync(0xffffffffu, s1[q], m));
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      mean[q] = __fmul_rn(s1[q], tl.inv_d);
      s2[q] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float dv = __fsub_rn(acc[q][k], mean[q]);
        if (lane + G * k < d) s2[q] = __fmaf_rn(dv, dv, s2[q]);
      }
    }
#pragma unroll
    for (int m = 1; m < G; m <<= 1)
#pragma unroll
      for (int q = 0; q < kPair; ++q) s2[q] = __fadd_rn(s2[q], __shfl_xor_sync(0xffffffffu, s2[q], m));
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      if (!store[q]) continue;
      const float rstd = rsqrtf(__fmaf_rn(s2[q], tl.inv_d, p.eps));
      float* dst = tl.out + (tl.out_base + tl.orow[ly] + tl.ocol[lx + q]) * d + lane;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (lane + G * k < d)
          dst[G * k] = valid[q] ? __fmaf_rn(__fsub_rn(acc[q][k], mean[q]), __fmul_rn(rstd, gamma[k]), beta[k]) : 0.f;
    }
  }
}

// G lanes a token, NC channels a lane (c = lane + G * k, those >= d idle)
template <int G, int NC>
__global__ void __launch_bounds__(kThreads) mvit_pool_norm_kernel(const Params p) {
  extern __shared__ float4 staged[];
  __shared__ int s_col[kMaxStaged];  // the input column of each staged column, -1 outside the grid
  __shared__ int s_orow[kMaxTileH], s_ocol[kMaxTileW];  // each tile row's and column's share of a token's row index
  // blockIdx.x: (tile, tensor, head), the heads fastest, then the tensors
  // where q's tiles are k's and v's
  int tile = blockIdx.x / p.heads, t = 0;
  const int j = blockIdx.x - tile * p.heads;
  if (p.same_tiles) {
    t = tile % 3;
    tile /= 3;
  } else if (tile >= p.part[0].tiles) {
    tile -= p.part[0].tiles;
    t = 1 + tile / p.part[1].tiles;
    tile %= p.part[1].tiles;
  }
  const Part a = t == 0 ? p.part[0] : p.part[1];
  const float* weight = t == 0 ? p.weight[0] : t == 1 ? p.weight[1] : p.weight[2];
  const float* scale = t == 0 ? p.scale[0] : t == 1 ? p.scale[1] : p.scale[2];
  const float* bias = t == 0 ? p.bias[0] : t == 1 ? p.bias[1] : p.bias[2];
  float* out = t == 0 ? p.out[0] : t == 1 ? p.out[1] : p.out[2];
  const int d = p.d, b = blockIdx.y, bh = b * p.heads + j;
  const int ty0 = (tile / a.tiles_x) * a.tile_h, tx0 = (tile % a.tiles_x) * a.tile_w;

  const int64_t C = int64_t(3) * p.heads * d;
  const float* src = p.qkv + int64_t(b) * p.H * p.W * C + int64_t(t * p.heads + j) * d;
  for (int sx = threadIdx.x; sx < a.stage_w; sx += kThreads) {
    const int ix = staged_index(tx0, sx, a.stride);
    s_col[sx] = ix >= 0 && ix < p.W ? ix : -1;
  }
  // output row index: windows of ww x ww in _window_partition's order, or the grid's rows
  const int ww = a.window ? a.window : 1;
  for (int i = threadIdx.x; i < a.tile_h; i += kThreads) {
    const int oy = ty0 + i;
    s_orow[i] = a.window ? (oy / ww) * (a.cover_w / ww) * ww * ww + (oy % ww) * ww : oy * a.out_w;
  }
  for (int i = threadIdx.x; i < a.tile_w; i += kThreads) {
    const int ox = tx0 + i;
    s_ocol[i] = a.window ? (ox / ww) * ww * ww + ox % ww : ox;
  }
  const int64_t out_base = int64_t(bh) * a.cover_h * a.cover_w;
  __syncthreads();

  // the halo, a warp a staged row: the row's columns' channel vectors in the
  // order they lie in memory, stepped without a division a vector
  const int vecs = d / 4, pitch_vecs = a.pitch / 4, row_vecs = a.stage_w * vecs;
  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
  const int sx0 = lane32 / vecs, v0 = lane32 - sx0 * vecs, step_sx = 32 / vecs, step_v = 32 - step_sx * vecs;
  for (int sy = warp; sy < a.stage_h; sy += kThreads / 32) {
    const int iy = staged_index(ty0, sy, a.stride);
    const bool row_in = iy >= 0 && iy < p.H;
    const float* row = src + int64_t(row_in ? iy : 0) * p.W * C;
    float4* dst = staged + sy * a.stage_w * pitch_vecs;
    int sx = sx0, v = v0;
#pragma unroll 4
    for (int e = lane32; e < row_vecs; e += 32) {
      const int ix = s_col[sx];
      const bool in = row_in && ix >= 0;
      copy16(dst + sx * pitch_vecs + v, in ? row + int64_t(ix) * C + 4 * v : src, in);
      sx += step_sx;
      v += step_v;
      if (v >= vecs) {
        v -= vecs;
        ++sx;
      }
    }
  }

  // this lane's channels: weights, scale and bias in registers, loaded while the copies fly
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  float w[kTaps][NC], gamma[NC], beta[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + G * k;
    const bool on = c < d;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) w[tap][k] = on ? __ldg(weight + c * kTaps + tap) : 0.f;
    gamma[k] = on ? __ldg(scale + c) : 0.f;
    beta[k] = on ? __ldg(bias + c) : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const Tile tl{reinterpret_cast<const float*>(staged), out, out_base, s_orow, s_ocol, ty0, tx0,
                __ffs(a.tile_w) - 1, group, lane, 1.f / float(d)};
  if (a.stride == 1) {
    tile_tokens<G, NC, 1>(p, a, tl, w, gamma, beta);
  } else if (a.stride == 2) {
    tile_tokens<G, NC, 2>(p, a, tl, w, gamma, beta);
  } else {
    tile_tokens<G, NC, 3>(p, a, tl, w, gamma, beta);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A staged position's floats: at least d, a multiple of 4 (16-byte copies),
// and, where one is found, such that the 32 / G groups of a warp (kPair
// outputs, kPair steps of the stride, apart) start in distinct banks, G
// apart: then a warp's 4-byte loads of one column hit 32 banks.
int pitch_for(int d, int stride, int G) {
  const int step = kPair * rows_a_step(stride), groups = 32 / G;
  for (int pitch = d; pitch < d + 32; pitch += 4) {
    unsigned banks = 0;
    bool ok = true;
    for (int m = 0; m < groups && ok; ++m) {
      const int first = (m * step * pitch) % 32;
      ok = first % G == 0 && !(banks >> first & 1u);
      banks |= 1u << first;
    }
    if (ok) return pitch;
  }
  return d;
}

// The tile of most outputs whose halo fits kSmemBytes (ties: fewer staged
// positions), a power of two wide (at least 4: a warp's groups in one row),
// no larger than the grid it covers needs
void choose_tile(Part& a, int d, int G) {
  a.pitch = pitch_for(d, a.stride, G);
  const int most = kSmemBytes / (a.pitch * 4);
  int best = 0, best_staged = 0;
  a.tile_h = 1;
  a.tile_w = 4;
  for (int tw = 4; tw <= kMaxTileW; tw *= 2) {
    if (tw > 4 && tw / 2 >= a.cover_w) break;
    for (int th = 1; th <= kMaxTileH && th <= a.cover_h; ++th) {
      const int staged = staged_side(th, a.stride) * staged_side(tw, a.stride);
      if (staged > most) break;
      if (th * tw > best || (th * tw == best && staged < best_staged)) {
        best = th * tw;
        best_staged = staged;
        a.tile_h = th;
        a.tile_w = tw;
      }
    }
  }
  a.stage_h = staged_side(a.tile_h, a.stride);
  a.stage_w = staged_side(a.tile_w, a.stride);
  a.tiles_x = ceil_div(a.cover_w, a.tile_w);
  a.tiles = a.tiles_x * ceil_div(a.cover_h, a.tile_h);
}

Part make_part(int H, int W, int stride, int window, int d, int G) {
  Part a{};
  a.stride = stride;
  a.window = window;
  a.out_h = (H + 2 * kPad - kKernel) / stride + 1;
  a.out_w = (W + 2 * kPad - kKernel) / stride + 1;
  a.cover_h = window ? ceil_div(a.out_h, window) * window : a.out_h;
  a.cover_w = window ? ceil_div(a.out_w, window) * window : a.out_w;
  choose_tile(a, d, G);
  return a;
}

template <int G, int NC>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int blocks = (p.part[0].tiles + 2 * p.part[1].tiles) * p.heads;
  size_t smem = 0;
  for (const Part& a : p.part) {
    const size_t bytes = size_t(a.stage_h) * a.stage_w * a.pitch * sizeof(float);
    smem = bytes > smem ? bytes : smem;
  }
  mvit_pool_norm_kernel<G, NC><<<dim3(unsigned(blocks), unsigned(batch)), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// G = 16 lanes a token up to d = 192, 32 up to 256; NC rounded up to one of
// five instantiated widths (5 for d = 72), each built for the three column
// steps, so the library builds in seconds
int lanes_for(int d) { return d <= 192 ? 16 : 32; }

cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  const int d = p.d;
  if (d <= 16) return launch<16, 1>(p, batch, stream);
  if (d <= 80) return launch<16, 5>(p, batch, stream);
  if (d <= 128) return launch<16, 8>(p, batch, stream);
  if (d <= 192) return launch<16, 12>(p, batch, stream);
  return launch<32, 8>(p, batch, stream);
}

}  // namespace

extern "C" {

// qkv: (B, H, W, 3 * heads * d) f32, contiguous, 16-byte aligned; q, k, v:
// (B * heads * windows, window^2, d) where the window is positive, else
// (B * heads, H' * W', d); weights (d, 1, 3, 3), scales and biases (d,), f32.
// d a multiple of 4 up to 256, strides 1 to 4, both windows 0 or both
// positive, B <= 65535: the wrapper checks them, and this returns
// cudaErrorInvalidValue where they do not hold. Returns a cudaError_t, 0 on
// success.
int mvit_pool_norm(const float* qkv, float* q, float* k, float* v, const float* w_q, const float* w_k,
                   const float* w_v, const float* s_q, const float* b_q, const float* s_k, const float* b_k,
                   const float* s_v, const float* b_v, float eps, int B, int H, int W, int heads, int d, int stride_q,
                   int stride_kv, int q_window, int kv_window, void* stream) {
  if (d % 4 || d < 4 || d > 256 || stride_q < 1 || stride_q > 4 || stride_kv < 1 || stride_kv > 4 ||
      q_window < 0 || kv_window < 0 || (q_window == 0) != (kv_window == 0) || B > 65535)
    return cudaErrorInvalidValue;
  if (int64_t(B) * heads * H * W == 0) return 0;
  const int G = lanes_for(d);
  Params p{};
  p.qkv = qkv;
  p.out[0] = q;
  p.out[1] = k;
  p.out[2] = v;
  p.weight[0] = w_q;
  p.weight[1] = w_k;
  p.weight[2] = w_v;
  p.scale[0] = s_q;
  p.scale[1] = s_k;
  p.scale[2] = s_v;
  p.bias[0] = b_q;
  p.bias[1] = b_k;
  p.bias[2] = b_v;
  p.eps = eps;
  p.H = H;
  p.W = W;
  p.heads = heads;
  p.d = d;
  p.part[0] = make_part(H, W, stride_q, q_window, d, G);
  p.part[1] = make_part(H, W, stride_kv, kv_window, d, G);
  p.same_tiles = stride_q == stride_kv && q_window == kv_window;
  return dispatch(p, B, static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
