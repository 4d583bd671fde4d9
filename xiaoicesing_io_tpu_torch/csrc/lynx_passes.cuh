// The LYNXNet conv module's memory-bound passes and its SwiGLU epilogue, shared by K1
// (csrc/lynx_conv.cu) and K5 / K7 (csrc/lynx_layer.cu); sm_90a.
//
//   layer_norm_kernel      LayerNorm over the rows a Rows functor yields (f32, two passes, one
//                          warp a row), written as bf16 xn: K1's rows are its bf16 input, K5's and
//                          K7's the layer's f32 h = bf16(x + cond) + step[b] (LayerRows);
//   SwigluEpi              the paired product's epilogue: b_in, SwiGLU, f32 u;
//   dwconv_prelu_kernel    depthwise conv over time (k <= 33) + bias + PReLU over f32 u, rows
//                          outside [0, T) read as zero, written as bf16 act.
//
// Internal linkage, as in sm90_gemm.cuh: both libraries include this header.

#pragma once

#include "sm90_gemm.cuh"

namespace lynx_passes {
namespace {

constexpr int kMaxTaps = 33;
constexpr int kLnWarps = 8;     // rows per LayerNorm block
constexpr int kDwCh = 64;       // channels per conv block
constexpr int kDwRun = 32;      // rows per conv thread
constexpr int kDwRuns = 2;      // row runs per conv block
constexpr int kDwRows = kDwRuns * kDwRun;
constexpr int kDwStaged = kDwRows + kMaxTaps - 1;
constexpr int kDwThreads = kDwRuns * kDwCh;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K1's LayerNorm input: row `row` of bf16 [rows, dim]; (row, i) yields columns 2i, 2i + 1.
struct Bf16Rows {
  const __nv_bfloat16* x;
  int dim;
  __device__ __forceinline__ float2 operator()(int row, int i) const {
    return __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * dim)[i]);
  }
};

// K5's and K7's: h = res + step[b] in f32, res = bf16(x + cond) (rounded once, as the plain
// version rounds it), row = b * T + t. h itself is never rounded.
struct LayerRows {
  const __nv_bfloat16* x;
  const __nv_bfloat16* cond;
  const float* step;  // [B, dim]
  int T;
  int dim;
  __device__ __forceinline__ float2 operator()(int row, int i) const {
    const size_t o = (size_t)row * dim;
    const float2 xv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(x + o)[i]);
    const float2 cv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(cond + o)[i]);
    const float2 s = reinterpret_cast<const float2*>(step + (size_t)(row / T) * dim)[i];
    const float2 res = __bfloat1622float2(__floats2bfloat162_rn(xv.x + cv.x, xv.y + cv.y));
    return make_float2(res.x + s.x, res.y + s.y);
  }
};

template <class Rows>
__global__ void __launch_bounds__(32 * kLnWarps) layer_norm_kernel(
    const Rows in, const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ xn, int rows, int dim) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int pairs = dim / 2;
  float s = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = in(row, i);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / dim;
  float q = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = in(row, i);
    q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / dim + 1e-5f);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(xn + (size_t)row * dim);
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = in(row, i);
    const float2 sc = *reinterpret_cast<const float2*>(scale + 2 * i);
    const float2 bi = *reinterpret_cast<const float2*>(bias + 2 * i);
    out[i] = __floats2bfloat162_rn((v.x - mean) * rstd * sc.x + bi.x,
                                   (v.y - mean) * rstd * sc.y + bi.y);
  }
}

template <class Rows>
inline cudaError_t layer_norm(const Rows& in, const void* scale, const void* bias, void* xn,
                              int rows, int dim, cudaStream_t s) {
  layer_norm_kernel<Rows><<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, s>>>(
      in, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(xn), rows, dim);
  return cudaGetLastError();
}

// u = (out + b_in[:inner]) * silu(gate + b_in[inner:]) of one paired column, f32 [rows, inner].
// silu through the fast exponential and division: the epilogue's arithmetic is on the products'
// critical path, and their error (a few f32 ulp) is far below the bf16 rounding of act.
struct SwigluEpi {
  using Out = float;
  using Pair = float2;
  const float* b_in;  // [2 * inner], [out | gate]
  float* u;
  int inner;
  __device__ __forceinline__ Pair value(int, int, int j, float o0, float o1, float g0,
                                        float g1) const {
    const float2 bo = *reinterpret_cast<const float2*>(b_in + j);
    const float2 bg = *reinterpret_cast<const float2*>(b_in + inner + j);
    g0 += bg.x;
    g1 += bg.y;
    return make_float2((o0 + bo.x) * __fdividef(g0, 1.f + __expf(-g0)),
                       (o1 + bo.y) * __fdividef(g1, 1.f + __expf(-g1)));
  }
  __device__ __forceinline__ float* row(int, int r) const { return u + (size_t)r * inner; }
};

__global__ void __launch_bounds__(kDwThreads) dwconv_prelu_kernel(
    const float* __restrict__ u,        // [B, T, inner]
    const float* __restrict__ dw,       // [k, inner]
    const float* __restrict__ dw_bias,  // [inner]
    const float* __restrict__ alpha,    // [inner]
    __nv_bfloat16* __restrict__ act,    // [B, T, inner]
    int T, int inner, int k, int pad_l) {
  __shared__ __align__(16) float su[kDwStaged * kDwCh];
  const int c0 = blockIdx.x * kDwCh;
  const int t0 = blockIdx.y * kDwRows;
  const int b = blockIdx.z;
  const float* ub = u + (size_t)b * T * inner;
  const int staged = kDwRows + k - 1;  // rows past it meet zero taps only; they are zeroed
  // unrolled, so that a thread's loads are in flight together
#pragma unroll
  for (int v = threadIdx.x; v < kDwStaged * (kDwCh / 4); v += kDwThreads) {
    const int r = v / (kDwCh / 4);
    const int q = (v % (kDwCh / 4)) * 4;
    const int t = t0 - pad_l + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < staged && t >= 0 && t < T) {
      val = *reinterpret_cast<const float4*>(ub + (size_t)t * inner + c0 + q);
    }
    *reinterpret_cast<float4*>(su + r * kDwCh + q) = val;
  }
  const int j = threadIdx.x % kDwCh;
  const int run = threadIdx.x / kDwCh;
  float w[kMaxTaps];
#pragma unroll
  for (int tap = 0; tap < kMaxTaps; ++tap) w[tap] = tap < k ? dw[(size_t)tap * inner + c0 + j] : 0.f;
  __syncthreads();

  // out[rr] = sum over tap of staged[rr + tap] * w[tap], taps in ascending order as in the plain
  // version; staged row i feeds out[rr] through tap i - rr.
  float acc[kDwRun];
#pragma unroll
  for (int rr = 0; rr < kDwRun; ++rr) acc[rr] = 0.f;
  const float* col = su + run * kDwRun * kDwCh + j;
#pragma unroll
  for (int i = 0; i < kDwRun + kMaxTaps - 1; ++i) {
    const float v = col[i * kDwCh];
#pragma unroll
    for (int rr = 0; rr < kDwRun; ++rr) {
      if (i - rr >= 0 && i - rr < kMaxTaps) acc[rr] = fmaf(v, w[i - rr], acc[rr]);
    }
  }
  const float bias = dw_bias[c0 + j];
  const float a = alpha[c0 + j];
  __nv_bfloat16* ab = act + (size_t)b * T * inner + c0 + j;
#pragma unroll
  for (int rr = 0; rr < kDwRun; ++rr) {
    const int t = t0 + run * kDwRun + rr;
    if (t < T) {
      const float s = acc[rr] + bias;
      ab[(size_t)t * inner] = __float2bfloat16(s >= 0.f ? s : a * s);
    }
  }
}

inline cudaError_t dwconv_prelu(const void* u, const void* dw, const void* dw_bias,
                                const void* alpha, void* act, int B, int T, int inner, int k,
                                int pad_l, cudaStream_t s) {
  dwconv_prelu_kernel<<<dim3(inner / kDwCh, (T + kDwRows - 1) / kDwRows, B), kDwThreads, 0, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(dw),
      static_cast<const float*>(dw_bias), static_cast<const float*>(alpha),
      static_cast<__nv_bfloat16*>(act), T, inner, k, pad_l);
  return cudaGetLastError();
}

// The widths the passes and the products take: dim % 64, inner % 64, k <= 33, a grid within
// CUDA's limits, and N tiles the core has.
inline bool widths_ok(int B, int T, int dim, int inner, int k, int pad_l, int bn_in,
                      int bn_out) {
  return dim >= 64 && dim % 64 == 0 && inner >= 64 && inner % 64 == 0 && k >= 1 &&
         k <= kMaxTaps && pad_l >= 0 && pad_l <= k - 1 && B >= 1 && B <= 65535 && T >= 1 &&
         (T + kDwRows - 1) / kDwRows <= 65535 && (bn_in == 128 || bn_in == 256) &&
         (bn_out == 128 || bn_out == 256);
}

}  // namespace
}  // namespace lynx_passes
