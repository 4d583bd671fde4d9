// LYNXNet conv module for Hopper (sm_90a): two products on the TMA + wgmma GEMM core
// (sm90_gemm.cuh) and two memory-bound passes.
//
// Replaces xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:lynx_conv_module (TPU kernel _kernel:33):
//
//     LayerNorm(f32) -> [dim -> inner] out and gate products -> SwiGLU -> zero rows outside the
//     sequence -> depthwise conv over time (k taps, f32) + bias -> PReLU -> [inner -> dim] product + bias
//
// Bound on an H100: compute. At the main-path shape (rows = B*T = 8192, dim 1024, inner 2048)
// the three products are 103 GFLOP against ~46 MB of compulsory traffic, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores are the limit: 0.104 ms at 989 TFLOP/s. The 1 GFLOP
// f32 depthwise conv (0.016 ms on the CUDA cores) can overlap the products and does not add.
//
// Design. Four passes in one stream; ~285 MB of traffic in all at the main shape (~0.09 ms):
//   1. LayerNorm, one warp a row, f32 two-pass, written as bf16 xn [rows, dim] (the TPU kernel
//      rounds the normalised rows to bf16 before its first product too).
//   2. xn @ w_in on the GEMM core. The wrapper pairs w_in's out column j and gate column inner + j
//      in one N tile (P out and P gate columns, P = 128 where inner % 128 == 0, else 64), so the
//      epilogue adds b_in and applies SwiGLU in registers and writes u in f32 [rows, inner]: the
//      TPU kernel keeps u in f32 up to the depthwise conv.
//   3. Depthwise conv (k <= 33) + bias + PReLU over f32 u, rows outside [0, T) read as zero (this
//      replaces the row mask); written as bf16 act. A block stages 64 rows + the halo of 64
//      channels; a thread owns one channel and 32 rows and keeps the taps (zero past k) and its 32
//      sums in registers, so each staged value is read once per thread instead of once per tap.
//   4. act @ w2 + b2 on the GEMM core, written as bf16.
// Neither the conv nor the LayerNorm is fused into a product's producer: the card has not shown
// that it pays (the two memory-bound passes move ~170 MB, ~0.05 ms at the HBM rate).
// Widths: dim % 64 == 0, inner % 64 == 0, k <= 33.

#include "sm90_gemm.cuh"

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

__global__ void __launch_bounds__(32 * kLnWarps) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ xn, int rows, int dim) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * dim);
  const int pairs = dim / 2;
  float s = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / dim;
  float q = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / dim + 1e-5f);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(xn + (size_t)row * dim);
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    const float2 sc = *reinterpret_cast<const float2*>(scale + 2 * i);
    const float2 bi = *reinterpret_cast<const float2*>(bias + 2 * i);
    out[i] = __floats2bfloat162_rn((v.x - mean) * rstd * sc.x + bi.x,
                                   (v.y - mean) * rstd * sc.y + bi.y);
  }
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

}  // namespace

// map_xn: xn [1, B*T, dim] (box rows 128); map_w_in: w_in K-major and column-paired [2 inner, dim]
// (box rows bn_in: pairs of bn_in / 2 columns); map_act: act [1, B*T, inner] (box rows 128);
// map_w2: w2^T [dim, inner] (box rows bn_out). xn, u (f32) and act are the wrapper's scratch.
extern "C" int lynx_conv_module_launch(
    const void* map_xn, const void* map_w_in, const void* map_act, const void* map_w2,
    const void* x, const void* ln_scale, const void* ln_bias, const void* b_in, const void* dw,
    const void* dw_bias, const void* alpha, const void* b2, void* xn, void* u, void* act, void* out,
    int B, int T, int dim, int inner, int k, int pad_l, int bn_in, int bn_out, void* stream) {
  if (dim < 64 || dim % 64 != 0 || inner < 64 || inner % 64 != 0 || k < 1 || k > kMaxTaps ||
      pad_l < 0 || pad_l > k - 1 || B < 1 || B > 65535 || T < 1 ||
      (T + kDwRows - 1) / kDwRows > 65535 || (bn_in != 128 && bn_in != 256) ||
      (bn_out != 128 && bn_out != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * T;
  layer_norm_kernel<<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<__nv_bfloat16*>(xn), rows, dim);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const SwigluEpi swiglu{static_cast<const float*>(b_in), static_cast<float*>(u), inner};
  const sm90::Args head{rows, 2 * inner, dim, 1, {0}};
  e = bn_in == 256 ? sm90::launch<256, true>(map_xn, map_w_in, head, 1, swiglu, s)
                   : sm90::launch<128, true>(map_xn, map_w_in, head, 1, swiglu, s);
  if (e != cudaSuccess) return (int)e;

  dwconv_prelu_kernel<<<dim3(inner / kDwCh, (T + kDwRows - 1) / kDwRows, B), kDwThreads, 0, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(dw),
      static_cast<const float*>(dw_bias), static_cast<const float*>(alpha),
      static_cast<__nv_bfloat16*>(act), T, inner, k, pad_l);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const sm90::StoreBiasBf16 store{static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out),
                                  rows, dim};
  const sm90::Args tail{rows, dim, inner, 1, {0}};
  e = bn_out == 256 ? sm90::launch<256, false>(map_act, map_w2, tail, 1, store, s)
                    : sm90::launch<128, false>(map_act, map_w2, tail, 1, store, s);
  return (int)e;
}
