// LYNXNet conv module tail for Hopper (sm_90a), hand-written with WMMA (bf16 in, f32 accumulate).
//
// Replaces the TPU kernel of xiaoicesing_io_tpu/ops/pallas/lynx_hybrid.py:lynx_conv_module_hybrid
// (_tail_kernel:32): on the bf16 `inner` activations that the head (LayerNorm -> pw_in -> SwiGLU,
// plain PyTorch) wrote,
//
//     out = bf16(PReLU(dwconv(inner) + dw_bias) @ w2 + b2)      (residual not added)
//
// with f32 taps and zero rows outside each sequence (the head's rows are exact, so no mask).
//
// Bound on an H100: operations. At the main-path shape (B=4, T=2048, dim 1024, inner 2048, k 31)
// the [inner -> dim] product is 34.4 GFLOP (0.035 ms at 989 TFLOP/s) against ~55 MB of traffic
// (0.016 ms); the 1.0 GFLOP f32 conv (0.016 ms on the CUDA cores) can overlap it.
//
// Design: one launch, one block per (16-row tile, sequence). For each 64-column chunk of inner
// the block reads the chunk's 48 window rows (the tile and its conv halo) by index into shared
// memory as f32, runs the depthwise conv, bias and PReLU for the 16 tile rows, and accumulates
// act x w2[chunk rows] at once into the [16, dim] f32 accumulator held in registers; b2 is added
// when the tile is written (lynx_tile.cuh). The halo rows are read three times over (48 rows for
// 16 outputs), from L2. Widths: dim % 64 == 0, dim <= 1024; inner % 64 == 0; k <= 33.

#include "lynx_tile.cuh"

namespace {

using namespace lynx;

constexpr int kLdU = kNC + 4;  // f32 [kWin][kNC]

template <int kFr>
__global__ void __launch_bounds__(kThreads) lynx_conv_tail_kernel(
    const __nv_bfloat16* __restrict__ inner_act,  // [B, T, inner]
    const float* __restrict__ dw,                 // [k, inner]
    const float* __restrict__ dw_bias,            // [inner]
    const float* __restrict__ alpha,              // [inner]
    const __nv_bfloat16* __restrict__ w2,         // [inner, dim]
    const float* __restrict__ b2,                 // [dim]
    __nv_bfloat16* __restrict__ out,              // [B, T, dim]
    int T, int dim, int inner, int k, int pad_l) {
  __shared__ __align__(128) float sU[kWin * kLdU];
  __shared__ __align__(128) __nv_bfloat16 sAct[kTM * kLdAct];

  const int t0 = blockIdx.x * kTM;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t_first = t0 - pad_l;  // sequence row of window row 0
  const __nv_bfloat16* src = inner_act + (size_t)b * T * inner;

  FragAcc acc[kFr];
  zero_acc(acc);
  for (int c0 = 0; c0 < inner; c0 += kNC) {
    for (int v = threadIdx.x; v < kWin * (kNC / 8); v += kThreads) {
      const int r = v / (kNC / 8);
      const int j = (v % (kNC / 8)) * 8;
      const int t = t_first + r;
      float* dst = sU + r * kLdU + j;
      if (t >= 0 && t < T) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)t * inner + c0 + j);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[i] = 0.f;
      }
    }
    __syncthreads();
    conv_prelu_chunk(sU, kLdU, dw, dw_bias, alpha, inner, c0, k, sAct);
    __syncthreads();
    pw_out_chunk<kFr>(acc, sAct, w2, dim, c0, warp);
    __syncthreads();  // sU and sAct are rewritten by the next chunk
  }
  store_rows<kFr>(acc, sU + warp * 256, b2,
                  out + ((size_t)b * T + t0) * dim, min(kTM, T - t0), dim, warp, lane);
}

template <int kFr>
int launch(const void* inner_act, const void* dw, const void* dw_bias, const void* alpha,
           const void* w2, const void* b2, void* out, int B, int T, int dim, int inner, int k,
           int pad_l, cudaStream_t s) {
  const dim3 grid((T + kTM - 1) / kTM, B);
  lynx_conv_tail_kernel<kFr><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(inner_act), static_cast<const float*>(dw),
      static_cast<const float*>(dw_bias), static_cast<const float*>(alpha),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), T, dim, inner, k, pad_l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lynx_conv_tail_launch(const void* inner_act, const void* dw, const void* dw_bias,
                                     const void* alpha, const void* w2, const void* b2, void* out,
                                     int B, int T, int dim, int inner, int k, int pad_l,
                                     void* stream) {
  if (dim % 64 != 0 || dim < 64 || dim > kMaxFr * kWarps * 16 || inner % kNC != 0 ||
      inner < kNC || k < 1 || k - 1 > kWin - kTM || pad_l < 0 || pad_l > k - 1 || B < 1 ||
      B > 65535 || T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((dim / 16 + kWarps - 1) / kWarps) {
    case 1: return launch<1>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    case 2: return launch<2>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    case 3: return launch<3>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    case 4: return launch<4>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    case 5: return launch<5>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    case 6: return launch<6>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    case 7: return launch<7>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
    default: return launch<8>(inner_act, dw, dw_bias, alpha, w2, b2, out, B, T, dim, inner, k, pad_l, s);
  }
}
